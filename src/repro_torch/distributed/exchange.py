"""Pluggable spike-parcel transport for the SPMD FAP round.  Counterpart
of ``repro.distributed.exchange``.

The paper's asynchronous execution model has two point-to-point channels:
stepping notifications (neuron clocks) and spike parcels.  The
``transport=`` knob picks their realisation:

``allgather`` (reference)
    Both channels as dense all-gathers of full N-length vectors: bytes
    scale with N whatever the firing rate.

``sparse``
    * spike parcels: each rank packs its (spiked, t_spike) into a
      destination-routed buffer [n_shards, parcel_cap] of (global id,
      time) entries with the row compaction kernel K9
      (``kernels.event_wheel.ops.spike_compact``) and exchanges the rows
      with one all-to-all: ``n_shards * parcel_cap * (4 + 8)`` bytes a
      round, set by the cap and not by N.  Entries past the cap are
      counted in ``dropped``, never lost silently.
    * clock notifications: an all-gather over each shard's boundary set
      (its neurons with cross-shard out-edges, ``sharding.shard_frontier``)
      scattered into an N-length clock table.  On uniform random wiring
      the boundary is nearly every neuron; on a placed structured net
      (``distributed.placement``) it shrinks with the locality.

``sparse_ragged``
    Counts first (a max over the ranks of the fullest (source,
    destination) pair, channel ``exchange_counts``), then the parcel
    all-to-all at the smallest class of ``ExchangeSpec.class_ladder()``
    that fits.  The class is read on the host, so the exchange is simply
    a sized all-to-all (JAX's ``lax.switch`` over static branches); quiet
    rounds ship the smallest class and no round ships more than
    ``parcel_cap``.

Every collective goes through ``group.Group``, which counts its bytes and
host wall time under the channel tag.  JAX's ``mode="drop"`` scatters park
sentinel ids out of range; here the sentinel entries go to a dump slot
past the end of the table, which is sliced off.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

NOTIFY_TAG = "exchange_notify"
PARCEL_TAG = "exchange_parcel"
COUNTS_TAG = "exchange_counts"
TRANSPORTS = ("allgather", "sparse", "sparse_ragged")


def class_tag(cap: int) -> str:
    """Counter tag of one ragged class's parcel exchange."""
    return f"{PARCEL_TAG}_c{cap}"


class ExchangeSpec(NamedTuple):
    """Static sparse-transport geometry (the ``WheelSpec`` of the
    communication layer).  JAX's ``compact_impl`` knob has no counterpart:
    ``spike_compact`` runs K9 on a card and its plain version on the CPU."""
    parcel_cap: int = 64          # parcel slots per (source, dest) shard pair
    classes: tuple = ()           # ragged class caps (ascending);
    #                               () -> (cap//8, cap//2, cap) deduped

    def class_ladder(self) -> tuple:
        """The ascending class ladder, always ending at ``parcel_cap``."""
        cap = int(self.parcel_cap)
        base = self.classes or (max(1, cap // 8), max(1, cap // 2))
        return tuple(sorted({int(c) for c in base if 0 < int(c) < cap})) \
            + (cap,)


class Transport(NamedTuple):
    """One realisation of the two channels on one rank.

    notify(t_local) -> (f64[N] global clock table, the gathered boundary
        clock vector for the sparse family (the incremental horizon's
        moved-set source), None for allgather);
    exchange(spiked_l, t_sp_l) -> (spiked bool[N], t_spike f64[N], this
        rank's parcel drops i64[], parcel bytes shipped this round, this
        rank's largest (source, destination) parcel count i64[] -- 0 for
        allgather, which ships no parcels);
    tables: the rank's routing tables (``b_gid`` [n_shards * F] for the
        sparse family, else empty).
    """
    name: str
    notify: Callable
    exchange: Callable
    tables: dict


def allgather_transport(group, n: int) -> Transport:
    """The reference transport: both channels as dense N-length gathers."""
    zero = torch.zeros((), dtype=torch.int64, device=group.device)

    def notify(t_local):
        return group.all_gather(t_local, NOTIFY_TAG), None

    def exchange(spiked, t_sp):
        spiked_all = group.all_gather(spiked, PARCEL_TAG)
        tsp_all = group.all_gather(t_sp, PARCEL_TAG)
        return spiked_all, tsp_all, zero, n * (1 + 8), zero

    return Transport("allgather", notify, exchange, {})


def _scatter_dump(n: int, gid, vals, fill):
    """An [n] table with ``vals`` at ``gid`` and ``fill`` elsewhere;
    sentinel ids (>= n) land in a dump slot that is sliced off."""
    out = torch.full((n + 1,), fill, dtype=vals.dtype, device=vals.device)
    out[torch.clamp(gid, max=n).long()] = vals
    return out[:n]


def sparse_transport(group, n: int, net, spec: ExchangeSpec,
                     ragged: bool = False) -> Transport:
    """Activity-scaled transport: boundary-set notify and capped
    destination-routed parcel all-to-all (``ragged``: sized per round by
    a counts phase).  Routing tables come from the concrete edge list."""
    from repro_torch.distributed.sharding import shard_frontier
    from repro_torch.kernels.event_wheel import ops as ew_ops

    dev, S, rank = group.device, group.world, group.rank
    n_local = n // S
    offset = rank * n_local
    cap = int(spec.parcel_cap)
    classes = spec.class_ladder() if ragged else (cap,)
    fr = shard_frontier(np.asarray(net.pre), np.asarray(net.post), n, S)
    b_rel = torch.as_tensor(np.clip(fr.boundary_rel[rank], 0, n_local - 1),
                            dtype=torch.int64, device=dev)      # [F]
    b_gid = torch.as_tensor(fr.boundary_gid.reshape(-1), dtype=torch.int64,
                            device=dev)                         # [S * F]
    dest_l = torch.as_tensor(fr.dest_map[offset:offset + n_local],
                             device=dev)                        # [n_local, S]

    def notify(t_local):
        allv = group.all_gather(t_local[b_rel], NOTIFY_TAG)     # [S * F]
        table = _scatter_dump(n, b_gid, allv, float("inf"))
        table[offset:offset + n_local] = t_local
        return table, allv

    def ship(gid, ts, c_cap):
        """One sized parcel exchange: the first ``c_cap`` slots of every
        (source, destination) row, padded back to the static cap."""
        tag = class_tag(c_cap) if ragged else PARCEL_TAG
        gid_r = group.all_to_all(gid[:, :c_cap], tag)
        ts_r = group.all_to_all(ts[:, :c_cap], tag)
        return gid_r, ts_r, S * c_cap * (4 + 8)

    def exchange(spiked, t_sp):
        # row d: this rank's spikes with a synapse into shard d
        mask = (dest_l & spiked[:, None]).T                     # [S, n_local]
        vals = t_sp[None, :].expand(S, n_local)
        idx, ts, cnt = ew_ops.spike_compact(mask, vals, cap)
        gid = torch.where(idx < n_local, idx + offset, n).to(torch.int32)
        c_cap = classes[-1]
        if len(classes) > 1:
            # counts phase: the fullest (source, destination) pair of all
            # ranks picks the smallest class that holds it
            worst = int(group.all_reduce(cnt.amax().to(torch.int32), "max",
                                         COUNTS_TAG))
            c_cap = next(c for c in classes if worst <= c or c == cap)
        gid_r, ts_r, pbytes = ship(gid, ts, c_cap)
        gid_r = gid_r.reshape(-1)
        spiked_all = _scatter_dump(n, gid_r, torch.ones_like(gid_r,
                                                             dtype=torch.bool),
                                   False)
        tsp_all = _scatter_dump(n, gid_r, ts_r.reshape(-1), 0.0)
        drops = torch.clamp(cnt - cap, min=0).sum()
        return spiked_all, tsp_all, drops, pbytes, cnt.amax().to(torch.int64)

    return Transport("sparse_ragged" if ragged else "sparse", notify,
                     exchange, {"b_gid": b_gid})


def get_transport(name: str, group, *, n: int, net=None,
                  spec: ExchangeSpec = ExchangeSpec()) -> Transport:
    """Transport dispatch -- the ``transport=`` knob."""
    if name == "allgather":
        return allgather_transport(group, n)
    if name in ("sparse", "sparse_ragged"):
        if net is None:
            raise ValueError(f"transport={name!r} derives its routing tables "
                             "from the concrete edge list: pass net=")
        return sparse_transport(group, n, net, spec,
                                ragged=name == "sparse_ragged")
    raise ValueError(f"unknown transport {name!r} (want one of {TRANSPORTS})")
