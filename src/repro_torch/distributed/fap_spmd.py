"""SPMD realisation of the FAP variable-timestep scheduler round (the
paper's method 2c over shards).  Counterpart of
``repro.distributed.fap_spmd``.

Neurons, their BDF states, event queues and in-edges are block-sharded
over the ranks of a ``group.Group`` (rank r holds global ids [r * N/S,
(r + 1) * N/S) and their by-post in-edges).  Every rank calls
``run_fap_spmd`` with the same arguments; each round advances the rank's
runnable neurons to their dependency horizons, in five stages:

  notify   -- clocks to the other ranks (``exchange.Transport.notify``);
  horizon  -- ``exec_common.horizon_times`` over the local in-edges with
              the shard-relative post index and the notify clock table
              (``horizon="incremental"``: only rows fed by a moved clock);
  advance  -- ``exec_bsp.make_vardt_advance(step_budget=8)``, on all local
              lanes or on the compacted frontier (``batch="compact"``, K6);
  parcels  -- (spiked, t_spike) to the ranks that hold their targets
              (``Transport.exchange``; the sparse family packs them with
              K9);
  insert   -- into the local queues, dense (grouped) or compact (K7).

The only communication of this shard-local round (JAX's
``optimized=True``) is the transport's two channels, one sum of the
round's counters and the host loop's global clock minimum.  Where JAX
branches inside the round (``lax.cond`` on the incremental moved-set
overflow and on the compact fan-out's spike count, ``lax.switch`` on the
ragged class), the port reads the deciding count on the host once per
round.  Overflow of queues and parcels stays detected, never silent:
``dropped`` counts both.

``run_fap_spmd`` drives the round under the shared preemption harness
(``exec_common.run_checkpointed``): round-boundary checkpoints of the
whole network's state, gathered in placed order and written by rank 0
(collectives tagged ``checkpoint``), resume on the same or another number
of ranks, fault injection and the watchdog.

``optimized=False`` (the default of ``build_fap_round``, as in JAX) is the
paper-faithful global round, the baseline the shard-local one is held
against.  JAX writes it as global array code and GSPMD inserts the
collectives; here each rank gathers what that code reads of the other
shards, on channels of its own: the whole network's clocks
(``global_clocks``), from which it computes the horizon over all E edges
and keeps its rows; after its advance, every rank's spikes and spike times
(``global_spikes``), from which it runs the generic queue insert
(``QueueOps.insert``) over all E edges with the runtime ``post`` array,
events bound for other shards masked out.  Under ``queue="dense"`` that
insert's stable sort of the E targets stands in for XLA's distributed
sort; under ``queue="wheel"`` K8 ranks all E events pairwise, O(E^2), so
the global wheel round is for small networks.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import sched
from repro_torch.core import bdf
from repro_torch.core import events as ev
from repro_torch.core import exec_common as xc
from repro_torch.core.cell import CellModel
from repro_torch.core.exec_bsp import RunResult, make_vardt_advance
from repro_torch.distributed import placement as plc
from repro_torch.distributed.exchange import ExchangeSpec, get_transport

OTHER_TAG = "other"      # telemetry, the loop's cond and the final gathers
CKPT_TAG = "checkpoint"  # the gathers of a checkpoint save
CLOCKS_TAG = "global_clocks"    # the global round's clock gather
SPIKES_TAG = "global_spikes"    # ... and its spike gathers


class PaperNeuroSpec(NamedTuple):
    n_neurons: int = 1 << 20
    k_in: int = 16
    n_comp: int = 29                  # branched_tree(depth=3)
    ev_cap: int = 32
    t_end: float = 1000.0
    horizon_cap: float = 2.0


def shard_rows(x, group):
    """This rank's block of rows of a per-neuron or per-edge array."""
    m = x.shape[0] // group.world
    return x[group.rank * m:(group.rank + 1) * m]


def build_fap_round(model: CellModel, spec: PaperNeuroSpec, group,
                    opts: bdf.BDFOptions = bdf.BDFOptions(),
                    optimized: bool = False, queue: str = "dense",
                    wheel: sched.WheelSpec = sched.WheelSpec(),
                    transport: str = "allgather",
                    exchange: ExchangeSpec = ExchangeSpec(), net=None,
                    batch: str = "dense", batch_cap: int = 0,
                    fanout: str = "dense", spike_cap: int = 0,
                    horizon: str = "full", move_cap: int = 0):
    """This rank's round.

    ``optimized=False`` (default): the paper-faithful global round (module
    docstring).  Returns ``fap_round(sts, eq_t, eq_a, eq_g, pre, post,
    delay, w_a, w_g, iinj_l)``: the rank's rows of the state, queue and
    current, and the whole network's edge arrays (JAX's global arrays);
    it takes only the allgather transport and the dense batch and
    fan-out, as JAX's does.

    ``optimized=True``: the shard-local round.  Returns ``fap_round(sts,
    eq_t, eq_a, eq_g, pre_l, delay_l, wa_l, wg_l, iinj_l, *carry)`` over
    the rank's neurons and in-edges (``shard_rows`` of the global arrays;
    ``pre_l`` holds global ids).  The transport's routing tables and the
    static out-edge tables are bound in the closure (JAX passes them as
    sharded arguments).  The knobs are JAX's: ``queue``, ``transport``
    (with ``exchange``), ``batch="compact"`` with ``batch_cap`` (<= 0: the
    shard width), ``fanout="compact"`` with ``spike_cap`` (<= 0: min(N,
    256); more spikes in a round take the dense insert),
    ``horizon="incremental"`` with ``move_cap`` (needs the compact batch
    and a sparse transport).

    Both return (sts, eq_t, eq_a, eq_g, spiked, t_spike, n_deliv,
    n_resets, dropped, parcel_bytes, parcel_peak[, horizon, prev_bnd,
    moved_ids]): ``spiked``/``t_spike`` are the rank's own lanes; the
    counts are sums over all ranks; ``parcel_peak`` (not in JAX's round)
    is this rank's largest (source, destination) parcel count of the
    round (0, like the parcel bytes, in the global round).
    """
    # JAX's knob checks, in its order and words
    if transport != "allgather" and not optimized:
        raise ValueError("sparse transport realises the shard-local "
                         "(optimized=True) round; the global path has no "
                         "explicit channels to replace")
    if batch not in ("dense", "compact"):
        raise ValueError(f"unknown batch mode {batch!r}")
    if batch == "compact" and not optimized:
        raise ValueError("active-set compaction is shard-local "
                         "(optimized=True); the global path has no "
                         "shard-local advance stage to compact")
    if fanout not in ("dense", "compact"):
        raise ValueError(f"unknown fanout mode {fanout!r}")
    if fanout == "compact" and (not optimized or net is None):
        raise ValueError("compact fan-out is shard-local (optimized=True) "
                         "and derives its out-edge table from the concrete "
                         "edge list: pass net=")
    if horizon not in ("full", "incremental"):
        raise ValueError(f"unknown horizon mode {horizon!r}")
    incremental = horizon == "incremental"
    if incremental and (not optimized or batch != "compact"
                        or not transport.startswith("sparse")
                        or net is None):
        raise ValueError("incremental horizon maintenance needs the "
                         "shard-local round (optimized=True), the compact "
                         "batch's moved set (batch='compact') and the "
                         "sparse transport's frontier tables "
                         "(transport='sparse'|'sparse_ragged', net=)")
    if not optimized:
        return _build_global_round(model, spec, group, opts, queue, wheel)
    from repro_torch.kernels.event_wheel import ops as ew_ops

    dev, S, rank = group.device, group.world, group.rank
    n, k = spec.n_neurons, spec.k_in
    E = n * k
    n_local, e_local = n // S, E // S
    offset = rank * n_local
    advance = make_vardt_advance(model, opts, eg_window=0.0, step_budget=8)
    cap = n_local if batch_cap <= 0 else min(int(batch_cap), n_local)
    s_cap = min(int(spike_cap), n) if spike_cap > 0 else min(n, 256)
    qops = sched.get_queue_ops(queue, ev_cap=spec.ev_cap, wheel=wheel)
    tp = get_transport(transport, group, n=n, net=net, spec=exchange)
    post_rel = torch.arange(n_local, device=dev).repeat_interleave(k)
    if fanout == "compact" or incremental:
        post_np, edge_np = xc.out_tables(net)
    if fanout == "compact":
        edge_tbl = torch.as_tensor(edge_np, dtype=torch.int32,
                                   device=dev).contiguous()       # sent. E
    if incremental:
        post_tbl = torch.as_tensor(post_np, dtype=torch.int64, device=dev)
        b_gid = tp.tables["b_gid"]                             # [S * F]
        sf = b_gid.shape[0]
        mcap = min(sf, S * cap) if move_cap <= 0 else min(int(move_cap), sf)

    def insert_dense(eq, pre_l, delay_l, wa_l, wg_l, spiked_all, tsp_all):
        valid = spiked_all[pre_l]
        t_ev = tsp_all[pre_l] + delay_l
        return qops.insert_grouped(eq, t_ev.reshape(-1, k),
                                   wa_l.reshape(-1, k), wg_l.reshape(-1, k),
                                   valid.reshape(-1, k))

    def insert_compact(eq, delay_l, wa_l, wg_l, spiked_all, tsp_all):
        """Only the spiking set's out-edges that land in this rank's
        contiguous edge slice (K7 emits the edge ids)."""
        ids_s, eids, _ = ew_ops.compact_gather(spiked_all, edge_tbl, s_cap,
                                               fill=E)
        idc = torch.clamp(ids_s, max=n - 1).long()
        le = eids.long() - rank * e_local
        ok = (ids_s < n)[:, None] & (eids < E) & (le >= 0) & (le < e_local)
        lec = torch.clamp(le, 0, e_local - 1)
        tgt = lec // k                            # shard-relative post
        t_ev = tsp_all[idc][:, None] + delay_l[lec]
        return qops.insert_batch(eq, tgt.reshape(-1), t_ev.reshape(-1),
                                 wa_l[lec].reshape(-1), wg_l[lec].reshape(-1),
                                 ok.reshape(-1))

    def fap_round(sts, eq_t, eq_a, eq_g, pre_l, delay_l, wa_l, wg_l, iinj_l,
                  *carry):
        t_local = sts.t
        # --- notify: the stepping notifications ---------------------------
        t_table, bnd_new = tp.notify(t_local)
        dloc = xc.DeviceNet(pre_l, post_rel, delay_l, wa_l, wg_l)

        def full_horizon():
            return xc.horizon_times(dloc, n_local, t_local, spec.t_end,
                                    t_table=t_table,
                                    horizon_cap=spec.horizon_cap)

        if incremental:
            hor_c, prev_bnd, moved_prev = carry
            # moved set: frontier clocks that changed since last round (pad
            # slots carry the gid sentinel n) and last round's advanced lanes
            moved_b = (bnd_new != prev_bnd) & (b_gid < n)
            mids, mcnt = ew_ops.compact_ids(moved_b, mcap)
            if int(mcnt) <= mcap:
                gids = torch.where(mids < sf,
                                   b_gid[torch.clamp(mids, max=sf - 1).long()],
                                   n)
                own = torch.where(moved_prev < n_local,
                                  moved_prev.long() + offset, n)
                srcs = torch.cat([gids, own])
                posts = torch.where((srcs < n)[:, None],
                                    post_tbl[torch.clamp(srcs, max=n - 1)], n)
                p_loc = posts - offset
                p_loc = torch.where((p_loc >= 0) & (p_loc < n_local), p_loc,
                                    n_local)
                p = torch.cat([moved_prev.long(), p_loc.reshape(-1)])
                pc = torch.clamp(p, max=n_local - 1)
                pre_k, dly_k = pre_l.reshape(n_local, k), \
                    delay_l.reshape(n_local, k)
                cand = t_table[pre_k[pc]] + dly_k[pc]             # [|p|, K]
                rows = torch.clamp(cand.amin(dim=1), max=spec.t_end)
                rows = torch.minimum(rows, t_local[pc] + spec.horizon_cap)
                # rows past the shard go to a dump slot; a row listed twice
                # gets the same value from each writer (min is exact)
                hor = torch.cat([hor_c, hor_c.new_zeros(1)])
                hor[p] = rows
                horizon = hor[:n_local]
            else:
                horizon = full_horizon()
            prev_bnd = bnd_new
        else:
            horizon = full_horizon()
        runnable = xc.runnable_mask(t_local, horizon)
        # --- advance -------------------------------------------------------
        if batch == "compact":
            ids, _ = xc.compact_frontier(runnable, t_local, cap)
            lane_ok = ids < n_local
            idc = torch.clamp(ids, max=n_local - 1).long()
            sts_b = bdf.gather_lanes(sts, idc)
            t_b_prev = sts_b.t
            sts_b, eqt_b, spiked_b, tsp_b, nd, nrs = advance(
                sts_b, eq_t[idc], eq_a[idc], eq_g[idc], horizon[idc],
                lane_ok, iinj_l[idc])
            sts = xc.scatter_lanes(sts, sts_b, ids)
            eq_t = xc.scatter_at(eq_t, ids, eqt_b)
            spiked = xc.scatter_at(torch.zeros((n_local,), dtype=torch.bool,
                                               device=dev), ids, spiked_b)
            t_sp = xc.scatter_at(torch.zeros((n_local,), dtype=torch.float64,
                                             device=dev), ids, tsp_b)
            if incremental:
                moved = lane_ok & (sts_b.t != t_b_prev)
                moved_prev = torch.where(moved, ids, n_local).to(torch.int32)
        else:
            sts, eq_t, spiked, t_sp, nd, nrs = advance(
                sts, eq_t, eq_a, eq_g, horizon, runnable, iinj_l)
        # --- parcel exchange ----------------------------------------------
        spiked_all, tsp_all, pdrop, pbytes, ppeak = tp.exchange(spiked, t_sp)
        # --- insert: a spike-free round inserts nothing -------------------
        eq = qops.wrap(eq_t, eq_a, eq_g,
                       torch.zeros((), dtype=torch.int32, device=dev))
        n_spikes = int(spiked_all.sum())
        if n_spikes and fanout == "compact" and n_spikes <= s_cap:
            eq = insert_compact(eq, delay_l, wa_l, wg_l, spiked_all, tsp_all)
        elif n_spikes:
            eq = insert_dense(eq, pre_l, delay_l, wa_l, wg_l, spiked_all,
                              tsp_all)
        tele = torch.stack([nd.sum(), nrs.sum(),
                            eq.dropped.to(torch.int64) + pdrop]).to(torch.int64)
        nd, nrs, dropped = group.all_reduce(tele, "sum", OTHER_TAG)
        out = (sts, eq.t, eq.w_ampa, eq.w_gaba, spiked, t_sp, nd, nrs,
               dropped, pbytes, ppeak)
        if incremental:
            out += (horizon, prev_bnd, moved_prev)
        return out

    fap_round.incremental = incremental
    if incremental:
        fap_round.carry_shapes = ((sf,), (cap,))    # prev_bnd, moved ids
    return fap_round


def _build_global_round(model, spec, group, opts, queue, wheel):
    """The global round of ``build_fap_round(optimized=False)``."""
    dev, rank = group.device, group.rank
    n = spec.n_neurons
    n_local = n // group.world
    offset = rank * n_local
    advance = make_vardt_advance(model, opts, eg_window=0.0, step_budget=8)
    qops = sched.get_queue_ops(queue, ev_cap=spec.ev_cap, wheel=wheel)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    def fap_round(sts, eq_t, eq_a, eq_g, pre, post, delay, w_a, w_g,
                  iinj_l):
        # --- the horizon over all E edges from the whole network's clocks
        t_all = group.all_gather(sts.t, CLOCKS_TAG)
        dnet = xc.DeviceNet(pre, post, delay, w_a, w_g)
        horizon = xc.horizon_times(dnet, n, t_all, spec.t_end,
                                   horizon_cap=spec.horizon_cap)
        horizon = horizon[offset:offset + n_local]
        runnable = xc.runnable_mask(sts.t, horizon)
        sts, eq_t, spiked, t_sp, nd, nrs = advance(
            sts, eq_t, eq_a, eq_g, horizon, runnable, iinj_l)
        # --- the generic insert over all E edges, this rank's targets -----
        spiked_all = group.all_gather(spiked, SPIKES_TAG)
        tsp_all = group.all_gather(t_sp, SPIKES_TAG)
        eq = qops.wrap(eq_t, eq_a, eq_g,
                       torch.zeros((), dtype=torch.int32, device=dev))
        if bool(spiked_all.any()):
            # a spike-free round inserts nothing: skipping is identical
            tgt = post - offset
            valid = spiked_all[pre] & (tgt >= 0) & (tgt < n_local)
            t_ev = tsp_all[pre] + delay
            eq = qops.insert(eq, tgt, t_ev, w_a, w_g, valid)
        tele = torch.stack([nd.sum(), nrs.sum(),
                            eq.dropped.to(torch.int64)]).to(torch.int64)
        nd, nrs, dropped = group.all_reduce(tele, "sum", OTHER_TAG)
        return (sts, eq.t, eq.w_ampa, eq.w_gaba, spiked, t_sp, nd, nrs,
                dropped, 0, zero)

    fap_round.incremental = False
    return fap_round


def run_fap_spmd(model: CellModel, net, iinj, t_end: float, group,
                 opts: bdf.BDFOptions = bdf.BDFOptions(),
                 optimized: bool = True, queue: str = "dense",
                 wheel: sched.WheelSpec = sched.WheelSpec(),
                 transport: str = "allgather",
                 exchange: ExchangeSpec = ExchangeSpec(),
                 ev_cap: int = 32, horizon_cap: float = 2.0,
                 max_rounds: int = 400, spk_cap: int = 128,
                 placement=None, batch: str = "dense", batch_cap: int = 0,
                 fanout: str = "dense", spike_cap: int = 0,
                 horizon: str = "full", move_cap: int = 0,
                 checkpoint_every: int = 0, ckpt_dir=None,
                 resume: bool = False, fault=None, watchdog: bool = True,
                 max_rollbacks: int = 2, ckpt_keep: int = 3):
    """Drive the SPMD round to ``t_end``; every rank of ``group`` calls it
    with the same arguments and gets the whole network's ``RunResult``, in
    the caller's neuron order, and the round count.

    ``optimized`` (default True, as in JAX's ``run_fap_spmd``) picks the
    shard-local round; False the global round (``build_fap_round``).
    Each rank records its own neurons' spikes; the records, final states
    and solver counters are gathered once at the end.  ``dropped`` counts
    queue and parcel overflow.  ``placement``: a ``placement.Placement``
    or a method name -- the relabeling is applied before sharding and
    inverted on the result.  ``RunResult.comm`` holds the realised parcel
    bytes, the rounds, the largest (source, destination) parcel count of
    each round over all ranks (``parcel_peak``; zeros for allgather) and
    this rank's per-channel counters (bytes, host seconds, calls) of the
    run.

    Preemption tolerance (``exec_common.run_checkpointed``):
    ``checkpoint_every=k`` snapshots the whole network's round state every
    k rounds into ``ckpt_dir`` (rank 0 writes the carry gathered in placed
    order; the ``ckpt_keep`` newest are kept); ``resume=True`` restarts
    from the latest one, each rank taking its own rows, bitwise the
    uninterrupted run.  A resume on another number of ranks reseeds the
    incremental horizon's carry, whose layout depends on it (the
    fingerprint: ranks, transport, batch cap, horizon mode), and sets
    ``health["elastic_reseeded"]``; a resume under another placement is
    refused.  ``fault`` (``checkpoint.FaultPlan``) kills, or poisons a lane
    (a placed id), at a round boundary; the watchdog (on by default)
    checks every round, summed over the ranks, and rolls a non-finite
    state back to the last checkpoint (round 0 if none), at most
    ``max_rollbacks`` times; then ``health["rollback_exhausted"]`` and
    ``failed`` are set.
    """
    dev = model.runner_device(group.device)
    S, rank = group.world, group.rank
    pl = None
    if placement is not None:
        pl = placement if isinstance(placement, plc.Placement) else \
            plc.compute_placement(net, S, method=placement)
        net, iinj = plc.place_inputs(net, iinj, pl)
    n = int(net.n)
    k = sched.grouped_k(net)
    if k is None:
        raise ValueError("run_fap_spmd needs make_network's grouped by-post "
                         "edge layout")
    if n % S:
        raise ValueError(f"n={n} not divisible by the {S} ranks")
    n_local = n // S
    spec = PaperNeuroSpec(n_neurons=n, k_in=k, ev_cap=ev_cap, t_end=t_end,
                          horizon_cap=horizon_cap)
    group.reset_counters()
    fn = build_fap_round(model, spec, group, opts, optimized=optimized,
                         queue=queue, wheel=wheel, transport=transport,
                         exchange=exchange, net=net, batch=batch,
                         batch_cap=batch_cap, fanout=fanout,
                         spike_cap=spike_cap, horizon=horizon,
                         move_cap=move_cap)
    qops = sched.get_queue_ops(queue, ev_cap=ev_cap, wheel=wheel)
    dnet = xc.to_device(net, dev)
    static = tuple(shard_rows(x, group) for x in
                   (dnet.pre, dnet.delay, dnet.w_ampa, dnet.w_gaba)) + \
        (shard_rows(xc.per_neuron(iinj, n, dev), group),)
    if not optimized:
        # the global round reads the whole network's edge arrays
        static = tuple(dnet) + static[-1:]
    neuron_ids = torch.arange(n_local, dtype=torch.int64, device=dev)

    def seed_hcarry(t_local, table=None):
        """(horizon, previous boundary clocks, moved ids) from the clocks:
        the full horizon over ``table``, the whole network's clocks (all
        zero at round 0), all-zero previous clocks (every frontier entry
        looks moved next round: a recompute, exact) and sentinel moved
        ids.  Round 0 and a resume on another layout share it."""
        b_shape, m_shape = fn.carry_shapes
        dloc = xc.DeviceNet(static[0], torch.arange(n_local, device=dev)
                            .repeat_interleave(k), static[1], static[2],
                            static[3])
        if table is None:
            table = torch.zeros((n,), dtype=torch.float64, device=dev)
        hor0 = xc.horizon_times(dloc, n_local, t_local, t_end,
                                t_table=table, horizon_cap=horizon_cap)
        return (hor0, torch.zeros(b_shape, dtype=torch.float64, device=dev),
                torch.full(m_shape, n_local, dtype=torch.int32, device=dev))

    def init_fn():
        Y = xc.batch_init(model, n_local)
        sts = bdf.reinit(model, 0.0, Y, static[-1], opts)
        eq = qops.make(n_local, dev)
        z = torch.zeros((), dtype=torch.int64, device=dev)
        return xc.SimCarry(sts, (eq.t, eq.w_ampa, eq.w_gaba),
                           ev.make_spike_record(n_local, spk_cap, dev),
                           seed_hcarry(sts.t) if fn.incremental else (),
                           {"n_ev": z, "n_rs": z, "dropped": z,
                            "parcel_bytes": 0,
                            "parcel_peak": torch.zeros(
                                (max_rounds,), dtype=torch.int64, device=dev),
                            "rounds": 0})

    def step_fn(sc):
        out = fn(sc.sts, *sc.eq, *static, *sc.hcarry)
        sts, eq_t, eq_a, eq_g, spiked, t_sp, nd, nrs, dropped, pbytes, \
            ppeak = out[:11]
        rec = ev.record_spikes(sc.rec, neuron_ids, t_sp, spiked)
        c = sc.counters
        peak = c["parcel_peak"].clone()
        peak[c["rounds"]] = ppeak
        return xc.SimCarry(sts, (eq_t, eq_a, eq_g), rec, out[11:], {
            "n_ev": c["n_ev"] + nd, "n_rs": c["n_rs"] + nrs,
            "dropped": c["dropped"] + dropped,
            "parcel_bytes": c["parcel_bytes"] + pbytes,
            "parcel_peak": peak, "rounds": c["rounds"] + 1})

    def cond_fn(sc):
        if sc.counters["rounds"] >= max_rounds:
            return False
        t_min, ok = group.all_reduce(
            torch.stack([sc.sts.t.amin(),
                         (~sc.sts.failed.any()).to(torch.float64)]),
            "min", OTHER_TAG).tolist()
        return t_min < t_end - 1e-9 and ok == 1.0

    def health_of(sc, t_prev):
        chk = xc.health_check(sc.sts, t_prev,
                              horizon=sc.hcarry[0] if fn.incremental
                              else None, horizon_cap=horizon_cap)
        keys = sorted(chk)
        tot = group.all_reduce(torch.stack([chk[q] for q in keys])
                               .to(torch.int64), "sum", OTHER_TAG).tolist()
        return dict(zip(keys, tot))

    # --- checkpoints of the whole network, in placed order ---------------
    # per-lane leaves are gathered in rank order; the counters are the same
    # on every rank, but for the record's overflow (summed, restored to
    # rank 0) and the parcel peaks (the max over the ranks, restored to all)
    def global_carry(sc):
        gather = lambda x: group.all_gather(x, CKPT_TAG)  # noqa: E731
        c, rec = sc.counters, sc.rec
        return xc.SimCarry(
            type(sc.sts)(*[gather(x) for x in sc.sts]),
            tuple(gather(x) for x in sc.eq),
            ev.SpikeRecord(gather(rec.times), gather(rec.count),
                           group.all_reduce(rec.overflow, "sum", CKPT_TAG)),
            tuple(gather(x) for x in sc.hcarry),
            dict(c, parcel_peak=group.all_reduce(c["parcel_peak"], "max",
                                                 CKPT_TAG)))

    def global_like(sc):
        rows = lambda x: x.new_zeros((S * x.shape[0],)  # noqa: E731
                                     + tuple(x.shape[1:]))
        return xc.SimCarry(type(sc.sts)(*[rows(x) for x in sc.sts]),
                           tuple(rows(x) for x in sc.eq),
                           sc.rec._replace(times=rows(sc.rec.times),
                                           count=rows(sc.rec.count)),
                           tuple(rows(x) for x in sc.hcarry), sc.counters)

    def local_carry(gc):
        rows = lambda x: shard_rows(x, group)  # noqa: E731
        rec = gc.rec
        return xc.SimCarry(
            type(gc.sts)(*[rows(x) for x in gc.sts]),
            tuple(rows(x) for x in gc.eq),
            ev.SpikeRecord(rows(rec.times), rows(rec.count),
                           rec.overflow if rank == 0
                           else torch.zeros_like(rec.overflow)),
            tuple(rows(x) for x in gc.hcarry), gc.counters)

    placed = None if pl is None else \
        hashlib.sha256(np.asarray(pl.perm, np.int64).tobytes()).hexdigest()

    def save_fn(ckpt_dir, rnd, sc, extras=None, keep=3):
        gc = global_carry(sc)
        if rank == 0:
            xc.save_sim_checkpoint(ckpt_dir, rnd, gc, extras=extras,
                                   keep=keep)

    def restore_fn(ckpt_dir, rnd, like):
        gc, extras, skipped = xc.restore_sim_checkpoint(ckpt_dir, rnd,
                                                        global_like(like))
        if extras.get("placement") != placed:
            raise ValueError("the checkpoint was written under another "
                             "placement; resume with the same one")
        return local_carry(gc), extras, skipped

    def poison_fn(sc, lane, value):
        off = rank * n_local
        if off <= lane < off + n_local:
            return xc.poison_lane(sc, lane - off, value)
        return sc

    # the incremental horizon's carry depends on the layout: a resume
    # under another one reseeds it from the restored clocks
    fingerprint = {"world": S, "transport": transport,
                   "batch_cap": int(batch_cap), "horizon": horizon} \
        if fn.incremental else None
    carry, health = xc.run_checkpointed(
        init_fn, step_fn, cond_fn, ckpt_dir=ckpt_dir,
        checkpoint_every=checkpoint_every, resume=resume, keep=ckpt_keep,
        fault=fault, health_of=health_of if watchdog else None,
        max_rollbacks=max_rollbacks, fingerprint=fingerprint,
        reseed=(lambda sc: sc._replace(hcarry=seed_hcarry(
            sc.sts.t, group.all_gather(sc.sts.t, CKPT_TAG))))
        if fn.incremental else None,
        extras_fn=lambda: {"placement": placed}, save_fn=save_fn,
        restore_fn=restore_fn, poison_fn=poison_fn)
    sts, rec, cnt = carry.sts, carry.rec, carry.counters
    # --- gather the whole network's result onto every rank ----------------
    solver = xc.solver_stats(sts)
    names = list(solver)
    tot = group.all_reduce(
        torch.stack([solver[q].to(torch.int64) for q in names]
                    + [rec.overflow.to(torch.int64),
                       sts.failed.any().to(torch.int64)]), "sum", OTHER_TAG)
    solver = dict(zip(names, tot[:len(names)]))
    rec = ev.SpikeRecord(group.all_gather(rec.times, OTHER_TAG),
                         group.all_gather(rec.count, OTHER_TAG),
                         tot[len(names)].to(torch.int32))
    y_final = group.all_gather(sts.zn[:, 0], OTHER_TAG)
    rounds = int(cnt["rounds"])
    peak = group.all_reduce(cnt["parcel_peak"][:rounds], "max",
                            OTHER_TAG).tolist() if rounds else []
    health["dropped_events"] = int(cnt["dropped"])
    failed = bool(tot[-1]) or health["rollback_exhausted"]
    res = RunResult(rec, solver["nst"], cnt["n_ev"].to(torch.int32),
                    cnt["n_rs"].to(torch.int32),
                    cnt["dropped"].to(torch.int32),
                    torch.tensor(failed, device=dev), y_final,
                    comm={"parcel_bytes": int(cnt["parcel_bytes"]),
                          "parcel_peak": peak, "rounds": rounds,
                          "channels": group.counters()},
                    solver=solver, health=health)
    if pl is not None:
        res = plc.unpermute_result(res, pl)
    return res, rounds
