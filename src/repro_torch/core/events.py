"""Synaptic event queues: fixed-capacity, fully vectorised.

Counterpart of ``repro.core.events``: dense per-neuron slot arrays, a
batched insert with the same slot assignment and the same drop count, and
a masked-reduction delivery.  Empty slots hold ``t = +inf``.  Overflow is
detected, never silent: ``dropped`` accumulates.

JAX's out-of-range ``mode="drop"`` scatters have no torch counterpart:
the rows they would drop are filtered out before each ``index_put_``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.detmath import fixed_sum

INF = float("inf")


class EventQueue(NamedTuple):
    t: torch.Tensor        # f64[N, Q] delivery times (+inf = free)
    w_ampa: torch.Tensor   # f64[N, Q]
    w_gaba: torch.Tensor   # f64[N, Q]
    dropped: torch.Tensor  # i32[] overflow counter


def make_queue(n: int, capacity: int, device, dtype=torch.float64) -> EventQueue:
    return EventQueue(
        t=torch.full((n, capacity), INF, dtype=dtype, device=device),
        w_ampa=torch.zeros((n, capacity), dtype=dtype, device=device),
        w_gaba=torch.zeros((n, capacity), dtype=dtype, device=device),
        dropped=torch.zeros((), dtype=torch.int32, device=device),
    )


def _segment_rank(tgt, n):
    """Stable sort of the targets and each event's rank within its target
    segment: (order, tgt_sorted, rank)."""
    E = tgt.shape[0]
    tgt_s, order = torch.sort(tgt, stable=True)
    idx = torch.arange(E, device=tgt.device)
    rank = idx - torch.searchsorted(tgt_s, tgt_s, right=False)
    return order, tgt_s, rank


def add_lost(counter, lost, rows, n: int):
    """``counter`` plus the events flagged in ``lost``.  The counter is a
    scalar, or one count per tenant ([T]) in the tenant-batched queue and
    record of ``exec_fap``'s ``tenant_round``, whose rows [t * n / T, (t +
    1) * n / T) belong to tenant t; ``rows`` are the events' rows in
    [0, n)."""
    if counter.dim() == 0:
        return counter + lost.sum().to(torch.int32)
    T = counter.shape[0]
    tenant = torch.clamp(rows.reshape(-1), 0, n - 1) // (n // T)
    return counter + torch.bincount(tenant[lost.reshape(-1)],
                                    minlength=T).to(torch.int32)


def _write(eq, ok, row, slot, t_ev, w_ampa, w_gaba, order, tgt_s, n):
    """Write the ``ok`` events into (row, slot); count the others dropped."""
    te, wa, wg = t_ev[order], w_ampa[order], w_gaba[order]
    r, s = row[ok], slot[ok]
    new_t, new_a, new_g = eq.t.clone(), eq.w_ampa.clone(), eq.w_gaba.clone()
    new_t[r, s] = te[ok]
    new_a[r, s] = wa[ok]
    new_g[r, s] = wg[ok]
    dropped = add_lost(eq.dropped, (tgt_s < n) & ~ok, row, n)
    return EventQueue(new_t, new_a, new_g, dropped)


def insert(eq: EventQueue, target, t_ev, w_ampa, w_gaba, valid) -> EventQueue:
    """Batched insert of E candidate events; invalid entries are ignored.

    target i[E]; t_ev/w_ampa/w_gaba f64[E]; valid bool[E].  Events sharing
    a target get distinct free slots: (rank within the target segment of a
    stable sort) -> (rank-th free slot of that neuron).
    """
    n, cap = eq.t.shape
    tgt = torch.where(valid, target.to(torch.int64), n)     # park invalid at n
    order, tgt_s, rank = _segment_rank(tgt, n)
    # rank-th free slot per neuron: free slots sorted first
    free = torch.isinf(eq.t)                                   # [N, Q]
    slot_order = torch.sort((~free).to(torch.uint8), dim=1,
                            stable=True).indices
    n_free = free.sum(dim=1)
    tgt_c = torch.clamp(tgt_s, 0, n - 1)
    ok = (tgt_s < n) & (rank < n_free[tgt_c])
    slot = slot_order[tgt_c, torch.clamp(rank, 0, cap - 1)]
    return _write(eq, ok, tgt_c, slot, t_ev, w_ampa, w_gaba, order, tgt_s, n)


def insert_rows(eq: EventQueue, target, t_ev, w_ampa, w_gaba,
                valid) -> EventQueue:
    """``insert`` for a small event batch: identical slot assignment and
    drop semantics, with the free-slot search over the targeted rows only
    (one [E, Q] gather + cumsum)."""
    n, cap = eq.t.shape
    tgt = torch.where(valid, target.to(torch.int64), n)
    order, tgt_s, rank = _segment_rank(tgt, n)
    tgt_c = torch.clamp(tgt_s, 0, n - 1)
    free_rows = torch.isinf(eq.t[tgt_c])                      # [E, Q]
    csum = torch.cumsum(free_rows.to(torch.int32), dim=1)
    ok = (tgt_s < n) & (rank < csum[:, -1])
    hit = free_rows & (csum == (rank + 1)[:, None])
    slot = torch.argmax(hit.to(torch.uint8), dim=1)
    return _write(eq, ok, tgt_c, slot, t_ev, w_ampa, w_gaba, order, tgt_s, n)


def next_time(eq: EventQueue):
    """Earliest pending delivery time per neuron, +inf if none.  f64[N]."""
    return eq.t.amin(dim=1)


def deliver_until(eq: EventQueue, t_dl):
    """Pop all events with t <= t_dl (per neuron); return summed weights.

    t_dl: f64[N].  Returns (eq', w_ampa[N], w_gaba[N], n_delivered[N]).
    """
    due = eq.t <= t_dl[:, None]
    wa = fixed_sum(torch.where(due, eq.w_ampa, 0.0))
    wg = fixed_sum(torch.where(due, eq.w_gaba, 0.0))
    cnt = due.sum(dim=1).to(torch.int32)
    new_t = torch.where(due, INF, eq.t)
    return EventQueue(new_t, eq.w_ampa, eq.w_gaba, eq.dropped), wa, wg, cnt


class SpikeRecord(NamedTuple):
    """Global spike-train recorder with fixed capacity per neuron."""
    times: torch.Tensor    # f64[N, S]
    count: torch.Tensor    # i32[N]
    overflow: torch.Tensor  # i32[]


def make_spike_record(n: int, capacity: int, device,
                      dtype=torch.float64) -> SpikeRecord:
    return SpikeRecord(
        torch.full((n, capacity), INF, dtype=dtype, device=device),
        torch.zeros((n,), dtype=torch.int32, device=device),
        torch.zeros((), dtype=torch.int32, device=device))


def record_spikes(rec: SpikeRecord, neuron, t_spike, valid) -> SpikeRecord:
    """Append spikes (neuron[i], t_spike[i]) for valid[i] (at most one spike
    per neuron per call, so a neuron's slot is its count)."""
    n, cap = rec.times.shape
    neuron = neuron.to(torch.int64)
    slot = rec.count[torch.clamp(neuron, 0, n - 1)].to(torch.int64)
    ok = slot < cap
    keep = valid & ok & (neuron < n)
    times = rec.times.clone()
    times[neuron[keep], slot[keep]] = t_spike[keep]
    count = rec.count.clone()
    count.index_put_((neuron[keep],),
                     torch.ones_like(neuron[keep], dtype=torch.int32),
                     accumulate=True)
    overflow = add_lost(rec.overflow, valid & ~ok, neuron, n)
    return SpikeRecord(times, count, overflow)
