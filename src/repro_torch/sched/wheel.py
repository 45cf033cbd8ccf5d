"""Bucketed event wheel (calendar queue) for the FAP scheduler.

Counterpart of ``repro.sched.wheel``.  Each neuron owns ``n_buckets`` time
buckets of ``bucket_slots`` slots; an event at time t hashes to bucket
``floor(t / bucket_width) mod B``.  An event's slot within its bucket
follows its rank among the batch events that hit the same (neuron,
bucket): from the static edge grouping (``insert_grouped``, pairwise
compares within a row) or from the segment-ranking kernel K8
(``insert``).  The free slot for rank r is found by a prefix sum over the
bucket's S slots -- no sort.

Correctness never depends on the hash: a bucket is a partition of the
slot set, so wrap-around collisions cost capacity only.  ``deliver_until``
and ``next_time`` are masked reductions over the flat slot view, as for
the dense queue.  Overflow is counted in ``dropped``, never silent
(within a bucket, later-index events drop first).

The bucket index: the JAX reference runs the wheel inside ``jax.jit``,
where XLA turns the division by the constant bucket width into a
multiplication by its reciprocal.  ``_bucket_of`` multiplies by the same
reciprocal explicitly, so an event that lies exactly on a bucket boundary
lands in the same bucket here, on the card and on the CPU (a product is
one correctly rounded operation on both devices, unlike ``t / 0.5``,
which PyTorch on CUDA turns into a product by a rounded reciprocal only
there).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.core.detmath import fixed_sum
from repro_torch.kernels.event_wheel import ops as ew_ops

INF = float("inf")


class WheelSpec(NamedTuple):
    """Static wheel geometry (host constants)."""
    n_buckets: int = 16
    bucket_slots: int = 4
    bucket_width: float = 0.5      # ms per bucket

    @property
    def capacity(self) -> int:
        return self.n_buckets * self.bucket_slots

    @classmethod
    def auto(cls, net, *, horizon_cap: float = 2.0, n_buckets: int = 16,
             slack: float = 1.25) -> "WheelSpec":
        """Size the wheel from the network (``repro.sched.WheelSpec.auto``):
        one revolution spans ``max_delay + horizon_cap`` with ``slack``
        headroom; ``bucket_slots`` covers the worst synchronized burst
        (exact per-neuron sliding-window load for the grouped edge layout,
        twice an aligned per-(neuron, bucket) histogram otherwise),
        floored at 4."""
        d = np.asarray(net.delay)
        post = np.asarray(net.post)
        n, E = max(1, int(net.n)), int(d.shape[0])
        span = float(d.max()) + horizon_cap
        width = max(1e-3, slack * span / n_buckets)
        k_in = max(1, E // n)
        grouped = E == n * k_in and np.array_equal(
            post, np.repeat(np.arange(n, dtype=post.dtype), k_in))
        if grouped:
            rows = np.sort(d.reshape(n, k_in), axis=1)
            load = 1
            for j in range(k_in):
                within = (rows < rows[:, j: j + 1] + width).sum(axis=1) - j
                load = max(load, int(within.max()))
        else:
            b = np.floor(d / width).astype(np.int64)
            key = post.astype(np.int64) * (int(b.max()) + 1) + b
            load = 2 * int(np.unique(key, return_counts=True)[1].max())
        slots = max(4, int(np.ceil(slack * load)))
        return cls(n_buckets=n_buckets, bucket_slots=slots,
                   bucket_width=width)


class WheelQueue(NamedTuple):
    """Same fields as ``events.EventQueue``: the slot axis is the flat
    (bucket, slot) view, so the advance and the delivery reductions work on
    it unchanged."""
    t: torch.Tensor        # f64[N, B*S] delivery times (+inf = free)
    w_ampa: torch.Tensor   # f64[N, B*S]
    w_gaba: torch.Tensor   # f64[N, B*S]
    dropped: torch.Tensor  # i32[] overflow counter


def make_wheel(n: int, spec: WheelSpec, device,
               dtype=torch.float64) -> WheelQueue:
    cap = spec.capacity
    return WheelQueue(
        t=torch.full((n, cap), INF, dtype=dtype, device=device),
        w_ampa=torch.zeros((n, cap), dtype=dtype, device=device),
        w_gaba=torch.zeros((n, cap), dtype=dtype, device=device),
        dropped=torch.zeros((), dtype=torch.int32, device=device),
    )


def _bucket_of(spec: WheelSpec, t_ev, valid):
    """Bucket index i32 of each event (0 for invalid ones)."""
    t_safe = torch.where(valid, t_ev, 0.0)
    epoch = torch.floor(t_safe * (1.0 / spec.bucket_width)).to(torch.int32)
    return torch.remainder(epoch, spec.n_buckets)


def _place(spec: WheelSpec, free_rows, rank, valid):
    """(bucket free-mask rows [.., S], rank) -> (ok, slot-in-bucket): the
    rank-th event takes the (rank+1)-th free slot; ranks beyond the free
    count drop."""
    S = spec.bucket_slots
    csum = torch.cumsum(free_rows.to(torch.int32), dim=-1, dtype=torch.int32)
    n_free = csum[..., -1]
    ok = valid & (rank < S) & (rank < n_free)
    hit = free_rows & (csum == (rank + 1)[..., None])
    slot = torch.argmax(hit.to(torch.uint8), dim=-1).to(torch.int32)
    return ok, slot


def _write(eq: WheelQueue, ok, row, col, t_ev, w_ampa, w_gaba, valid):
    """Write the kept events at (row, col) -- distinct by rank -- and count
    the valid others dropped.  Dropped events never reach a live slot."""
    r, c = row[ok].long(), col[ok].long()
    new_t, new_a, new_g = eq.t.clone(), eq.w_ampa.clone(), eq.w_gaba.clone()
    new_t[r, c] = t_ev[ok]
    new_a[r, c] = w_ampa[ok]
    new_g[r, c] = w_gaba[ok]
    dropped = ev.add_lost(eq.dropped, valid & ~ok, row, eq.t.shape[0])
    return WheelQueue(new_t, new_a, new_g, dropped)


def insert(spec: WheelSpec, eq: WheelQueue, target, t_ev, w_ampa, w_gaba,
           valid) -> WheelQueue:
    """Generic insert (the signature of ``events.insert``): E candidate
    events to arbitrary targets.  Ranks within (target, bucket) groups
    come from the segment-ranking kernel (K8) over the keys
    ``target * B + bucket`` (invalid events get key N*B and are masked
    out below)."""
    n = eq.t.shape[0]
    B, S = spec.n_buckets, spec.bucket_slots
    target = target.to(torch.int32)
    bucket = _bucket_of(spec, t_ev, valid)
    key = torch.where(valid, target * B + bucket, n * B)
    rank = ew_ops.segment_rank(key.contiguous(), S)
    tgt_c = torch.clamp(torch.where(valid, target, n), 0, n - 1).long()
    free = torch.isinf(eq.t).reshape(n, B, S)
    free_rows = free[tgt_c, bucket.long()]                    # [E, S]
    ok, slot = _place(spec, free_rows, rank, valid)
    return _write(eq, ok, tgt_c, bucket * S + slot, t_ev, w_ampa, w_gaba,
                  valid)


def insert_grouped(spec: WheelSpec, eq: WheelQueue, t_ev, w_ampa, w_gaba,
                   valid) -> WheelQueue:
    """Insert for by-post-grouped traffic: row i of the [N, k] inputs holds
    neuron i's k in-edge candidates.  Ranks within (neuron, bucket) come
    from pairwise equality against the row's earlier valid in-edges."""
    n, k = t_ev.shape
    B, S = spec.n_buckets, spec.bucket_slots
    bucket = _bucket_of(spec, t_ev, valid)                    # [N, k]
    earlier = torch.ones((k, k), dtype=torch.bool,
                         device=t_ev.device).tril(diagonal=-1)
    same = (bucket[:, :, None] == bucket[:, None, :]) & valid[:, None, :] \
        & earlier                                             # [N, i, j<i]
    rank = same.sum(dim=2).to(torch.int32)
    free = torch.isinf(eq.t).reshape(n, B, S)
    free_rows = torch.gather(free, 1,
                             bucket.long()[:, :, None].expand(n, k, S))
    ok, slot = _place(spec, free_rows, rank, valid)
    row = torch.arange(n, device=t_ev.device)[:, None].expand(n, k)
    return _write(eq, ok, row, bucket * S + slot, t_ev, w_ampa, w_gaba,
                  valid)


def bucket_occupancy(spec: WheelSpec, eq: WheelQueue) -> dict:
    """Occupied slots per bucket summed over neurons (i32[B]), the fullest
    (neuron, bucket) cell (== S: the next same-bucket event drops) and the
    total pending events."""
    n = eq.t.shape[0]
    occ = (~torch.isinf(eq.t)).reshape(n, spec.n_buckets, spec.bucket_slots)
    per_cell = occ.sum(dim=2).to(torch.int32)                 # [N, B]
    return {
        "per_bucket": per_cell.sum(dim=0).to(torch.int32),
        "max_bucket": per_cell.max(),
        "occupied": per_cell.sum().to(torch.int32),
    }


def next_time(eq: WheelQueue):
    """Earliest pending delivery time per neuron, +inf if none.  f64[N]."""
    return eq.t.amin(dim=1)


def deliver_until(eq: WheelQueue, t_dl):
    """Pop all events with t <= t_dl (per neuron); return summed weights
    (``fixed_sum``, as the dense queue does).  Buckets need no cursor:
    slots are found by free mask."""
    due = eq.t <= t_dl[:, None]
    wa = fixed_sum(torch.where(due, eq.w_ampa, 0.0))
    wg = fixed_sum(torch.where(due, eq.w_gaba, 0.0))
    cnt = due.sum(dim=1).to(torch.int32)
    new_t = torch.where(due, INF, eq.t)
    return WheelQueue(new_t, eq.w_ampa, eq.w_gaba, eq.dropped), wa, wg, cnt
