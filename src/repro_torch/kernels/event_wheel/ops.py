"""Scheduler-kernel dispatch (K5-K9), the by-post layout and threshold
selection.  Counterpart of ``repro.kernels.event_wheel.ops``.

``horizon_score``, ``compact_ids``, ``compact_gather``, their rows forms
``compact_ids_rows`` and ``compact_gather_rows``, ``segment_rank`` and
``spike_compact`` launch the CUDA kernel for CUDA tensors and run the
plain version for CPU tensors -- no fallback and no ``impl=`` knob.  The JAX
wrappers' ``domain="batch"`` key remap and scatter-min ``impl`` are
workarounds for running off the TPU; the pairwise ranking here needs
neither (its cost does not depend on the number of keys).  Ranks of
invalid events (key >= n_keys) follow the pairwise count, which may
differ from JAX's scatter path; the wheel insert masks them out.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.event_wheel import ref
from repro_torch.kernels.event_wheel.event_wheel import (
    compact_gather_cuda, compact_gather_rows_cuda, compact_ids_cuda,
    compact_ids_rows_cuda, compact_rows_cuda, horizon_score_cuda,
    segment_rank_cuda)


def _on_cuda(x, what: str) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no {what} kernel for device {x.device}")


def horizon_score(t_clock, pre_byk, delay_byk, *, t_end: float,
                  horizon_cap: float, eps: float = 1e-12):
    """(horizon[N], score[N]) of the by-post in-edge layout, see ``ref``."""
    if _on_cuda(t_clock, "horizon"):
        return horizon_score_cuda(t_clock, pre_byk, delay_byk, t_end=t_end,
                                  horizon_cap=horizon_cap, eps=eps)
    return ref.horizon_gather_ref(t_clock, pre_byk, delay_byk, t_end=t_end,
                                  horizon_cap=horizon_cap, eps=eps)


def compact_ids(mask, cap: int):
    """Compact a bool[N] mask into a gather-id list (K6): (ids i32[cap] --
    the first ``cap`` set lanes in index order, sentinel N; count i32[] --
    total set lanes, may exceed cap: the overflow rolls to a later
    dispatch)."""
    if _on_cuda(mask, "compact_ids"):
        return compact_ids_cuda(mask, cap)
    return ref.compact_ids_ref(mask, cap)


def compact_gather(mask, table, cap: int, *, fill: int = None):
    """``compact_ids`` plus the rows of a static i32[N, MO] table for the
    compacted lanes (K7): (ids i32[cap], rows i32[cap, MO] with ``fill``
    -- default N -- in empty slots, count i32[]).  The compact fan-out's
    edge-id emitter (``table = exec_common.out_edge_table``)."""
    if fill is None:
        fill = mask.shape[0]
    if _on_cuda(mask, "compact_gather"):
        return compact_gather_cuda(mask, table, cap, fill)
    return ref.compact_gather_ref(mask, table, cap, fill)


def compact_ids_rows(mask, cap: int):
    """``compact_ids`` on each row of a bool[T, N] mask in one launch (K6's
    rows form; the tenants of ``exec_fap``'s ``tenant_round``): (ids
    i32[T, cap], count i32[T])."""
    if _on_cuda(mask, "compact_ids_rows"):
        return compact_ids_rows_cuda(mask, cap)
    return ref.compact_ids_rows_ref(mask, cap)


def compact_gather_rows(mask, table, cap: int, *, fill: int = None):
    """``compact_gather`` on each row of a bool[T, N] mask against the one
    i32[N, MO] table, in one launch (K7's rows form): (ids i32[T, cap],
    rows i32[T, cap, MO], count i32[T])."""
    if fill is None:
        fill = mask.shape[1]
    if _on_cuda(mask, "compact_gather_rows"):
        return compact_gather_rows_cuda(mask, table, cap, fill)
    return ref.compact_gather_rows_ref(mask, table, cap, fill)


def segment_rank(key, max_rank: int):
    """Rank of each event within its key group, in event-index order,
    clipped at ``max_rank`` (K8): the wheel's batch-insert slot ranking."""
    if _on_cuda(key, "segment_rank"):
        return segment_rank_cuda(key, max_rank)
    return ref.segment_rank_ref(key, max_rank)


def spike_compact(mask, values, cap: int):
    """Row-wise capped compaction of spike streams into parcel buffers
    (K9), the packer of the sparse spike-parcel transport
    (``repro_torch.distributed.exchange``).  mask bool[D, M] (row d = the
    spikes bound for shard d); values f64[D, M], any strides.  Returns
    (idx i32[D, cap] -- column of each packed entry, sentinel M in empty
    slots; vals f64[D, cap], 0 in empty slots; count i32[D] -- kept per
    row, may exceed cap so the caller counts the drops)."""
    if _on_cuda(mask, "spike_compact"):
        return compact_rows_cuda(mask, values, cap)
    return ref.compact_rows_ref(mask, values, cap)


def select_threshold(score, k, n_iters: int = 48):
    """Smallest bisection point tau with count(score <= tau) >= k, along
    the last axis (a row [T, N] of scores gets its own tau, k a scalar or
    one per row).

    ``score <= tau`` then selects the K earliest runnable neurons; fewer
    than k finite scores -> tau = max finite (select all).  Reductions
    only, no host synchronisation.
    """
    finite = torch.isfinite(score)
    any_run = finite.any(dim=-1)
    lo = torch.where(finite, score, torch.inf).amin(dim=-1)
    hi = torch.where(finite, score, -torch.inf).amax(dim=-1)
    for _ in range(n_iters):
        mid = 0.5 * (lo + hi)
        enough = (score <= mid[..., None]).sum(dim=-1) >= k
        lo, hi = torch.where(enough, lo, mid), torch.where(enough, mid, hi)
    return torch.where(any_run, hi, torch.inf)


def fused_horizon_select(t_clock, pre_byk, delay_byk, *, t_end: float,
                         horizon_cap: float, k_select: int = 0,
                         n_iters: int = 48, rows: int = 1):
    """Scheduler-round notification half: (horizon[N], runnable bool[N]).

    t_clock: f64[N]; pre_byk: i32[K, N], delay_byk: f64[K, N] (column i
    holds neuron i's K in-edges).  With k_select > 0 the mask is
    restricted to the K earliest runnable neurons by threshold count, in
    each of ``rows`` equal blocks of lanes (the tenants of a batched
    round).
    """
    hor, score = horizon_score(t_clock, pre_byk, delay_byk, t_end=t_end,
                               horizon_cap=horizon_cap)
    runnable = torch.isfinite(score)
    if k_select > 0:
        by_row = score.reshape(rows, -1)
        tau = select_threshold(by_row, k_select, n_iters=n_iters)
        runnable = runnable & (by_row <= tau[:, None]).reshape(-1)
    return hor, runnable


def by_post_layout(net, device):
    """Host-side static prep: the [K, N] by-post (pre i32, delay f64)
    layout the fused kernel consumes.  Requires the uniform grouped edge
    list that ``make_network`` emits (``sched.grouped_k``)."""
    from repro_torch.sched import grouped_k
    k = grouped_k(net)
    if k is None:
        raise ValueError("fused horizon kernel needs a uniform by-post "
                         "edge layout (make_network's grouping)")
    n = int(net.n)
    pre = np.ascontiguousarray(np.asarray(net.pre, np.int32).reshape(n, k).T)
    dly = np.ascontiguousarray(
        np.asarray(net.delay, np.float64).reshape(n, k).T)
    return (torch.from_numpy(pre).to(device),
            torch.from_numpy(dly).to(device))
