"""Fused horizon (K5) dispatch, the by-post layout and threshold selection.

Counterpart of ``repro.kernels.event_wheel.ops`` for the pieces the dense
main path runs.  ``horizon_score`` launches the CUDA kernel for CUDA
tensors and runs the plain version for CPU tensors -- no fallback.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.event_wheel import ref
from repro_torch.kernels.event_wheel.event_wheel import horizon_score_cuda


def horizon_score(t_clock, pre_byk, delay_byk, *, t_end: float,
                  horizon_cap: float, eps: float = 1e-12):
    """(horizon[N], score[N]) of the by-post in-edge layout, see ``ref``."""
    if t_clock.device.type == "cuda":
        return horizon_score_cuda(t_clock, pre_byk, delay_byk, t_end=t_end,
                                  horizon_cap=horizon_cap, eps=eps)
    if t_clock.device.type == "cpu":
        return ref.horizon_gather_ref(t_clock, pre_byk, delay_byk,
                                      t_end=t_end, horizon_cap=horizon_cap,
                                      eps=eps)
    raise ValueError(f"no horizon kernel for device {t_clock.device}")


def select_threshold(score, k, n_iters: int = 48):
    """Smallest bisection point tau with count(score <= tau) >= k.

    ``score <= tau`` then selects the K earliest runnable neurons; fewer
    than k finite scores -> tau = max finite (select all).  Reductions
    only, no host synchronisation.
    """
    finite = torch.isfinite(score)
    any_run = finite.any()
    lo = torch.where(finite, score, torch.inf).amin()
    hi = torch.where(finite, score, -torch.inf).amax()
    for _ in range(n_iters):
        mid = 0.5 * (lo + hi)
        enough = (score <= mid).sum() >= k
        lo, hi = torch.where(enough, lo, mid), torch.where(enough, mid, hi)
    return torch.where(any_run, hi, torch.inf)


def fused_horizon_select(t_clock, pre_byk, delay_byk, *, t_end: float,
                         horizon_cap: float, k_select: int = 0,
                         n_iters: int = 48):
    """Scheduler-round notification half: (horizon[N], runnable bool[N]).

    t_clock: f64[N]; pre_byk: i32[K, N], delay_byk: f64[K, N] (column i
    holds neuron i's K in-edges).  With k_select > 0 the mask is
    restricted to the K earliest runnable neurons by threshold count.
    """
    hor, score = horizon_score(t_clock, pre_byk, delay_byk, t_end=t_end,
                               horizon_cap=horizon_cap)
    runnable = torch.isfinite(score)
    if k_select > 0:
        tau = select_threshold(score, k_select, n_iters=n_iters)
        runnable = runnable & (score <= tau)
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
