"""Plain PyTorch versions of the fused horizon/selection pieces."""
from __future__ import annotations

import torch


def horizon_score_ref(cand, t_clock, *, t_end: float, horizon_cap: float,
                      eps: float = 1e-12):
    """cand: f64[K, N] = t_clock[pre] + delay in by-post layout.

    Returns (horizon[N], score[N]): the per-neuron dependency horizon (min
    over in-edges, clamped at t_end and t_clock + horizon_cap) and the
    scheduler score (clock if runnable else +inf).
    """
    hor = torch.clamp(cand.amin(dim=0), max=t_end)
    hor = torch.minimum(hor, t_clock + horizon_cap)
    runnable = t_clock < hor - eps
    return hor, torch.where(runnable, t_clock, torch.inf)


def horizon_gather_ref(t_clock, pre_byk, delay_byk, *, t_end: float,
                       horizon_cap: float, eps: float = 1e-12):
    """The gather ``t_clock[pre_byk] + delay_byk`` and ``horizon_score_ref``:
    the function the CUDA kernel computes."""
    cand = t_clock[pre_byk.long()] + delay_byk
    return horizon_score_ref(cand, t_clock, t_end=t_end,
                             horizon_cap=horizon_cap, eps=eps)

