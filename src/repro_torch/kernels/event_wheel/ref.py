"""Plain PyTorch versions of the scheduler kernels (K5 horizon, K6
compaction, K7 compact-gather, K8 segment rank, K9 row compaction) and the
sort-based earliest-K oracle."""
from __future__ import annotations

import torch

RANK_ROWS = 2048


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



def select_earliest_ref(score, k: int):
    """Sort-based earliest-K oracle (the dense scheduler path): select all
    entries with score <= k-th smallest (ties included)."""
    kth = torch.sort(score).values[min(k, score.shape[0]) - 1]
    return torch.isfinite(score) & (score <= kth)


def compact_ids_ref(mask, cap: int):
    """Gather-id compaction (K6's plain version): cumsum ranks and one
    scatter.  Returns (ids i32[cap] -- indices of the first ``cap`` set
    lanes in index order, sentinel N for empty slots; count i32[] -- total
    set lanes, may exceed cap).

    Lanes that are unset or ranked past ``cap`` all go to the dump slot
    ``cap`` of a ``cap + 1`` buffer, which is sliced off: every live slot
    has exactly one writer, so the result is the same on every device."""
    n = mask.shape[0]
    msk = mask.to(torch.int32)
    csum = torch.cumsum(msk, 0, dtype=torch.int32)
    pos = csum - msk
    slot = torch.where((msk == 1) & (pos < cap), pos, cap)
    ids = torch.full((cap + 1,), n, dtype=torch.int32, device=mask.device)
    ids.scatter_(0, slot.long(), torch.arange(n, dtype=torch.int32,
                                              device=mask.device))
    cnt = csum[-1] if n else torch.zeros((), dtype=torch.int32,
                                         device=mask.device)
    return ids[:cap], cnt


def compact_gather_ref(mask, table, cap: int, fill: int):
    """K7's plain version: ``compact_ids_ref`` and one row gather of the
    static table.  Returns (ids i32[cap], rows i32[cap, MO] -- table[ids]
    with ``fill`` in empty slots, count i32[])."""
    n = mask.shape[0]
    ids, cnt = compact_ids_ref(mask, cap)
    rows = table[torch.clamp(ids, max=n - 1).long()]
    rows = torch.where((ids < n)[:, None], rows, fill).to(torch.int32)
    return ids, rows, cnt


def compact_rows_ref(mask, values, cap: int):
    """K9's plain version, the spike-parcel packer: row-wise cumsum ranks
    and one scatter per row (``repro.kernels.event_wheel.ref
    .compact_rows_ref``).  mask [D, M] (nonzero = keep); values f64[D, M]
    (any strides, e.g. one row broadcast to D).  Returns (idx i32[D, cap]
    -- column of the r-th kept element of each row, sentinel M for empty
    slots; vals [D, cap] -- its value, 0 in empty slots; count i32[D] --
    kept per row, may exceed cap).  As in ``compact_ids_ref``, unkept and
    overflowing columns go to a dump column ``cap`` that is sliced off."""
    D, M = mask.shape
    dev = mask.device
    msk = (mask != 0).to(torch.int32)
    csum = torch.cumsum(msk, 1, dtype=torch.int32)
    pos = csum - msk
    col = torch.where((msk == 1) & (pos < cap), pos, cap).long()
    idx = torch.full((D, cap + 1), M, dtype=torch.int32, device=dev)
    idx.scatter_(1, col, torch.arange(M, dtype=torch.int32, device=dev)
                 .expand(D, M))
    vals = torch.zeros((D, cap + 1), dtype=values.dtype, device=dev)
    vals.scatter_(1, col, values.expand(D, M))
    cnt = csum[:, -1] if M else torch.zeros((D,), dtype=torch.int32,
                                            device=dev)
    return idx[:, :cap], vals[:, :cap], cnt


def segment_rank_ref(key, max_rank: int):
    """K8's plain version: rank[j] = |{i < j : key[i] == key[j]}| clipped at
    ``max_rank``, by pairwise comparison (in row blocks of RANK_ROWS to
    bound the compare matrix at [RANK_ROWS, E])."""
    E = key.shape[0]
    idx = torch.arange(E, device=key.device)
    rank = torch.empty((E,), dtype=torch.int32, device=key.device)
    for j0 in range(0, E, RANK_ROWS):
        j1 = min(E, j0 + RANK_ROWS)
        same = key[j0:j1, None] == key[None, :j1]
        earlier = idx[None, :j1] < idx[j0:j1, None]
        rank[j0:j1] = torch.clamp((same & earlier).sum(dim=1), max=max_rank)
    return rank
