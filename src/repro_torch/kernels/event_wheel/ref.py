"""Plain PyTorch versions of the scheduler kernels (K5 horizon, K6
compaction, K7 compact-gather and their rows forms, K8 segment rank, K9 row
compaction) and the sort-based earliest-K oracle.

``segment_rank_split_ref``, ``compact_rows_packed_ref`` and
``compact_gather_sched_ref`` model the CUDA kernels' schedules
(``csrc/segment_rank.cu``, ``csrc/compact.cu``) on the CPU, step for step
in what each block, warp and lane counts; only the tests use them, to hold
the schedules bitwise to the plain versions."""
from __future__ import annotations

import torch

RANK_ROWS = 2048
RANK_WARPS = 32          # K8: events (warps) of one block, half from each end
RANK_CHUNK = 28672       # K8: keys of one staged chunk
RANK_GROUP = 4           # K8: keys of one lane's 16-byte load
RANK_CHECK = 8           # K8: full trips between early-stop checks
PASS_THREADS = 1024      # K6/K7/K9: threads of a block that scans a row
GATHER_UNROLL = 8        # K7: table loads of a thread before its stores


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


def compact_ids_rows_ref(mask, cap: int):
    """K6's rows form, plain: ``compact_ids_ref`` on each row of a bool[T,
    N] mask, as one row-wise cumsum and scatter.  Returns (ids i32[T, cap],
    count i32[T])."""
    T, n = mask.shape
    dev = mask.device
    msk = mask.to(torch.int32)
    csum = torch.cumsum(msk, 1, dtype=torch.int32)
    pos = csum - msk
    slot = torch.where((msk == 1) & (pos < cap), pos, cap).long()
    ids = torch.full((T, cap + 1), n, dtype=torch.int32, device=dev)
    ids.scatter_(1, slot, torch.arange(n, dtype=torch.int32, device=dev)
                 .expand(T, n))
    cnt = csum[:, -1] if n else torch.zeros((T,), dtype=torch.int32,
                                            device=dev)
    return ids[:, :cap], cnt


def compact_gather_rows_ref(mask, table, cap: int, fill: int):
    """K7's rows form, plain: ``compact_gather_ref`` on each row of a
    bool[T, N] mask against the one i32[N, MO] table.  Returns (ids i32[T,
    cap], rows i32[T, cap, MO], count i32[T])."""
    n = mask.shape[1]
    ids, cnt = compact_ids_rows_ref(mask, cap)
    rows = table[torch.clamp(ids, max=n - 1).long()]
    rows = torch.where((ids < n)[:, :, None], rows, fill).to(torch.int32)
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


def segment_rank_events(E: int, warps: int = RANK_WARPS):
    """K8's events by block and warp: i64[blocks, warps], -1 for an idle
    warp.  Block b's first half of warps take events half*b + w from the
    front of the batch, its second half events E - 1 - half*b - w from the
    back, so every block compares about as many keys."""
    half = warps // 2
    front = (E + 1) // 2
    nb = (E + warps - 1) // warps
    t = half * torch.arange(nb)[:, None] + torch.arange(half)[None, :]
    lo = torch.where(t < front, t, -1)
    hi = torch.where(t < E - front, E - 1 - t, -1)
    return torch.cat([lo, hi], dim=1)


def segment_rank_split_ref(key, max_rank: int, lanes: int = 32,
                           chunk: int = RANK_CHUNK, group: int = RANK_GROUP,
                           check: int = RANK_CHECK):
    """K8's schedule: each block stages the keys its events need, key[0,
    j_end), in chunks of ``chunk``; in a chunk the warp of event j counts
    equal keys below j, lane l over the ``group``-key words l, l + lanes,
    ...; after each block of ``check`` full trips and at each chunk's end
    the warp sums its lanes and stops once the sum reaches ``max_rank``.
    Returns min(sum, max_rank) per event, as ``segment_rank_ref``."""
    E = key.shape[0]
    rank = torch.full((E,), -1, dtype=torch.int32)
    trip = lanes * group
    for js in segment_rank_events(E):
        live = js >= 0
        if not bool(live.any()):
            continue
        kj = key[js.clamp(min=0)]
        j_end = int(js.max()) + 1
        cnt = torch.zeros((js.shape[0], lanes), dtype=torch.int64)
        done = ~live | (max_rank <= 0)
        for c0 in range(0, j_end, chunk):
            n = min(chunk, j_end - c0)
            lim = torch.clamp(js - c0, max=n)              # keys before j
            tile = torch.full((-(-n // trip) * trip,), -1, dtype=key.dtype)
            tile[:n] = key[c0:c0 + n]
            p = torch.arange(tile.shape[0])
            hit = (tile[None, :] == kj[:, None]) & (p[None, :] < lim[:, None])
            # [warp, trip, lane]: the keys lane l of a trip compares
            per = hit.reshape(js.shape[0], -1, lanes, group).sum(-1)
            full = (lim // trip).clamp(min=0)              # full trips
            k = torch.arange(per.shape[1])
            at = torch.cumsum(per, 1) + cnt[:, None, :]    # after trip k
            stop = (k[None, :] % check == check - 1) & (k[None, :] <
                                                        full[:, None])
            stop &= at.sum(-1) >= max_rank
            first = torch.where(stop.any(1), stop.int().argmax(1),
                                per.shape[1] - 1)
            new = at[torch.arange(js.shape[0]), first]
            cnt = torch.where(done[:, None], cnt, new)
            done = done | stop.any(1) | (js <= c0 + n) \
                | (cnt.sum(-1) >= max_rank)
        rank[js[live]] = torch.clamp(cnt.sum(-1), max=max_rank)[live] \
            .to(torch.int32)
    return rank


def compact_rows_packed_ref(mask, values, cap: int,
                            threads: int = PASS_THREADS):
    """K9's schedule, one block per row.  A [D, M] mask whose storage is
    the contiguous [M, D] bytes of a transposed view, with 16 % D == 0, is
    read as 16-byte groups, one a thread: 16 / D columns of all D rows, of
    which row d keeps bits k * D + d (LPT = 16 / D lanes a thread).  Any
    other mask is read per row, 16 lanes a thread.  In each pass of
    ``threads`` threads a warp's 32 * LPT lanes are written in LPT rounds
    of 32: slot = the pass carry + the warp's exclusive sum of the warp
    counts + the earlier rounds' set lanes + the lane's rank in its round's
    ballot.  Returns (idx, vals, count) as ``compact_rows_ref``."""
    D, M = mask.shape
    packed = D > 1 and 16 % D == 0 and mask.stride() == (1, D)
    lpt = 16 // D if packed else 16
    per_pass = threads * lpt
    passes = -(-M // per_pass)
    nz = mask != 0
    if packed:
        # storage byte 16 g + k D + d: column lpt g + k of row d
        store = torch.zeros((passes * threads * 16,), dtype=torch.bool)
        store[:D * M] = nz.T.reshape(-1)
        groups = store.reshape(-1, lpt, D)                  # [g, k, d]
        bits = groups.permute(2, 0, 1)                      # [d, g, k]
    else:
        bits = torch.zeros((D, passes * per_pass), dtype=torch.bool)
        bits[:, :M] = nz
        bits = bits.reshape(D, -1, lpt)                     # [d, thread, k]
    # lane o = 32 r + l of warp w is bit o % lpt of the warp's thread o //
    # lpt: [d, pass, warp, round, lane]
    s = bits.reshape(D, passes, threads // 32, lpt, 32).to(torch.int64)
    in_round = torch.cumsum(s, -1) - s
    round_cnt = s.sum(-1)
    round_base = torch.cumsum(round_cnt, -1) - round_cnt
    warp_cnt = round_cnt.sum(-1)
    warp_base = torch.cumsum(warp_cnt, -1) - warp_cnt
    pass_cnt = warp_cnt.sum(-1)
    carry = torch.cumsum(pass_cnt, -1) - pass_cnt
    pos = (carry[:, :, None, None, None] + warp_base[..., None, None]
           + round_base[..., None] + in_round).reshape(D, -1)[:, :M]
    keep = s.reshape(D, -1)[:, :M].bool() & (pos < cap)
    rows, cols = torch.nonzero(keep, as_tuple=True)
    idx = torch.full((D, cap), M, dtype=torch.int32)
    vals = torch.zeros((D, cap), dtype=values.dtype)
    idx[rows, pos[rows, cols]] = cols.to(torch.int32)
    vals[rows, pos[rows, cols]] = values[rows, cols]
    return idx, vals, pass_cnt.sum(-1).to(torch.int32)


def compact_gather_sched_ref(mask, table, cap: int, fill: int,
                             blocks: int = 1, threads: int = PASS_THREADS,
                             unroll: int = GATHER_UNROLL):
    """K7's schedule: the ids from K6's pass (``compact_rows_packed_ref`` on
    the one row), then each of ``blocks`` blocks gathers entries [n_e b /
    G, n_e (b + 1) / G) of the n_e = kept * MO filled ones and fills its
    share of the rest alike.  Thread t of a block walks its entries e =
    e0 + t, + threads, ... in trips of ``unroll``, with (slot, column)
    found by one division at the start and advanced by adds (threads
    entries on = threads // MO slots and threads % MO columns on); every
    entry must be written exactly once.  Returns (ids, rows, count) as
    ``compact_gather_ref``."""
    n = mask.shape[0]
    mo = table.shape[1]
    idx, _, cnt = compact_rows_packed_ref(
        mask[None], torch.zeros((1, n), dtype=torch.float64), cap, threads)
    ids = idx[0].clone()
    kept = min(int(cnt[0]), cap)
    n_e, n_fill = kept * mo, (cap - kept) * mo
    rows = torch.zeros((cap * mo,), dtype=torch.int32)
    writes = torch.zeros((cap * mo,), dtype=torch.int64)
    flat = table.reshape(-1)
    q, rm = (threads // mo, threads % mo) if mo else (0, 0)
    for b in range(blocks):
        f0, f1 = n_fill * b // blocks, n_fill * (b + 1) // blocks
        rows[n_e + f0:n_e + f1] = fill
        writes[n_e + f0:n_e + f1] += 1
        g1 = n_e * (b + 1) // blocks
        e = n_e * b // blocks + torch.arange(threads)
        live = e < g1
        if not bool(live.any()):
            continue
        r, c = e // mo, e % mo                  # one division a thread
        while bool(live.any()):
            for _ in range(unroll):
                on = e < g1
                rows[e[on]] = flat[ids[r[on]].long() * mo + c[on]]
                writes[e[on]] += 1
                e = e + threads
                r, c = r + q, c + rm
                wrap = c >= mo
                r, c = r + wrap.long(), torch.where(wrap, c - mo, c)
            live = live & (e < g1)
    if not bool((writes == 1).all()):
        raise AssertionError("an entry was written more or less than once")
    return ids, rows.reshape(cap, mo), cnt[0]
