"""Plain PyTorch version of the flash-attention kernel (K10).

The same function as ``repro/kernels/attention/flash.py::_flash_kernel``
over the whole kv row at once: scores ``q . k * (1/sqrt(D))`` in float32,
masked entries at the finite ``NEG_INF`` (causal ``col <= row + offset``,
and ``col < kv_len``), ``p = exp(s - max)`` in float32, ``p`` cast to the
inputs' dtype before the product with v (float32 accumulation), and the
output ``acc / max(l, 1e-30)`` in ``out_dtype``.  The running-max rescale
of the tiled kernel changes only the rounding.  Float64 inputs are
computed in float64 (the CPU gradient checks); every other dtype in
float32.

``flash_attention_bwd_ref`` is the plain version of K10's backward
(``csrc/flash_backward.cu``): the gradient of the same function, through
the row statistics ``lse`` recomputed from q and k and ``D_i =
rowsum(dO * o)`` of the forward's output.
"""
from __future__ import annotations

import torch

NEG_INF = -1.0e30
BF16_U = 2.0 ** -8      # unit roundoff of bfloat16 (8 significant bits)
MAX_GROUP = 8           # GQA groups the backward takes


def geometry(q, k, causal=True, offset=None, kv_len=None):
    """The real causal geometry of ``q [B,H,Sq,D]`` against ``k
    [B,Hkv,Skv,D]``: ``kv_len`` (default Skv) and ``offset`` (default
    ``kv_len - Sq``, the queries at the end of the timeline).

    Raises where a query row would have no valid column: the Pallas kernel
    then returns an average over its padded tiles and the reference NaN.
    """
    B, H, Sq, D = q.shape
    Bk, Hkv, Skv, Dk = k.shape
    if Bk != B or Dk != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "make GQA attention")
    kv_len = Skv if kv_len is None else int(kv_len)
    offset = kv_len - Sq if offset is None else int(offset)
    if not 1 <= kv_len <= Skv:
        raise ValueError(f"kv_len {kv_len} outside [1, {Skv}]")
    if causal and offset < 0:
        raise ValueError(f"causal offset {offset} < 0 leaves query row 0 "
                         "without a valid column")
    return kv_len, offset


def bwd_geometry(q, k, causal=True, offset=None, kv_len=None) -> int:
    """The geometries K10's backward takes, returning the causal offset:
    every kv column (``kv_len`` = Skv) and, causal, the queries at the end
    of the timeline (``offset`` = Skv - Sq, so Sq <= Skv); GQA groups 1-8
    (``MAX_GROUP``).  Raises ``ValueError`` for any other."""
    kv_len, offset = geometry(q, k, causal, offset, kv_len)
    Sq, Skv = q.shape[2], k.shape[2]
    if kv_len != Skv or (causal and offset != Skv - Sq):
        raise ValueError(f"K10's backward takes kv_len = Skv ({Skv}) and, "
                         f"causal, offset = Skv - Sq ({Skv - Sq}); got "
                         f"kv_len {kv_len}, offset {offset}")
    if q.shape[1] // k.shape[1] > MAX_GROUP:
        raise ValueError(f"K10's backward takes GQA groups up to "
                         f"{MAX_GROUP}, got {q.shape[1] // k.shape[1]}")
    return offset


def _acc(x):
    """The dtype the plain versions compute in: float64 for float64
    inputs, float32 for the others."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _scores(q, k, causal, offset, kv_len):
    """(s, valid, kk): the scaled scores [B, H, Sq, Skv] with masked
    entries at ``NEG_INF``, the valid mask [Sq, Skv], and k repeated to
    the query heads, in the compute dtype."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    acc = _acc(q)
    kk = k.repeat_interleave(H // k.shape[1], dim=1).to(acc)
    scale = 1.0 / (D ** 0.5)
    s = torch.matmul(q.to(acc), kk.transpose(-1, -2)) * scale
    cols = torch.arange(Skv, device=q.device)
    valid = (cols < kv_len)[None, :]
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None] + offset
        valid = valid & (cols[None, :] <= rows)
    return torch.where(valid, s, torch.full_like(s, NEG_INF)), valid, kk


def flash_attention_ref(q, k, v, causal=True, offset=None, kv_len=None,
                        out_dtype=None):
    """q: [B, H, Sq, D]; k, v: [B, Hkv, Skv, D] -> [B, H, Sq, D]."""
    kv_len, offset = geometry(q, k, causal, offset, kv_len)
    acc = _acc(q)
    s, _, _ = _scores(q, k, causal, offset, kv_len)
    vv = v.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    out = torch.matmul(p.to(v.dtype).to(acc), vv.to(acc))
    return (out / den).to(out_dtype or q.dtype)


def flash_attention_bwd_ref(q, k, v, o, do, causal=True):
    """(dq, dk, dv) of K10's function at q [B, H, Sq, D], k, v [B, Hkv,
    Skv, D], given its output o and the gradient do of o ([B, H, Sq, D]),
    each in its input's dtype.  The geometries of ``bwd_geometry``.

    With lse = max + log(sum exp) of a row's valid scores and D_i =
    rowsum(do * o): P = exp(s - lse), 0 where masked; dv = P^T do; dP = do
    v^T; dS = P (dP - D_i); dq = scale dS k; dk = scale dS^T q; dk and dv
    summed over each kv head's group of query heads."""
    offset = bwd_geometry(q, k, causal)
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = H // Hkv
    acc = _acc(q)
    s, valid, kk = _scores(q, k, causal, offset, Skv)
    vv = v.repeat_interleave(g, dim=1).to(acc)
    m = s.amax(dim=-1, keepdim=True)
    lse = m + torch.log(torch.exp(s - m).sum(dim=-1, keepdim=True))
    p = torch.where(valid, torch.exp(s - lse), torch.zeros_like(s))
    do, qf = do.to(acc), q.to(acc)
    dsum = (do * o.to(acc)).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(do, vv.transpose(-1, -2)) - dsum)
    scale = 1.0 / (D ** 0.5)
    dq = torch.matmul(ds, kk) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.transpose(-1, -2), do)

    def group_sum(x):
        return x.reshape(B, Hkv, g, Skv, D).sum(dim=2)

    return (dq.to(q.dtype), group_sum(dk).to(k.dtype),
            group_sum(dv).to(v.dtype))


def bf16_rounding_bound(q, k, v, causal=True, offset=None, kv_len=None,
                        out_dtype=None):
    """Per-element bound on ``|a - b|`` for two versions of this function
    on the same bf16 inputs that differ only in how they round.

    Each rounds every weight ``p_j`` (or ``p_j / l``) to bf16, within
    ``BF16_U`` of itself, and accumulates in float32, so each lies within
    ``BF16_U * sum_j (p_j / l) |v_j|`` of the exact value -- the plain
    version applied to ``|v|`` -- and the two within twice that.  A bf16
    output adds one rounding to each: ``2 * BF16_U * |o|``.  Float32
    summation order is not covered; the caller adds its float32
    tolerance.
    """
    f32 = torch.float32
    bound = 2 * BF16_U * flash_attention_ref(q, k, v.abs(), causal, offset,
                                             kv_len, f32)
    if (out_dtype or q.dtype) == torch.bfloat16:
        bound = bound + 2 * BF16_U * flash_attention_ref(
            q, k, v, causal, offset, kv_len, f32).abs()
    return bound
