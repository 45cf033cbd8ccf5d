"""Plain PyTorch version of the flash-attention kernel (K10).

The same function as ``repro/kernels/attention/flash.py::_flash_kernel``
over the whole kv row at once: scores ``q . k * (1/sqrt(D))`` in float32,
masked entries at the finite ``NEG_INF`` (causal ``col <= row + offset``,
and ``col < kv_len``), ``p = exp(s - max)`` in float32, ``p`` cast to the
inputs' dtype before the product with v (float32 accumulation), and the
output ``acc / max(l, 1e-30)`` in ``out_dtype``.  The running-max rescale
of the tiled kernel changes only the rounding.
"""
from __future__ import annotations

import torch

NEG_INF = -1.0e30
BF16_U = 2.0 ** -8      # unit roundoff of bfloat16 (8 significant bits)


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


def flash_attention_ref(q, k, v, causal=True, offset=None, kv_len=None,
                        out_dtype=None):
    """q: [B, H, Sq, D]; k, v: [B, Hkv, Skv, D] -> [B, H, Sq, D]."""
    kv_len, offset = geometry(q, k, causal, offset, kv_len)
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    g = H // k.shape[1]
    kk = k.repeat_interleave(g, dim=1).to(torch.float32)
    vv = v.repeat_interleave(g, dim=1)
    scale = 1.0 / (D ** 0.5)
    s = torch.matmul(q.to(torch.float32), kk.transpose(-1, -2)) * scale
    cols = torch.arange(Skv, device=q.device)
    valid = (cols < kv_len)[None, :]
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None] + offset
        valid = valid & (cols[None, :] <= rows)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    acc = torch.matmul(p.to(v.dtype).to(torch.float32), vv.to(torch.float32))
    return (acc / den).to(out_dtype or q.dtype)


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
