"""GQA attention of the LM zoo on flash attention (K10).

The JAX package computes attention in jnp -- chunked-causal for
train/prefill, direct for decode, full for whisper's encoder and
cross-attention -- and names its Pallas flash kernel the
production path.  Here both go through ``kernels.attention.ops``: K10 on
a CUDA tensor, its plain version on the CPU.  The ``[B, S, H, D]``
activations and ``[B, S, Hkv, D]`` caches go in as ``transpose(1, 2)``
views; the kernel reads them through their strides.

Rounding differs from the jnp path in one place: jnp normalises p before
casting it to the compute dtype, flash divides by the row sum after the
product with v.  In float32 the two agree to rounding; in bf16 they
differ by bf16 rounding of p.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention import ops


def repeat_kv(k, group):
    """[B, S, Hkv, D] -> [B, S, Hkv*group, D]."""
    if group == 1:
        return k
    return torch.repeat_interleave(k, group, dim=2)


def chunked_causal_attention(q, k, v, chunk: int = 1024,
                             compute_dtype=torch.bfloat16):
    """Causal self-attention.  q: [B, S, H, D]; k, v: [B, S, Hkv, D] ->
    [B, S, H, D] (float32).

    ``chunk`` is ignored.  It is the JAX function's query chunk, kept so
    that the two signatures match; the kernel's 64-row tiles bound the
    score memory instead.
    """
    del chunk
    cd = compute_dtype
    o = ops.flash_attention(q.to(cd).transpose(1, 2),
                            k.to(cd).transpose(1, 2),
                            v.to(cd).transpose(1, 2), causal=True,
                            out_dtype=torch.float32)
    return o.transpose(1, 2)


def decode_attention(q, k_cache, v_cache, t_pos, compute_dtype=torch.bfloat16):
    """Decode attention against a full cache.

    q: [B, Q, H, D]; caches: [B, S, Hkv, D]; t_pos: current length (int).
    Entries at position >= t_pos are masked: K10 with ``kv_len = t_pos``
    and ``offset = t_pos - 1``, so every query row sees exactly the first
    t_pos columns, and the kv loop stops there.  Returns [B, Q, H, D]
    float32.
    """
    cd = compute_dtype
    t_pos = int(t_pos)
    o = ops.flash_attention(q.to(cd).transpose(1, 2),
                            k_cache.to(cd).transpose(1, 2),
                            v_cache.to(cd).transpose(1, 2), causal=True,
                            offset=t_pos - 1, kv_len=t_pos,
                            out_dtype=torch.float32)
    return o.transpose(1, 2)


def bidirectional_attention(q, k, v, compute_dtype=torch.bfloat16):
    """Full (non-causal) attention: the whisper encoder's, and the
    decoder's cross-attention to the encoder's K/V.  q: [B, Sq, H, D];
    k, v: [B, Skv, Hkv, D] -> [B, Sq, H, D] (float32).

    K10 with ``causal=False``; query head h reads kv head h / (H / Hkv) in
    the kernel, where the JAX version repeats K and V to H heads first.
    """
    cd = compute_dtype
    o = ops.flash_attention(q.to(cd).transpose(1, 2),
                            k.to(cd).transpose(1, 2),
                            v.to(cd).transpose(1, 2), causal=False,
                            out_dtype=torch.float32)
    return o.transpose(1, 2)
