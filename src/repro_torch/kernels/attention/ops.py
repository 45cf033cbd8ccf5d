"""Dispatch of flash attention (K10).

CPU tensors take the plain version; CUDA tensors launch one of K10's four
kernels (``flash.variant``: float32 decode and prefill on the CUDA cores,
bf16 decode and prefill on the tensor cores), and a kernel that cannot
launch raises -- there is no fallback.  Unlike the JAX wrapper nothing is
padded: the kernels mask ragged Sq/Skv themselves.
"""
from __future__ import annotations

from repro_torch.kernels.attention import ref
from repro_torch.kernels.attention.flash import flash_attention_cuda


def flash_attention(q, k, v, causal=True, offset=None, kv_len=None,
                    out_dtype=None):
    """q: [B, H, Sq, D]; k, v: [B, Hkv, Skv, D] -> [B, H, Sq, D].

    ``kv_len`` (default Skv) masks the kv columns at and past it;
    ``offset`` (default ``kv_len - Sq``) places the queries on the causal
    timeline; the output is ``out_dtype`` (default q's dtype).
    """
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, offset=offset,
                                    kv_len=kv_len, out_dtype=out_dtype)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal, offset, kv_len,
                                       out_dtype)
    raise ValueError(f"no flash-attention kernel for device {q.device}")
