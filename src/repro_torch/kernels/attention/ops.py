"""Dispatch of flash attention (K10) and of its gradient.

CPU tensors take the plain version; CUDA tensors launch one of K10's four
kernels (``flash.variant``: float32 decode and prefill on the CUDA cores,
bf16 decode and prefill on the tensor cores), and a kernel that cannot
launch raises -- there is no fallback.  Unlike the JAX wrapper nothing is
padded: the kernels mask ragged Sq/Skv themselves.

Where autograd records (grad mode on and q, k or v requiring grad) the
call goes through ``FlashAttentionFn``: the same forward, whose backward
is K10's backward kernels on the card (``flash_backward.py``) and their
plain version on the CPU.  Calls that record nothing -- every serving
call -- take the plain dispatch, and launch exactly what they did before.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention import ref
from repro_torch.kernels.attention.flash import flash_attention_cuda
from repro_torch.kernels.attention.flash_backward import \
    flash_attention_bwd_cuda


def _forward(q, k, v, causal, offset, kv_len, out_dtype):
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, offset=offset,
                                    kv_len=kv_len, out_dtype=out_dtype)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal, offset, kv_len,
                                       out_dtype)
    raise ValueError(f"no flash-attention kernel for device {q.device}")


def flash_attention_bwd(q, k, v, o, do, causal=True):
    """(dq, dk, dv) of K10 at q, k, v given its output o and the gradient
    do of o: the backward kernels on a CUDA tensor, the plain version on
    a CPU one."""
    if q.device.type == "cuda":
        return flash_attention_bwd_cuda(q, k, v, o, do, causal=causal)
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, do, causal)
    raise ValueError(f"no flash-attention kernel for device {q.device}")


def _grad_dtype(q):
    """The output dtype of a differentiated call: float32 (float64 for
    float64 inputs, on the CPU)."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


class FlashAttentionFn(torch.autograd.Function):
    """K10 with its gradient: ``apply(q, k, v, causal, offset, kv_len)``
    -> o [B, H, Sq, D] in ``_grad_dtype``, for the geometries of
    ``ref.bwd_geometry`` (checked before the forward launches).  Saves q,
    k, v and o; the gradients come back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, offset=None, kv_len=None):
        ref.bwd_geometry(q, k, causal, offset, kv_len)
        o = _forward(q, k, v, causal, None, None, _grad_dtype(q))
        ctx.save_for_backward(q, k, v, o)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        if do.is_cuda and (do.stride(-1) != 1 or do.data_ptr() % 16 or
                           any(s % 4 for s in do.stride()[:3])):
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=True, offset=None, kv_len=None,
                    out_dtype=None):
    """q: [B, H, Sq, D]; k, v: [B, Hkv, Skv, D] -> [B, H, Sq, D].

    ``kv_len`` (default Skv) masks the kv columns at and past it;
    ``offset`` (default ``kv_len - Sq``) places the queries on the causal
    timeline; the output is ``out_dtype`` (default q's dtype).  A call
    that autograd records goes through ``FlashAttentionFn``: its
    geometries, and an output in ``_grad_dtype`` (``out_dtype`` None or
    that dtype).
    """
    if torch.is_grad_enabled() and any(getattr(x, "requires_grad", False)
                                       for x in (q, k, v)):
        if out_dtype not in (None, _grad_dtype(q)):
            raise ValueError(f"a differentiated K10 call returns "
                             f"{_grad_dtype(q)}, not {out_dtype}")
        return FlashAttentionFn.apply(q, k, v, causal, offset, kv_len)
    return _forward(q, k, v, causal, offset, kv_len, out_dtype)
