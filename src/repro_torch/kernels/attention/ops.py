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

``meta`` tensors (the dry run's, ``launch/dryrun.py``: the caller's
explicit choice, never a fallback) get empty outputs of the kernels'
shapes, layouts and dtypes -- no ``[B, H, Sq, Skv]`` scores, which K10
never allocates -- and, inside :func:`count_meta_flops`, add K10's
products by formula: those the plain version computes, 2 B H Sq Skv D
each, two in the forward (``ref.py``'s scores and p v) and five in the
backward (the scores again, dP, dq, dk, dv).
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels.attention import ref
from repro_torch.kernels.attention.flash import (HEAD_DIMS,
                                                 flash_attention_cuda,
                                                 variant)
from repro_torch.kernels.attention.flash_backward import (
    _TILE, flash_attention_bwd_cuda)

FWD_PRODUCTS, BWD_PRODUCTS = 2, 5        # 2 B H Sq Skv D operations each
_counters = threading.local()


class count_meta_flops:
    """``with count_meta_flops() as c``: ``c["forward"]`` and
    ``c["backward"]`` sum K10's operations on ``meta`` tensors inside the
    block."""

    def __enter__(self) -> dict:
        self.counts = {"forward": 0, "backward": 0}
        self.prev = getattr(_counters, "active", ())
        _counters.active = self.prev + (self.counts,)
        return self.counts

    def __exit__(self, *exc):
        _counters.active = self.prev


def _count(q, k, products, key):
    B, H, Sq, D = q.shape
    n = products * 2 * B * H * Sq * k.shape[2] * D
    for c in getattr(_counters, "active", ()):
        c[key] += n


def _meta_out(B, S, H, D, dtype):
    """An empty output in the kernels' layout: ``[B, S, H, D]`` storage
    seen as ``[B, H, S, D]``."""
    return torch.empty((B, S, H, D), dtype=dtype,
                       device="meta").transpose(1, 2)


def _forward_meta(q, k, v, causal, offset, kv_len, out_dtype):
    ref.geometry(q, k, causal, offset, kv_len)
    B, H, Sq, D = q.shape
    variant(q.dtype, Sq, H // k.shape[1], D)     # a kernel takes the call
    _count(q, k, FWD_PRODUCTS, "forward")
    return _meta_out(B, Sq, H, D, out_dtype or q.dtype)


def _backward_meta(q, k, v, causal):
    """dq, dk, dv in the kernels' layouts, after the scratch they
    allocate (row statistics; for bf16 the split dO and the tile flags)."""
    ref.bwd_geometry(q, k, causal)
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    _count(q, k, BWD_PRODUCTS, "backward")
    dq, dk, dv = (_meta_out(B, S, h, D, q.dtype)
                  for S, h in ((Sq, H), (Skv, Hkv), (Skv, Hkv)))
    tiles = -(-Sq // _TILE)
    scratch = [torch.empty((2, B, H, tiles * _TILE), device="meta")]
    if q.dtype == torch.bfloat16:
        scratch += [torch.empty((3, B, H, tiles * _TILE, D), dtype=q.dtype,
                                device="meta"),
                    torch.empty((B, H, tiles), dtype=torch.int32,
                                device="meta")]
    del scratch
    return dq, dk, dv


def _forward(q, k, v, causal, offset, kv_len, out_dtype):
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, offset=offset,
                                    kv_len=kv_len, out_dtype=out_dtype)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal, offset, kv_len,
                                       out_dtype)
    if q.device.type == "meta":
        return _forward_meta(q, k, v, causal, offset, kv_len, out_dtype)
    raise ValueError(f"no flash-attention kernel for device {q.device}")


def flash_attention_bwd(q, k, v, o, do, causal=True):
    """(dq, dk, dv) of K10 at q, k, v given its output o and the gradient
    do of o: the backward kernels on a CUDA tensor, the plain version on
    a CPU one."""
    if q.device.type == "cuda":
        return flash_attention_bwd_cuda(q, k, v, o, do, causal=causal)
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, do, causal)
    if q.device.type == "meta":
        return _backward_meta(q, k, v, causal)
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
