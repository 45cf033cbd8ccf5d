"""CUDA wrapper of flash attention (K10).

Replaces ``repro/kernels/attention/flash.py::flash_attention_pallas`` and
its padding wrapper ``repro/kernels/attention/ops.py::flash_attention``;
the kernel is in ``csrc/flash_attention.cu``.  q, k and v are read
through their strides (the head dimension must be contiguous), so the
model's ``[B, S, H, D]`` activations and ``[B, S, Hkv, D]`` cache slices
go in as ``transpose(1, 2)`` views without a copy.  The output is
allocated ``[B, Sq, H, D]`` and returned as its ``[B, H, Sq, D]`` view,
so the model's ``transpose(1, 2)`` back is contiguous.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention.ref import geometry

_I64, _I32, _P = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128)     # the kernel's template instantiations


def _lib():
    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_launch.argtypes = (
            [_P, _I64, _I64, _I64] * 4 + [_I32] * 11 + [_P])
        lib.flash_attention_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def flash_attention_cuda(q, k, v, *, causal=True, offset=None, kv_len=None,
                         out_dtype=None):
    """q: [B, H, Sq, D]; k, v: [B, Hkv, Skv, D] -> [B, H, Sq, D]."""
    out_dtype = out_dtype or q.dtype
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.dim() != 4 or x.dtype != q.dtype \
                or x.device != q.device:
            raise ValueError(f"{name} must be a 4-d CUDA tensor of q's dtype "
                             f"on {q.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous")
    if q.dtype not in _CODES or out_dtype not in (torch.float32, q.dtype):
        raise ValueError(f"K10 takes float32 or bfloat16 inputs with a "
                         f"float32 or input-dtype output, got {q.dtype} -> "
                         f"{out_dtype}")
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} != k {tuple(k.shape)}")
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    kv_len, offset = geometry(q, k, causal, offset, kv_len)
    out = torch.empty((B, Sq, H, D), dtype=out_dtype,
                      device=q.device).transpose(1, 2)
    if B * H * Sq == 0:
        return out
    strides = []
    for x in (q, k, v, out):
        strides += [build.ptr(x), x.stride(0), x.stride(1), x.stride(2)]
    err = _lib().flash_attention_launch(
        *strides, B, H, Hkv, Sq, Skv, D, kv_len, offset, int(causal),
        _CODES[q.dtype], _CODES[out_dtype], build.stream_ptr(q.device))
    build.check(err, "flash_attention")
    build.count("flash_attention")
    return out
