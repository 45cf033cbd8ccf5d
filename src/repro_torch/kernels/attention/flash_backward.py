"""CUDA wrapper of K10's backward (``csrc/flash_backward.cu``).

No TPU kernel stands behind it: the JAX package differentiates its jnp
attention (``repro/models/attention.py`` ``chunked_causal_attention`` and
``bidirectional_attention``).  Two kernels, launched in order on the
current stream: ``flash_bwd_dq`` (dq, and the row statistics lse and D_i
into a ``[B, H, Sqp]`` float32 scratch, Sqp = Sq rounded up to 64; for
bf16 inputs also dO's three bf16 pieces into a ``[3, B, H, Sqp, D]``
scratch and a ``[B, H, Sqp / 64]`` int32 flag per query tile) and
``flash_bwd_dkdv`` (dk and dv, a block per query head, the GQA group's
blocks one thread-block cluster that sums their partials in head order:
every sum in a fixed order).  bf16 inputs multiply on the tensor cores
at float32 accuracy, float32 inputs on the CUDA cores (the source's
header).  They count under ``flash_attention_bwd_dq`` and
``flash_attention_bwd_dkdv``.

Inputs as the forward wrapper takes them (``flash.py``): q, k and v
float32 or bfloat16 views with a contiguous head dimension and 16-byte
aligned rows, head sizes 16, 64, 112 and 128; o (the forward's output)
and do float32 ``[B, H, Sq, D]`` views alike.  The geometries of
``ref.bwd_geometry``.  dq, dk and dv come back in the inputs' dtype, as
``[B, H, S, D]`` views of ``[B, S, H, D]`` tensors, like the forward's
output.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention.flash import HEAD_DIMS
from repro_torch.kernels.attention.ref import bwd_geometry

_I64, _I32, _P = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VIEW = [_P, _I64, _I64, _I64]               # pointer and three strides
_LAUNCHERS = {
    "dq": ("flash_bwd_dq_launch", _VIEW * 6 + [_P] * 4 + [_I32] * 9 + [_P]),
    "dkdv": ("flash_bwd_dkdv_launch",
             _VIEW * 6 + [_P] * 4 + [_I32] * 9 + [_P]),
}
_TILE = 64                                   # the kernels' query tile


def _launcher(kind):
    symbol, argtypes = _LAUNCHERS[kind]
    fn = getattr(build.load("flash_backward"), symbol)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _view(name, x, dtype, device):
    """A view's pointer and strides, after the kernels' checks."""
    if not x.is_cuda or x.dim() != 4 or x.dtype != dtype \
            or x.device != device:
        raise ValueError(f"{name} must be a 4-d CUDA tensor of dtype {dtype} "
                         f"on {device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    st = x.stride()
    per16 = 16 // x.element_size()
    if st[3] != 1 or x.data_ptr() % 16 or any(a % per16 for a in st[:3]):
        raise ValueError(f"K10's backward reads 16-byte rows: {name} needs a "
                         "contiguous head dimension, 16-byte aligned data "
                         f"and strides in multiples of {per16} elements")
    return [x.data_ptr(), *st[:3]]


def _out(B, S, H, D, dtype, device):
    return torch.empty((B, S, H, D), dtype=dtype, device=device).transpose(1,
                                                                           2)


def flash_attention_bwd_cuda(q, k, v, o, do, causal=True):
    """(dq, dk, dv) of K10's function; see the module docstring."""
    if q.dtype not in _CODES:
        raise ValueError(f"K10's backward takes float32 or bfloat16 inputs, "
                         f"got {q.dtype}")
    dev = q.device
    args_q = _view("q", q, q.dtype, dev)
    args_k = _view("k", k, q.dtype, dev)
    args_v = _view("v", v, q.dtype, dev)
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if v.shape != k.shape or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)} do not make K10's backward")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    offset = bwd_geometry(q, k, causal)
    args_o = _view("o", o, torch.float32, dev)
    args_do = _view("do", do, torch.float32, dev)
    dq = _out(B, Sq, H, D, q.dtype, dev)
    dk = _out(B, Skv, Hkv, D, q.dtype, dev)
    dv = _out(B, Skv, Hkv, D, q.dtype, dev)
    if B * H * Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    n_tiles = -(-Sq // _TILE)
    Sqp = n_tiles * _TILE
    stats = torch.empty((2, B, H, Sqp), dtype=torch.float32, device=dev)
    scratch = [build.ptr(stats[0]), build.ptr(stats[1]), None, None]
    if q.dtype == torch.bfloat16:
        split = torch.empty((3, B, H, Sqp, D), dtype=torch.bfloat16,
                            device=dev)
        flags = torch.empty((B, H, n_tiles), dtype=torch.int32, device=dev)
        scratch[2:] = build.ptr(split), build.ptr(flags)
    shape = (B, H, Hkv, Sq, Skv, D, offset, int(causal), _CODES[q.dtype])
    stream = build.stream_ptr(dev)
    err = _launcher("dq")(*args_q, *args_k, *args_v, *args_o, *args_do,
                          *_view("dq", dq, q.dtype, dev), *scratch, *shape,
                          stream)
    build.check(err, "flash_attention_bwd_dq")
    build.count("flash_attention_bwd_dq")
    err = _launcher("dkdv")(*args_q, *args_k, *args_v, *args_do,
                            *_view("dk", dk, q.dtype, dev),
                            *_view("dv", dv, q.dtype, dev), *scratch,
                            *shape, stream)
    build.check(err, "flash_attention_bwd_dkdv")
    build.count("flash_attention_bwd_dkdv")
    return dq, dk, dv
