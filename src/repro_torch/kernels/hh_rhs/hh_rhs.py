"""CUDA wrapper of the fused HH right-hand side (K4).

Replaces ``repro/kernels/hh_rhs/hh_rhs.py::hh_rhs_pallas``; the kernel is
in ``csrc/hh_rhs.cu``.  Inputs v, m, h, n are ``[N, C]`` views that share
one compartment stride (the cell model passes slices of its packed state
rows); the five outputs are contiguous ``[N, C]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_I64, _I32, _P = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p


def _lib():
    lib = build.load("hh_rhs")
    if not getattr(lib, "_typed", False):
        lib.hh_rhs_launch.argtypes = [_P, _P, _I64, _P, _I64, _P, _I64, _P,
                                      _I64, _I64, _P, _P, _P, _P, _P, _I32,
                                      _I32, _P]
        lib.hh_rhs_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def hh_rhs_cuda(area, v, m, h, n):
    """area [C]; v, m, h, n [N, C] -> (dm, dh, dn, i_ion, g_tot) [N, C]."""
    N, C = v.shape
    for name, x in (("v", v), ("m", m), ("h", h), ("n", n)):
        if not x.is_cuda or x.dtype != torch.float64 \
                or tuple(x.shape) != (N, C) or x.device != v.device:
            raise ValueError(f"{name} must be a float64 CUDA tensor [N, C] "
                             f"on {v.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        if C > 1 and x.stride(1) != v.stride(1):
            raise ValueError("v, m, h, n must share the compartment stride")
    if area.dtype != torch.float64 or area.shape != (C,) \
            or not area.is_contiguous() or area.device != v.device:
        raise ValueError("area must be a contiguous float64[C] on the device")
    outs = [torch.empty((N, C), dtype=torch.float64, device=v.device)
            for _ in range(5)]
    err = _lib().hh_rhs_launch(
        build.ptr(area), build.ptr(v), v.stride(0), build.ptr(m), m.stride(0),
        build.ptr(h), h.stride(0), build.ptr(n), n.stride(0), v.stride(1),
        *[build.ptr(o) for o in outs], N, C, build.stream_ptr(v.device))
    build.check(err, "hh_rhs")
    build.count("hh_rhs")
    return tuple(outs)
