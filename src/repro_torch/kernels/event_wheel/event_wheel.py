"""CUDA wrapper of the fused horizon + runnable score (K5).

Replaces ``repro/kernels/event_wheel/event_wheel.py::horizon_score_pallas``
together with the gather ``t_clock[pre_byk] + delay_byk`` that
``repro.kernels.event_wheel.ops.fused_horizon_select`` runs before it: the
kernel (``csrc/horizon.cu``) gathers the clocks of each neuron's K
in-edges itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_I32, _P, _F64 = ctypes.c_int, ctypes.c_void_p, ctypes.c_double


def _lib():
    lib = build.load("horizon")
    if not getattr(lib, "_typed", False):
        lib.horizon_score_launch.argtypes = [_P, _P, _P, _I32, _I32, _F64,
                                             _F64, _F64, _P, _P, _P]
        lib.horizon_score_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def horizon_score_cuda(t_clock, pre_byk, delay_byk, *, t_end: float,
                       horizon_cap: float, eps: float = 1e-12):
    """t_clock f64[N]; pre_byk i32[K, N]; delay_byk f64[K, N] ->
    (horizon f64[N], score f64[N])."""
    K, N = pre_byk.shape
    dev = t_clock.device
    if not t_clock.is_cuda or t_clock.dtype != torch.float64 \
            or t_clock.shape != (N,) or not t_clock.is_contiguous():
        raise ValueError("t_clock must be a contiguous float64[N] CUDA tensor")
    if pre_byk.dtype != torch.int32 or not pre_byk.is_contiguous() \
            or pre_byk.device != dev:
        raise ValueError("pre_byk must be a contiguous int32[K, N] on the device")
    if delay_byk.dtype != torch.float64 or tuple(delay_byk.shape) != (K, N) \
            or not delay_byk.is_contiguous() or delay_byk.device != dev:
        raise ValueError("delay_byk must be a contiguous float64[K, N] "
                         "on the device")
    hor = torch.empty((N,), dtype=torch.float64, device=dev)
    score = torch.empty((N,), dtype=torch.float64, device=dev)
    err = _lib().horizon_score_launch(
        build.ptr(t_clock), build.ptr(pre_byk), build.ptr(delay_byk), K, N,
        float(t_end), float(horizon_cap), float(eps), build.ptr(hor),
        build.ptr(score), build.stream_ptr(dev))
    build.check(err, "horizon_score")
    build.count("horizon_score")
    return hor, score
