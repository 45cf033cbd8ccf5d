"""CUDA wrappers of the Hines factor (K1), factored solve (K2) and fused
solve (K3).

Replace ``repro/kernels/hines/hines.py::hines_factor_pallas``,
``::hines_solve_factored_pallas`` and ``::hines_solve_pallas``; the kernels
are in ``csrc/hines.cu``.
Arrays are ``[C, N]`` (compartments x neurons) as in the JAX package; any
strides are accepted, so a transposed view of ``[N, C]`` rows needs no
copy.  The output has the strides of its main input.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_I64, _I32, _P = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p


def _lib():
    lib = build.load("hines")
    if not getattr(lib, "_typed", False):
        lib.hines_factor_launch.argtypes = [_P, _P, _P, _I64, _I64, _P, _I64,
                                            _I64, _I32, _I32, _P]
        lib.hines_factor_launch.restype = ctypes.c_int
        lib.hines_solve_factored_launch.argtypes = [
            _P, _P, _P, _I64, _I64, _P, _I64, _I64, _P, _I64, _I64, _I32,
            _I32, _P]
        lib.hines_solve_factored_launch.restype = ctypes.c_int
        lib.hines_solve_launch.argtypes = [
            _P, _P, _P, _I64, _I64, _P, _I64, _I64, _P, _I64, _I64, _P, _I64,
            _I64, _I32, _I32, _P]
        lib.hines_solve_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check_tree(parent, g_axial, C, device):
    if parent.dtype != torch.int32 or parent.shape != (C,) \
            or not parent.is_contiguous() or parent.device != device:
        raise ValueError("parent must be a contiguous int32[C] on the device")
    if g_axial.dtype != torch.float64 or g_axial.shape != (C,) \
            or not g_axial.is_contiguous() or g_axial.device != device:
        raise ValueError("g_axial must be a contiguous float64[C] on the device")


def _check_mat(x, name, shape):
    if not x.is_cuda or x.dtype != torch.float64 or x.dim() != 2 \
            or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be a float64 CUDA tensor of shape "
                         f"{tuple(shape)}, got {x.dtype} {tuple(x.shape)} "
                         f"on {x.device}")


def hines_factor_cuda(parent, g_axial, d):
    """K1: d [C, N] -> d_elim [C, N] (the child->parent elimination)."""
    C, N = d.shape
    _check_mat(d, "d", (C, N))
    _check_tree(parent, g_axial, C, d.device)
    out = torch.empty_like(d)
    err = _lib().hines_factor_launch(
        build.ptr(parent), build.ptr(g_axial), build.ptr(d), d.stride(0),
        d.stride(1), build.ptr(out), out.stride(0), out.stride(1), C, N,
        build.stream_ptr(d.device))
    build.check(err, "hines_factor")
    build.count("hines_factor")
    return out


def hines_solve_factored_cuda(parent, g_axial, d_elim, b):
    """K2: d_elim, b [C, N] -> x [C, N] (forward sweep + back substitution)."""
    C, N = b.shape
    _check_mat(b, "b", (C, N))
    _check_mat(d_elim, "d_elim", (C, N))
    if d_elim.device != b.device:
        raise ValueError("d_elim and b must be on the same device")
    _check_tree(parent, g_axial, C, b.device)
    out = torch.empty_like(b)
    err = _lib().hines_solve_factored_launch(
        build.ptr(parent), build.ptr(g_axial), build.ptr(d_elim),
        d_elim.stride(0), d_elim.stride(1), build.ptr(b), b.stride(0),
        b.stride(1), build.ptr(out), out.stride(0), out.stride(1), C, N,
        build.stream_ptr(b.device))
    build.check(err, "hines_solve_factored")
    build.count("hines_solve_factored")
    return out


def hines_solve_cuda(parent, g_axial, d, b):
    """K3: d, b [C, N] -> x [C, N] (elimination + both sweeps, fused).

    ``d`` is eliminated in a [C, N] workspace, so neither input changes."""
    C, N = b.shape
    _check_mat(b, "b", (C, N))
    _check_mat(d, "d", (C, N))
    if d.device != b.device:
        raise ValueError("d and b must be on the same device")
    _check_tree(parent, g_axial, C, b.device)
    work = torch.empty((C, N), dtype=torch.float64, device=b.device)
    out = torch.empty_like(b)
    err = _lib().hines_solve_launch(
        build.ptr(parent), build.ptr(g_axial), build.ptr(d), d.stride(0),
        d.stride(1), build.ptr(b), b.stride(0), b.stride(1), build.ptr(work),
        work.stride(0), work.stride(1), build.ptr(out), out.stride(0),
        out.stride(1), C, N, build.stream_ptr(b.device))
    build.check(err, "hines_solve")
    build.count("hines_solve")
    return out
