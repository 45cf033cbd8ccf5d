"""CUDA wrappers of the Hines factor (K1), factored solve (K2) and fused
solve (K3).

Replace ``repro/kernels/hines/hines.py::hines_factor_pallas``,
``::hines_solve_factored_pallas`` and ``::hines_solve_pallas``; the kernels
are in ``csrc/hines.cu``.
Arrays are ``[C, N]`` (compartments x neurons) as in the JAX package; any
strides are accepted, so a transposed view of ``[N, C]`` rows needs no
copy.  The output has the strides of its main input.

K2 stages a tile of ``tile_neurons(C)`` neurons per block in shared memory
and gives each neuron four threads ("lanes") that walk the tree's level
schedule, which each block derives from ``parent`` (``ref.hines_schedule``
models it); its wrapper, called 4,560 times in a dense 2c run, checks its
operands in one expression and keeps its typed launcher.
"""
from __future__ import annotations

import ctypes
import functools

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


# K2's tile: x, d_elim and the multipliers as [C][nb + 1] float64, g_axial,
# parent and the level schedule -- ``factored_smem_bytes`` in csrc/hines.cu.
TILE = 32                      # neurons per block (kNB in csrc/hines.cu)
SMEM_MAX = 232448              # H100: a block's shared memory after opting
#                                in above 48 KB (227 KB, NVIDIA's Hopper
#                                architecture documentation)


def tile_smem_bytes(nb: int, C: int) -> int:
    """Shared memory of a K2 block of ``nb`` neurons with C compartments."""
    return 24 * (nb + 1) * C + 32 * C + 12


@functools.lru_cache(maxsize=None)
def tile_neurons(C: int) -> int:
    """K2's neurons per block for C compartments: ``TILE``, once the tile
    is checked against the block's shared memory.  A C whose tile exceeds
    it is refused."""
    if C < 1:
        raise ValueError(f"a tree has at least one compartment, got C={C}")
    if tile_smem_bytes(TILE, C) > SMEM_MAX:
        raise ValueError(f"C={C} compartments do not fit a K2 tile: "
                         f"{tile_smem_bytes(TILE, C)} bytes of shared memory "
                         f"for {TILE} neurons, at most {SMEM_MAX}")
    return TILE


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


@functools.lru_cache(maxsize=None)
def _factored_launch():
    return _lib().hines_solve_factored_launch


def hines_solve_factored_cuda(parent, g_axial, d_elim, b):
    """K2: d_elim, b [C, N] -> x [C, N] (forward sweep + back substitution)."""
    C, N = b.shape
    dev = b.device
    if not (b.is_cuda and b.dtype == torch.float64
            and d_elim.dtype == torch.float64 and d_elim.shape == b.shape
            and d_elim.device == dev
            and parent.dtype == torch.int32 and parent.shape == (C,)
            and parent.is_contiguous() and parent.device == dev
            and g_axial.dtype == torch.float64 and g_axial.shape == (C,)
            and g_axial.is_contiguous() and g_axial.device == dev):
        _check_mat(b, "b", (C, N))
        _check_mat(d_elim, "d_elim", (C, N))
        if d_elim.device != dev:
            raise ValueError("d_elim and b must be on the same device")
        _check_tree(parent, g_axial, C, dev)
    tile_neurons(C)
    out = torch.empty_like(b)
    es, bs, xs = d_elim.stride(), b.stride(), out.stride()
    err = _factored_launch()(
        parent.data_ptr(), g_axial.data_ptr(), d_elim.data_ptr(), es[0],
        es[1], b.data_ptr(), bs[0], bs[1], out.data_ptr(), xs[0], xs[1], C, N,
        build.stream_ptr(dev))
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
