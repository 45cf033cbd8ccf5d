"""CUDA wrappers of the Hines factor (K1), factored solve (K2) and fused
solve (K3).

Replace ``repro/kernels/hines/hines.py::hines_factor_pallas``,
``::hines_solve_factored_pallas`` and ``::hines_solve_pallas``; the kernels
are in ``csrc/hines.cu``.
Arrays are ``[C, N]`` (compartments x neurons) as in the JAX package; any
strides are accepted, so a transposed view of ``[N, C]`` rows needs no
copy.  The output has the strides of its main input.

Each kernel stages a tile of ``TILE`` neurons per block in shared memory --
one operand for K1, three for K2, two for K3 (``TILES``) -- and gives each
neuron four threads ("lanes") that walk the tree's level schedule, which
each block derives from ``parent`` (``ref.hines_schedule`` models it).  The
wrappers, called thousands of times a run, check their operands in one
expression, keep their typed launchers and hand over raw pointers.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_I64, _I32, _P = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
_ARGS = {"hines_factor": [_P, _P, _P, _I64, _I64, _P, _I64, _I64, _I32, _I32,
                          _P],
         "hines_solve_factored": [_P, _P, _P, _I64, _I64, _P, _I64, _I64, _P,
                                  _I64, _I64, _I32, _I32, _P]}
_ARGS["hines_solve"] = _ARGS["hines_solve_factored"]

# Each kernel's tiles of [C][TILE + 1] float64: K1 d; K2 d_elim, b and the
# multipliers; K3 d and b -- ``tile_smem_bytes`` in csrc/hines.cu.
TILES = {"hines_factor": 1, "hines_solve_factored": 3, "hines_solve": 2}
TILE = 32                      # neurons per block (kNB in csrc/hines.cu)
SMEM_MAX = 232448              # H100: a block's shared memory after opting
#                                in above 48 KB (227 KB, NVIDIA's Hopper
#                                architecture documentation)


@functools.lru_cache(maxsize=None)
def _launcher(kernel: str):
    fn = getattr(build.load("hines"), f"{kernel}_launch")
    fn.argtypes = _ARGS[kernel]
    fn.restype = ctypes.c_int
    return fn


def tile_smem_bytes(nb: int, C: int, tiles: int = 3) -> int:
    """Shared memory of a block of ``nb`` neurons with C compartments and
    ``tiles`` staged operands (K2's three by default): the tiles, g_axial
    and 6 C + 3 int32 of tree and level schedule."""
    return 8 * tiles * (nb + 1) * C + 32 * C + 12


@functools.lru_cache(maxsize=None)
def tile_neurons(C: int, kernel: str = "hines_solve_factored") -> int:
    """The neurons per block of ``kernel`` (K2 by default) for C
    compartments: ``TILE``, once its tile is checked against the block's
    shared memory.  A C whose tile exceeds it is refused."""
    if C < 1:
        raise ValueError(f"a tree has at least one compartment, got C={C}")
    tiles = TILES[kernel]
    if tile_smem_bytes(TILE, C, tiles) > SMEM_MAX:
        raise ValueError(
            f"C={C} compartments do not fit a {kernel} tile: "
            f"{tile_smem_bytes(TILE, C, tiles)} bytes of shared memory for "
            f"{TILE} neurons, at most {SMEM_MAX} (C <= "
            f"{max_compartments(kernel)})")
    return TILE


def max_compartments(kernel: str) -> int:
    """The largest C whose tile ``kernel`` takes."""
    per_c = tile_smem_bytes(TILE, 1, TILES[kernel]) - 12
    return (SMEM_MAX - 12) // per_c


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


def _check(parent, g_axial, a, b, names):
    """The operands as the kernels take them: ``a`` and ``b`` (K1 passes
    its one operand twice) float64 [C, N] on one CUDA device, parent and
    g_axial contiguous [C] there.  One expression on the fast path; the
    detailed checks only to raise."""
    C, dev = a.shape[0], a.device
    if not (a.is_cuda and a.dtype == torch.float64
            and (b is a or (b.dtype == torch.float64 and b.shape == a.shape
                            and b.device == dev))
            and parent.dtype == torch.int32 and parent.shape == (C,)
            and parent.is_contiguous() and parent.device == dev
            and g_axial.dtype == torch.float64 and g_axial.shape == (C,)
            and g_axial.is_contiguous() and g_axial.device == dev):
        _check_mat(a, names[0], a.shape)
        _check_mat(b, names[1], a.shape)
        if b.device != dev:
            raise ValueError(f"{names[0]} and {names[1]} must be on the same "
                             "device")
        _check_tree(parent, g_axial, C, dev)


def hines_factor_cuda(parent, g_axial, d):
    """K1: d [C, N] -> d_elim [C, N] (the child->parent elimination)."""
    C, N = d.shape
    _check(parent, g_axial, d, d, ("d", "d"))
    tile_neurons(C, "hines_factor")
    out = torch.empty_like(d)
    ds, es = d.stride(), out.stride()
    err = _launcher("hines_factor")(
        parent.data_ptr(), g_axial.data_ptr(), d.data_ptr(), ds[0], ds[1],
        out.data_ptr(), es[0], es[1], C, N, build.stream_ptr(d.device))
    build.check(err, "hines_factor")
    build.count("hines_factor")
    return out


def _solve(kernel, parent, g_axial, a, b, names):
    C, N = b.shape
    _check(parent, g_axial, b, a, names)
    tile_neurons(C, kernel)
    out = torch.empty_like(b)
    As, bs, xs = a.stride(), b.stride(), out.stride()
    err = _launcher(kernel)(
        parent.data_ptr(), g_axial.data_ptr(), a.data_ptr(), As[0], As[1],
        b.data_ptr(), bs[0], bs[1], out.data_ptr(), xs[0], xs[1], C, N,
        build.stream_ptr(b.device))
    build.check(err, kernel)
    build.count(kernel)
    return out


def hines_solve_factored_cuda(parent, g_axial, d_elim, b):
    """K2: d_elim, b [C, N] -> x [C, N] (forward sweep + back substitution)."""
    return _solve("hines_solve_factored", parent, g_axial, d_elim, b,
                  ("b", "d_elim"))


def hines_solve_cuda(parent, g_axial, d, b):
    """K3: d, b [C, N] -> x [C, N] (elimination + both sweeps, fused).

    ``d`` is eliminated in the block's shared-memory tile, so neither input
    changes and no device workspace is allocated."""
    return _solve("hines_solve", parent, g_axial, d, b, ("b", "d"))
