"""CUDA wrappers of the Hines factor (K1), factored solve (K2) and fused
solve (K3).

Replace ``repro/kernels/hines/hines.py::hines_factor_pallas``,
``::hines_solve_factored_pallas`` and ``::hines_solve_pallas``; the kernels
are in ``csrc/hines.cu``.
Arrays are ``[C, N]`` (compartments x neurons) as in the JAX package; any
strides are accepted, so a transposed view of ``[N, C]`` rows needs no
copy.  The output has the strides of its main input.

Each kernel has two frames, and ``plan`` picks one from C.  The tile
frame stages a tile of ``TILE`` neurons per block in shared memory -- one
operand for K1, three for K2, two for K3 (``TILES``) -- and gives each
neuron four threads ("lanes") that walk the tree's level schedule, which
each block derives from ``parent`` (``core.hines.hines_schedule`` models
it).  A tree whose tile does not fit takes the warp frame: one warp per
neuron, several neurons a block, on the schedule words built once per tree
by ``core.hines.warp_words`` and handed over by ``schedule``.  Where the
block keeps them is the plan's ``place``: "shared" (the words, g_axial
and each neuron's rows in shared memory) while one neuron fits beside
them, "rows" (the rows only) while one neuron's rows fit, else "device"
(the rows walked in device memory).  The plan refuses only C < 1, and the
schedule a tree out of Hines order.  The wrappers, called thousands of
times a run, check their operands in one expression, keep their typed
launchers and hand over raw pointers.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import hines as core_hines
from repro_torch.kernels import build

_I64, _I32, _P = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
_ARGS = {"hines_factor": [_P, _P, _P, _I64, _I64, _P, _I64, _I64, _I32, _I32,
                          _P],
         "hines_solve_factored": [_P, _P, _P, _I64, _I64, _P, _I64, _I64, _P,
                                  _I64, _I64, _I32, _I32, _P]}
_ARGS["hines_solve"] = _ARGS["hines_solve_factored"]
# the warp frame's one signature: g_axial, the schedule words (their count,
# F, M, D), a, b, out (each with its two strides), workspace, C, N, place,
# neurons a block, stream; and its occupancy query: place, neurons a
# block, shared bytes
_WARP_ARGS = [_P, _P, _I32, _I32, _I32, _I32, _P, _I64, _I64, _P, _I64, _I64,
              _P, _I64, _I64, _P, _I32, _I32, _I32, _I32, _P]

# Each kernel's tiles of [C][TILE + 1] float64: K1 d; K2 d_elim, b and the
# multipliers; K3 d and b -- ``tile_smem_bytes`` in csrc/hines.cu.
TILES = {"hines_factor": 1, "hines_solve_factored": 3, "hines_solve": 2}
TILE = 32                      # neurons per block (kNB in csrc/hines.cu)
# The warp frame's rows of C float64 a neuron: K1 d; K2 d_elim and b; K3 d
# and b -- ``warp_smem_bytes`` in csrc/hines.cu.
WARP_ROWS = {"hines_factor": 1, "hines_solve_factored": 2, "hines_solve": 2}
WARP_MAX = 16                  # neurons (warps) a block (kWarpMax)
WARP_DEVICE = 8                # neurons a block walking device memory
PLACES = ("device", "rows", "shared")   # Place in csrc/hines.cu
SMEM_MAX = 232448              # H100: a block's shared memory after opting
#                                in above 48 KB (227 KB, NVIDIA's Hopper
#                                architecture documentation)


class Plan(NamedTuple):
    """How a kernel runs a tree of C compartments: ``frame`` "tile" (TILE
    neurons a block) or "warp" (a warp a neuron); ``place``, where the
    block keeps its operands ("shared": all in shared memory; the warp
    frame's "rows": its rows only; "device": none); ``neurons``, the
    neurons a block; ``smem``, the block's dynamic shared memory in
    bytes."""
    frame: str
    place: str
    neurons: int
    smem: int


@functools.lru_cache(maxsize=None)
def _launcher(kernel: str):
    fn = getattr(build.load("hines"), kernel if kernel.endswith("_blocks")
                 else f"{kernel}_launch")
    fn.argtypes = [_I32, _I32, _I64] if kernel.endswith("_blocks") else \
        _WARP_ARGS if kernel.endswith("_warp") else _ARGS[kernel]
    fn.restype = ctypes.c_int
    return fn


def tile_smem_bytes(nb: int, C: int, tiles: int = 3) -> int:
    """Shared memory of a block of ``nb`` neurons with C compartments and
    ``tiles`` staged operands (K2's three by default): the tiles, g_axial
    and 6 C + 3 int32 of tree and level schedule."""
    return 8 * tiles * (nb + 1) * C + 32 * C + 12


def warp_words_bound(C: int) -> int:
    """The most schedule words a tree of C compartments has
    (``core.hines.warp_words``: 8 C + 1 for a chain, padded to 4)."""
    return 8 * C + 4


def warp_tables(C: int, words: int, F: int) -> int:
    """A "shared" block's tables in 4-byte words: the tree's ``words``
    schedule words, and the g_axial it reads beside them, packed by
    entry: two float64 for each of the F forward entries, one for each
    back entry, and g_axial itself."""
    return words + 4 * F + 4 * C


def warp_tables_bound(C: int) -> int:
    """The most ``warp_tables`` a tree of C compartments needs (a
    chain's)."""
    return warp_tables(C, warp_words_bound(C), C - 1)


def warp_smem_bytes(C: int, kernel: str, place: str, neurons: int,
                    tables: int | None = None) -> int:
    """Shared memory of a warp-frame block of ``neurons`` neurons
    (``warp_smem_bytes`` in csrc/hines.cu): each neuron's
    ``WARP_ROWS[kernel]`` rows of C float64 and, "shared", the tree's
    ``tables`` (``warp_tables``; their bound by default)."""
    if place == "device":
        return 0
    rows = 8 * WARP_ROWS[kernel] * C * neurons
    if place == "rows":
        return rows
    return rows + 4 * (warp_tables_bound(C) if tables is None else tables)


@functools.lru_cache(maxsize=None)
def plan(C: int, kernel: str = "hines_solve_factored",
         tables: int | None = None) -> Plan:
    """The frame of ``kernel`` (K2 by default) for C compartments: the tile
    frame while its tile fits the block's shared memory, else the warp
    frame with as many neurons a block (up to WARP_MAX) as fit: "shared"
    beside the tree's ``tables`` (``warp_tables``; their bound by
    default), else "rows", else "device" (WARP_DEVICE neurons a block).
    Only C < 1 is refused."""
    if C < 1:
        raise ValueError(f"a tree has at least one compartment, got C={C}")
    tile = tile_smem_bytes(TILE, C, TILES[kernel])
    if tile <= SMEM_MAX:
        return Plan("tile", "shared", TILE, tile)
    row = warp_smem_bytes(C, kernel, "rows", 1)
    for place, room in (("shared", SMEM_MAX - warp_smem_bytes(
            C, kernel, "shared", 0, tables)), ("rows", SMEM_MAX)):
        n = min(WARP_MAX, room // row)
        if n >= 1:
            return Plan("warp", place, n,
                        warp_smem_bytes(C, kernel, place, n, tables))
    return Plan("warp", "device", WARP_DEVICE, 0)


def max_compartments(kernel: str) -> int:
    """The largest C whose tile ``kernel`` takes."""
    per_c = tile_smem_bytes(TILE, 1, TILES[kernel]) - 12
    return (SMEM_MAX - 12) // per_c


def warp_limits(kernel: str) -> tuple:
    """The largest C that ``kernel``'s warp frame keeps "shared" whatever
    the tree (its tables at their bound, a chain's), and "rows"."""
    row = 8 * WARP_ROWS[kernel]
    return SMEM_MAX // (64 + row), SMEM_MAX // row


def blocks_per_sm(kernel: str, C: int, tables: int | None = None) -> int:
    """The warp-frame blocks of ``plan(C, kernel, tables)`` that one SM of
    the current card holds at once (CUDA's occupancy calculator)."""
    pl = plan(C, kernel, tables)
    return _launcher(f"{kernel}_warp_blocks")(PLACES.index(pl.place),
                                              pl.neurons, pl.smem)


_TREES: dict = {}           # the last trees' addresses -> (parent, tree)
_TREES_MAX = 64


class Tree(NamedTuple):
    """A tree's schedule as the warp frame takes it: ``words``
    (``core.hines.warp_words``, int32 on the tree's device), the deepest
    depth D, F parents and M words of ``more`` (their header)."""
    words: torch.Tensor
    D: int
    F: int
    M: int


def schedule(parent) -> Tree:
    """The schedule of the tree ``parent`` (int32 [C] on a device) as the
    warp frame reads it.  ``core.hines.tree_sweeps`` builds it once per
    tree (and refuses a tree out of Hines order); the tree's one host copy
    is made when its address is new, and the last ``_TREES_MAX`` addresses
    are kept, each with its version and a reference to the tree, so an
    edited tree is looked up anew."""
    key = (parent.data_ptr(), parent.shape[0], parent.device,
           parent._version)
    hit = _TREES.get(key)
    if hit is None:
        sw = core_hines.tree_sweeps(tuple(parent.tolist()),
                                    str(parent.device))
        F, M = sw.words[:2].tolist()
        if len(_TREES) >= _TREES_MAX:
            del _TREES[next(iter(_TREES))]
        hit = _TREES[key] = (parent, Tree(sw.words, sw.schedule.depth, F, M))
    return hit[1]


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


def _warp(kernel, parent, g_axial, a, b, out):
    """Launch ``kernel``'s warp frame as ``plan`` places it for this tree;
    K3 walking device memory gets its [N, C] workspace here."""
    C, N = out.shape
    tree = schedule(parent)
    words = tree.words.numel()
    pl = plan(C, kernel, warp_tables(C, words, tree.F))
    work = torch.empty((N, C), dtype=torch.float64, device=out.device) \
        if pl.place == "device" and kernel == "hines_solve" else None
    As, bs, os = a.stride(), b.stride(), out.stride()
    err = _launcher(f"{kernel}_warp")(
        g_axial.data_ptr(), tree.words.data_ptr(), words, tree.F, tree.M,
        tree.D, a.data_ptr(), As[0], As[1], b.data_ptr(), bs[0], bs[1],
        out.data_ptr(), os[0], os[1], None if work is None else
        work.data_ptr(), C, N, PLACES.index(pl.place), pl.neurons,
        build.stream_ptr(out.device))
    build.check(err, f"{kernel}_warp")
    build.count(f"{kernel}_warp")


def hines_factor_cuda(parent, g_axial, d):
    """K1: d [C, N] -> d_elim [C, N] (the child->parent elimination)."""
    C, N = d.shape
    _check(parent, g_axial, d, d, ("d", "d"))
    out = torch.empty_like(d)
    if plan(C, "hines_factor").frame == "tile":
        ds, es = d.stride(), out.stride()
        err = _launcher("hines_factor")(
            parent.data_ptr(), g_axial.data_ptr(), d.data_ptr(), ds[0], ds[1],
            out.data_ptr(), es[0], es[1], C, N, build.stream_ptr(d.device))
        build.check(err, "hines_factor")
    else:
        _warp("hines_factor", parent, g_axial, d, d, out)
    build.count("hines_factor")
    return out


def _solve(kernel, parent, g_axial, a, b, names):
    C, N = b.shape
    _check(parent, g_axial, b, a, names)
    out = torch.empty_like(b)
    if plan(C, kernel).frame == "tile":
        As, bs, xs = a.stride(), b.stride(), out.stride()
        err = _launcher(kernel)(
            parent.data_ptr(), g_axial.data_ptr(), a.data_ptr(), As[0],
            As[1], b.data_ptr(), bs[0], bs[1], out.data_ptr(), xs[0], xs[1],
            C, N, build.stream_ptr(b.device))
        build.check(err, kernel)
    else:
        _warp(kernel, parent, g_axial, a, b, out)
    build.count(kernel)
    return out


def hines_solve_factored_cuda(parent, g_axial, d_elim, b):
    """K2: d_elim, b [C, N] -> x [C, N] (forward sweep + back substitution)."""
    return _solve("hines_solve_factored", parent, g_axial, d_elim, b,
                  ("b", "d_elim"))


def hines_solve_cuda(parent, g_axial, d, b):
    """K3: d, b [C, N] -> x [C, N] (elimination + both sweeps, fused).

    ``d`` is eliminated in the block's shared memory (the tile, or the warp
    frame's staged rows), so neither input changes; only the warp frame
    walking device memory allocates a workspace."""
    return _solve("hines_solve", parent, g_axial, d, b, ("b", "d"))
