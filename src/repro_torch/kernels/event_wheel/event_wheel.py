"""CUDA wrappers of the scheduler kernels.

* K5 ``horizon_score_cuda`` (``csrc/horizon.cu``) replaces
  ``repro/kernels/event_wheel/event_wheel.py::horizon_score_pallas``
  together with the gather ``t_clock[pre_byk] + delay_byk`` that
  ``repro.kernels.event_wheel.ops.fused_horizon_select`` runs before it:
  the kernel gathers the clocks of each neuron's K in-edges itself.
* K6 ``compact_ids_cuda`` and K7 ``compact_gather_cuda``
  (``csrc/compact.cu``) replace ``compact_ids_pallas`` and
  ``compact_gather_pallas``.
* ``compact_ids_rows_cuda`` and ``compact_gather_rows_cuda``
  (``csrc/compact.cu``) are K6 and K7 on each row of a [T, N] mask in one
  launch: what ``jax.vmap`` makes of ``compact_ids_pallas`` and
  ``compact_gather_pallas`` over the simulation service's tenants.
* K8 ``segment_rank_cuda`` (``csrc/segment_rank.cu``) replaces
  ``segment_rank_pallas``.
* K9 ``compact_rows_cuda`` (``csrc/compact.cu``) replaces
  ``compact_rows_pallas``, the spike-parcel packer.

Each wrapper checks device, type, shape and contiguity, allocates its
outputs, launches on the current stream and adds one to its launch count.
Every wrapper checks in one expression (the detailed errors only when it
fails) and passes raw ``data_ptr()``s to a cached typed launcher; K6
allocates ids and count as one buffer and K5 its two outputs as the rows
of one ``[2, N]`` buffer (K5's: 2-3 us cheaper than two allocations in
an allocation micro-benchmark on the H100, unresolved in the wrapper's
host time); K7 and K9 allocate each output on its own.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_I32, _P, _F64 = ctypes.c_int, ctypes.c_void_p, ctypes.c_double
_I64 = ctypes.c_longlong


_SIGNATURES = {
    "horizon": {"horizon_score_launch": [_P, _P, _P, _I32, _I32, _F64, _F64,
                                         _F64, _P, _P, _P]},
    "compact": {"compact_ids_launch": [_P, _I32, _I32, _P, _P, _P],
                "compact_gather_launch": [_P, _I32, _P, _I32, _I32, _I32, _P,
                                          _P, _P, _P],
                "compact_ids_rows_launch": [_P, _I32, _I32, _I32, _P, _P, _P],
                "compact_gather_rows_launch": [_P, _I32, _I32, _P, _I32, _I32,
                                               _I32, _P, _P, _P, _P],
                "compact_rows_launch": [_P, _I64, _I64, _P, _I64, _I64, _I32,
                                        _I32, _I32, _P, _P, _P, _P]},
    "segment_rank": {"segment_rank_launch": [_P, _I32, _I32, _P, _P]},
}


def _lib(source: str = "horizon"):
    lib = build.load(source)
    if not getattr(lib, "_typed", False):
        for fn, argtypes in _SIGNATURES[source].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib._typed = True
    return lib


def _check_mask(mask, cap: int):
    if not mask.is_cuda or mask.dtype != torch.bool or mask.dim() != 1 \
            or not mask.is_contiguous():
        raise ValueError("mask must be a contiguous bool[N] CUDA tensor")
    if cap < 1:
        raise ValueError(f"cap must be at least 1, got {cap}")


def _check_horizon(t_clock, pre_byk, delay_byk):
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


@functools.lru_cache(maxsize=None)
def _horizon_launch():
    return _lib("horizon").horizon_score_launch


def horizon_score_cuda(t_clock, pre_byk, delay_byk, *, t_end: float,
                       horizon_cap: float, eps: float = 1e-12):
    """t_clock f64[N]; pre_byk i32[K, N]; delay_byk f64[K, N] ->
    (horizon f64[N], score f64[N])."""
    K, N = pre_byk.shape
    dev = t_clock.device
    if not (t_clock.is_cuda and t_clock.dtype == torch.float64
            and t_clock.shape == (N,) and t_clock.is_contiguous()
            and pre_byk.dtype == torch.int32 and pre_byk.is_contiguous()
            and pre_byk.device == dev and delay_byk.dtype == torch.float64
            and delay_byk.shape == pre_byk.shape
            and delay_byk.is_contiguous() and delay_byk.device == dev):
        _check_horizon(t_clock, pre_byk, delay_byk)
    hor, score = torch.empty((2, N), dtype=torch.float64,
                             device=dev).unbind(0)
    err = _horizon_launch()(
        t_clock.data_ptr(), pre_byk.data_ptr(), delay_byk.data_ptr(), K, N,
        float(t_end), float(horizon_cap), float(eps), hor.data_ptr(),
        score.data_ptr(), build.stream_ptr(dev))
    build.check(err, "horizon_score")
    build.count("horizon_score")
    return hor, score


@functools.lru_cache(maxsize=None)
def _compact_ids_launch():
    return _lib("compact").compact_ids_launch


def compact_ids_cuda(mask, cap: int):
    """mask bool[N] -> (ids i32[cap], count i32[]): the first ``cap`` set
    lanes in index order, sentinel N, and the total set-lane count.  Any
    mask offset is taken: the kernel reads the unaligned head and tail
    byte by byte."""
    if not (mask.is_cuda and mask.dtype == torch.bool and mask.dim() == 1
            and mask.is_contiguous() and cap >= 1):
        _check_mask(mask, cap)
    cap = int(cap)
    buf = torch.empty((cap + 1,), dtype=torch.int32, device=mask.device)
    ids, cnt = buf[:cap], buf[cap]
    err = _compact_ids_launch()(
        mask.data_ptr(), mask.shape[0], cap, buf.data_ptr(),
        buf.data_ptr() + 4 * cap, build.stream_ptr(mask.device))
    build.check(err, "compact_ids")
    build.count("compact_ids")
    return ids, cnt


def _check_table(mask, table):
    if table.dtype != torch.int32 or table.dim() != 2 \
            or table.shape[0] != mask.shape[-1] or not table.is_contiguous() \
            or table.device != mask.device:
        raise ValueError("table must be a contiguous int32[N, MO] on the "
                         "mask's device")


@functools.lru_cache(maxsize=None)
def _compact_gather_launch():
    return _lib("compact").compact_gather_launch


def compact_gather_cuda(mask, table, cap: int, fill: int):
    """mask bool[N], table i32[N, MO] -> (ids i32[cap], rows i32[cap, MO],
    count i32[]): ``compact_ids_cuda`` plus the table rows of the compacted
    lanes, ``fill`` in empty slots.  Any cap and any mask offset."""
    if not (mask.is_cuda and mask.dtype == torch.bool and mask.dim() == 1
            and mask.is_contiguous() and cap >= 1
            and table.dtype == torch.int32 and table.dim() == 2
            and table.shape[0] == mask.shape[0] and table.is_contiguous()
            and table.device == mask.device):
        _check_mask(mask, cap)
        _check_table(mask, table)
    dev = mask.device
    n, mo = table.shape
    cap = int(cap)
    ids = torch.empty((cap,), dtype=torch.int32, device=dev)
    rows = torch.empty((cap, mo), dtype=torch.int32, device=dev)
    cnt = torch.empty((), dtype=torch.int32, device=dev)
    err = _compact_gather_launch()(
        mask.data_ptr(), n, table.data_ptr(), mo, cap, int(fill),
        ids.data_ptr(), rows.data_ptr(), cnt.data_ptr(),
        build.stream_ptr(dev))
    build.check(err, "compact_gather")
    build.count("compact_gather")
    return ids, rows, cnt


def _check_mask_rows(mask, cap: int):
    if not mask.is_cuda or mask.dtype != torch.bool or mask.dim() != 2 \
            or not mask.is_contiguous():
        raise ValueError("mask must be a contiguous bool[T, N] CUDA tensor")
    if cap < 1:
        raise ValueError(f"cap must be at least 1, got {cap}")
    if mask.shape[0] > 65535:
        raise ValueError(f"at most 65535 rows, got {mask.shape[0]}")


@functools.lru_cache(maxsize=None)
def _compact_ids_rows_launch():
    return _lib("compact").compact_ids_rows_launch


def compact_ids_rows_cuda(mask, cap: int):
    """mask bool[T, N] -> (ids i32[T, cap], count i32[T]): ``compact_ids_cuda``
    on each row, one launch."""
    if not (mask.is_cuda and mask.dtype == torch.bool and mask.dim() == 2
            and mask.is_contiguous() and cap >= 1
            and mask.shape[0] <= 65535):
        _check_mask_rows(mask, cap)
    T, N = mask.shape
    cap = int(cap)
    ids = torch.empty((T, cap), dtype=torch.int32, device=mask.device)
    cnt = torch.empty((T,), dtype=torch.int32, device=mask.device)
    if T:
        err = _compact_ids_rows_launch()(
            mask.data_ptr(), T, N, cap, ids.data_ptr(), cnt.data_ptr(),
            build.stream_ptr(mask.device))
        build.check(err, "compact_ids_rows")
        build.count("compact_ids_rows")
    return ids, cnt


@functools.lru_cache(maxsize=None)
def _compact_gather_rows_launch():
    return _lib("compact").compact_gather_rows_launch


def compact_gather_rows_cuda(mask, table, cap: int, fill: int):
    """mask bool[T, N], table i32[N, MO] -> (ids i32[T, cap], rows i32[T,
    cap, MO], count i32[T]): ``compact_gather_cuda`` on each row against
    the one table, one launch."""
    if not (mask.is_cuda and mask.dtype == torch.bool and mask.dim() == 2
            and mask.is_contiguous() and cap >= 1
            and mask.shape[0] <= 65535 and table.dtype == torch.int32
            and table.dim() == 2 and table.shape[0] == mask.shape[1]
            and table.is_contiguous() and table.device == mask.device):
        _check_mask_rows(mask, cap)
        _check_table(mask, table)
    dev = mask.device
    T = mask.shape[0]
    n, mo = table.shape
    cap = int(cap)
    ids = torch.empty((T, cap), dtype=torch.int32, device=dev)
    rows = torch.empty((T, cap, mo), dtype=torch.int32, device=dev)
    cnt = torch.empty((T,), dtype=torch.int32, device=dev)
    if T:
        err = _compact_gather_rows_launch()(
            mask.data_ptr(), T, n, table.data_ptr(), mo, cap, int(fill),
            ids.data_ptr(), rows.data_ptr(), cnt.data_ptr(),
            build.stream_ptr(dev))
        build.check(err, "compact_gather_rows")
        build.count("compact_gather_rows")
    return ids, rows, cnt


def _check_key(key, max_rank: int):
    if not key.is_cuda or key.dtype != torch.int32 or key.dim() != 1 \
            or not key.is_contiguous():
        raise ValueError("key must be a contiguous int32[E] CUDA tensor")
    if max_rank < 0:
        raise ValueError(f"max_rank must be >= 0, got {max_rank}")


@functools.lru_cache(maxsize=None)
def _segment_rank_launch():
    return _lib("segment_rank").segment_rank_launch


def segment_rank_cuda(key, max_rank: int):
    """key i32[E] -> rank i32[E]: earlier equal keys, clipped at max_rank."""
    if not (key.is_cuda and key.dtype == torch.int32 and key.dim() == 1
            and key.is_contiguous() and max_rank >= 0):
        _check_key(key, max_rank)
    rank = torch.empty_like(key)
    err = _segment_rank_launch()(key.data_ptr(), key.shape[0], int(max_rank),
                                 rank.data_ptr(), build.stream_ptr(key.device))
    build.check(err, "segment_rank")
    build.count("segment_rank")
    return rank


def _check_rows(mask, values, cap: int):
    if not mask.is_cuda or mask.dtype != torch.bool or mask.dim() != 2:
        raise ValueError("mask must be a bool[D, M] CUDA tensor")
    if values.dtype != torch.float64 or values.shape != mask.shape \
            or values.device != mask.device:
        raise ValueError("values must be a float64[D, M] tensor on the "
                         "mask's device")
    if cap < 1:
        raise ValueError(f"cap must be at least 1, got {cap}")


@functools.lru_cache(maxsize=None)
def _compact_rows_launch():
    return _lib("compact").compact_rows_launch


def compact_rows_cuda(mask, values, cap: int):
    """mask bool[D, M], values f64[D, M] (any strides, a row broadcast to
    D included) -> (idx i32[D, cap], vals f64[D, cap], count i32[D]): each
    row's first ``cap`` kept columns in column order (sentinel M) and
    their values (0 in empty slots), and the kept count per row."""
    if not (mask.is_cuda and mask.dtype == torch.bool and mask.dim() == 2
            and values.dtype == torch.float64 and values.shape == mask.shape
            and values.device == mask.device and cap >= 1):
        _check_rows(mask, values, cap)
    D, M = mask.shape
    cap = int(cap)
    dev = mask.device
    # three allocations: one shared int32 buffer costs more in the two
    # views it needs than the allocation it saves
    idx = torch.empty((D, cap), dtype=torch.int32, device=dev)
    vals = torch.empty((D, cap), dtype=torch.float64, device=dev)
    cnt = torch.empty((D,), dtype=torch.int32, device=dev)
    if D:
        ms0, ms1 = mask.stride()
        vs0, vs1 = values.stride()
        err = _compact_rows_launch()(
            mask.data_ptr(), ms0, ms1, values.data_ptr(), vs0, vs1, D, M,
            cap, idx.data_ptr(), vals.data_ptr(), cnt.data_ptr(),
            build.stream_ptr(dev))
        build.check(err, "compact_rows")
        build.count("compact_rows")
    return idx, vals, cnt
