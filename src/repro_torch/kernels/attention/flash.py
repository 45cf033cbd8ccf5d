"""CUDA wrappers of flash attention (K10).

Replace ``repro/kernels/attention/flash.py::flash_attention_pallas`` and
its padding wrapper ``repro/kernels/attention/ops.py::flash_attention``
with four kernels in three sources in ``csrc/``, chosen by
:func:`variant` from the dtype and ``Sq * group`` (the query rows per kv
head):

* ``"f32_decode"``: float32 with ``Sq * group <= DECODE_ROWS``,
  ``flash_decode.cu``'s CUDA-core kernel: one block per (batch, kv head)
  holds the whole GQA group, so each K/V row is read once for it; long
  caches are also split over blocks (:func:`decode_splits`);
* ``"f32_prefill"``: the other float32 calls, ``flash_attention.cu``,
  register-tiled on the CUDA cores (TF32 products would not meet the
  float32 tolerance);
* ``"decode"``: bfloat16 with ``Sq * group <= DECODE_ROWS`` (every serve
  step), ``flash_decode.cu`` with ``mma.sync``, split as f32_decode;
* ``"prefill"``: the other bfloat16 calls, ``flash_prefill.cu`` with
  wgmma on the tensor cores.

q, k and v are read through their strides with 16-byte copies: the head
dimension must be contiguous and every row 16-byte aligned (the wrapper
raises otherwise), so the model's ``[B, S, H, D]`` activations and ``[B,
S, Hkv, D]`` cache slices go in as ``transpose(1, 2)`` views without a
copy.  The output is allocated ``[B, Sq, H, D]`` and returned as its ``[B,
H, Sq, D]`` view, so the model's ``transpose(1, 2)`` back is contiguous.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention.ref import geometry

_I64, _I32, _P = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128)     # the kernels' template instantiations
DECODE_ROWS = 64              # Sq * group the decode kernels take
DECODE_TILE = 64              # kv rows per tile of the decode kernels
SPLIT_MIN_TILES = 8           # decode splits kv over blocks from 512 rows
SMS = 132                     # streaming multiprocessors of an H100 SXM
_VIEWS = [_P, _I64, _I64, _I64] * 4          # q, k, v, out: pointer, strides
# kind -> (source, launcher, its argument types)
_LAUNCHERS = {
    "f32_prefill": ("flash_attention", "flash_attention_launch",
                    _VIEWS + [_I32] * 9 + [_P]),
    "f32_decode": ("flash_decode", "flash_decode_f32_launch",
                   _VIEWS + [_P] + [_I32] * 12 + [_P]),
    "prefill": ("flash_prefill", "flash_prefill_launch",
                _VIEWS + [_I32] * 10 + [_P]),
    "decode": ("flash_decode", "flash_decode_launch",
               _VIEWS + [_P] + [_I32] * 12 + [_P]),
}


def variant(dtype, Sq, group, D) -> str:
    """The K10 kernel that serves a call: ``"f32_decode"``,
    ``"f32_prefill"``, ``"decode"`` or ``"prefill"``, from the inputs'
    dtype, the query rows, the GQA group (H / Hkv) and the head size."""
    if dtype not in _CODES:
        raise ValueError(f"K10 takes float32 or bfloat16 inputs, got {dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    kind = "decode" if Sq * group <= DECODE_ROWS else "prefill"
    return f"f32_{kind}" if dtype == torch.float32 else kind


def decode_splits(B, Hkv, kv_end, splits=None) -> tuple[int, int]:
    """(splits, kv tiles per split) of both decode kernels.  By default the
    kv tiles of each (batch, kv head) are split over blocks only where the
    cache is long (``SPLIT_MIN_TILES``) and the ``B * Hkv`` blocks alone
    leave most of the card's SMs idle; ``splits`` asks for a count.  Every
    split gets at least one tile."""
    tiles = -(-kv_end // DECODE_TILE)
    if splits is None:
        splits = min(tiles, max(1, SMS // (B * Hkv))) \
            if tiles >= SPLIT_MIN_TILES else 1
    per = -(-tiles // max(1, min(int(splits), tiles)))
    return -(-tiles // per), per


def _launcher(kind):
    """The typed launcher of ``kind``'s kernel."""
    source, symbol, argtypes = _LAUNCHERS[kind]
    fn = getattr(build.load(source), symbol)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, *, causal=True, offset=None, kv_len=None,
                         out_dtype=None, splits=None):
    """q: [B, H, Sq, D]; k, v: [B, Hkv, Skv, D] -> [B, H, Sq, D].

    ``splits`` (decode kernels only) overrides :func:`decode_splits`'s
    count of kv splits over blocks.
    """
    out_dtype = out_dtype or q.dtype
    args = []
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.dim() != 4 or x.dtype != q.dtype \
                or x.device != q.device:
            raise ValueError(f"{name} must be a 4-d CUDA tensor of q's dtype "
                             f"on {q.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        st = x.stride()
        if st[3] != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous")
        args += [x.data_ptr(), *st[:3]]
    if q.dtype not in _CODES or out_dtype not in (torch.float32, q.dtype):
        raise ValueError(f"K10 takes float32 or bfloat16 inputs with a "
                         f"float32 or input-dtype output, got {q.dtype} -> "
                         f"{out_dtype}")
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} != k {tuple(k.shape)}")
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kv_len, offset = geometry(q, k, causal, offset, kv_len)
    kind = variant(q.dtype, Sq, H // Hkv, D)
    per16 = 16 // q.element_size()          # elements in 16 bytes
    if any(a % 16 if i % 4 == 0 else a % per16
           for i, a in enumerate(args)):
        raise ValueError(f"K10 reads 16-byte rows: q, k and v need 16-byte "
                         f"aligned data and strides in multiples of "
                         f"{per16} elements")
    if splits is not None and kind not in ("decode", "f32_decode"):
        raise ValueError(f"splits is for the decode kernels, not {kind}")
    out = torch.empty((B, Sq, H, D), dtype=out_dtype,
                      device=q.device).transpose(1, 2)
    if B * H * Sq == 0:
        return out
    args += [out.data_ptr(), *out.stride()[:3]]
    shape = (B, H, Hkv, Sq, Skv, D, kv_len, offset, int(causal))
    stream = build.stream_ptr(q.device)
    if kind == "f32_prefill":
        err = _launcher(kind)(*args, *shape, stream)
    elif kind == "prefill":
        err = _launcher(kind)(*args, *shape, _CODES[out_dtype], stream)
    else:
        kv_end = min(kv_len, Sq + offset) if causal else kv_len
        n, per = decode_splits(B, Hkv, kv_end, splits)
        part = None if n == 1 else torch.empty(
            B * H * Sq * n * (D + 2), dtype=torch.float32, device=q.device)
        err = _launcher(kind)(
            *args, None if part is None else build.ptr(part), *shape, n, per,
            _CODES[out_dtype], stream)
    build.check(err, f"flash_attention_{kind}")
    build.count("flash_attention")
    build.count(f"flash_attention_{kind}")
    return out
