"""Which of flash attention's (K10's) four CUDA kernels serves a call, on
the CPU.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 15); here the plain functions around them are held
to their contract: ``flash.variant`` picks the kernel from (dtype, Sq,
group, D) -- for float32 and for bf16 a decode kernel for at most
``DECODE_ROWS`` query rows per kv head and a prefill kernel above it;
``flash.decode_splits`` splits only long caches and gives every split a
tile; the launch counters count each call and its kernel; the wrapper
refuses views whose rows are not 16-byte aligned before any launch; and
the geometry refusals of ``ref.geometry`` are those of the JAX reference's
callers.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels.attention import flash, ops, ref

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("dtype,Sq,group,D,want", [
    (F32, 1, 3, 64, "f32_decode"),
    (F32, 2048, 3, 64, "f32_prefill"),
    (F32, 1, 1, 16, "f32_decode"),
    (F32, 7, 8, 128, "f32_decode"),
    (BF16, 1, 3, 64, "decode"),        # smollm-135m's serve step
    (BF16, 1, 8, 128, "decode"),       # qwen2-72b's decode step
    (BF16, 1, 64, 128, "decode"),      # 64 rows, the decode block's most
    (BF16, 8, 8, 16, "decode"),
    (BF16, 21, 3, 64, "decode"),       # 63 rows
    (BF16, 22, 3, 64, "prefill"),      # 66 rows
    (BF16, 65, 1, 64, "prefill"),
    (BF16, 2048, 3, 64, "prefill"),    # smollm-135m's 4 x 2048 prefill
    (BF16, 37, 3, 16, "prefill"),
    (BF16, 1, 65, 128, "prefill"),     # a group beyond the decode block
])
def test_variant_choice(dtype, Sq, group, D, want):
    assert flash.variant(dtype, Sq, group, D) == want


@pytest.mark.parametrize("dtype,prefix", [(F32, "f32_"), (BF16, "")])
@pytest.mark.parametrize("Sq,group,rows", [
    (1, 64, "decode"), (64, 1, "decode"), (8, 8, "decode"),
    (32, 2, "decode"), (21, 3, "decode"),        # 64, 64, 64, 64, 63 rows
    (1, 65, "prefill"), (65, 1, "prefill"), (33, 2, "prefill"),
    (22, 3, "prefill"), (2048, 3, "prefill"),    # 65, 65, 66, 66, 6144
])
@pytest.mark.parametrize("D", [16, 64, 128])
def test_variant_routes_on_rows_per_kv_head(dtype, prefix, Sq, group, rows,
                                            D):
    """Both dtypes take their decode kernel up to ``DECODE_ROWS`` = 64 query
    rows per kv head (Sq * group) and their prefill kernel above it."""
    assert flash.variant(dtype, Sq, group, D) == prefix + rows


@pytest.mark.parametrize("dtype,D", [(torch.float16, 64), (torch.float64, 64),
                                     (BF16, 32), (F32, 96)])
def test_variant_refuses_what_no_kernel_takes(dtype, D):
    with pytest.raises(ValueError):
        flash.variant(dtype, 1, 1, D)


@pytest.mark.parametrize("arch,reduced,compute,Sq,want", [
    ("smollm-135m", False, "bfloat16", 1, "decode"),
    ("smollm-135m", False, "bfloat16", 2048, "prefill"),
    ("smollm-135m", True, "bfloat16", 1, "decode"),
    ("smollm-135m", True, "bfloat16", 40, "prefill"),
    ("smollm-135m", True, "float32", 1, "f32_decode"),
    ("smollm-135m", True, "float32", 40, "f32_prefill"),
    ("smollm-135m", False, "float32", 2048, "f32_prefill"),
    ("qwen2-72b", False, "bfloat16", 1, "decode"),
    ("deepseek-7b", False, "bfloat16", 2048, "prefill"),
])
def test_model_paths_choose_their_kernels(arch, reduced, compute, Sq, want):
    """The LM zoo's heads: the serve step takes a decode kernel, a long
    prompt a prefill kernel, float32 compute the CUDA-core kernels."""
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    group = cfg.n_heads // cfg.n_kv_heads
    assert flash.variant(getattr(torch, compute), Sq, group, cfg.hd) == want


@pytest.mark.parametrize("B,Hkv,kv_end,want", [
    (4, 3, 1, (1, 1)),
    (4, 3, 256, (1, 4)),          # the serve step: one block per kv head
    (4, 3, 448, (1, 7)),
    (4, 3, 449, (8, 1)),          # from 8 tiles on: one tile per split
    (4, 3, 4096, (11, 6)),
    (2, 2, 4096, (32, 2)),
    (64, 8, 4096, (1, 64)),       # 512 blocks fill the card alone
])
def test_decode_splits(B, Hkv, kv_end, want):
    assert flash.decode_splits(B, Hkv, kv_end) == want


@pytest.mark.parametrize("B,Hkv,kv_end,want", [
    (3, 2, 1, (1, 1)),            # the reduced serve path's float32 steps
    (3, 2, 23, (1, 1)),
    (3, 2, 48, (1, 1)),
    (4, 3, 4096, (11, 6)),        # smollm-135m's heads at a 4096-row cache
    (2, 2, 4096, (32, 2)),        # the card test's float32 split geometry
    (1, 1, 4096, (64, 1)),
    (2, 8, 4096, (8, 8)),         # qwen2-72b's kv heads
])
def test_decode_splits_float32_geometries(B, Hkv, kv_end, want):
    """The float32 decode kernel splits its kv tiles as the bf16 one does:
    the split count depends on (B, Hkv, kv_end) alone."""
    assert flash.decode_splits(B, Hkv, kv_end) == want


@pytest.mark.parametrize("splits", [None, 1, 2, 3, 7, 64, 1000])
def test_decode_splits_cover_every_tile_once(splits):
    for B, Hkv in ((1, 1), (4, 3), (2, 8)):
        for kv_end in (1, 63, 64, 65, 255, 512, 4095, 4096, 9999):
            n, per = flash.decode_splits(B, Hkv, kv_end, splits)
            tiles = -(-kv_end // flash.DECODE_TILE)
            assert n >= 1 and per >= 1
            assert (n - 1) * per < tiles <= n * per, (B, Hkv, kv_end)


def test_launch_counters_name_each_kernel():
    build.reset_launches()
    kernels = [f"flash_attention_{k}"
               for k in ("f32_decode", "f32_prefill", "prefill", "decode")]
    assert all(build.launches()[k] == 0 for k in ["flash_attention"] +
               kernels)
    build.count("flash_attention_decode")
    assert build.launches()["flash_attention_decode"] == 1
    build.reset_launches()
    assert build.launches()["flash_attention_decode"] == 0
    assert {"flash_attention", "flash_prefill",
            "flash_decode"} <= set(build.SOURCES)


class _CudaView:
    """A CPU tensor that reports itself as a CUDA tensor, so the wrapper's
    checks run on a machine without a card; the test stops it at the
    output's allocation, before any launch."""
    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self.t, self.dtype, self.shape = t, t.dtype, t.shape

    def dim(self):
        return self.t.dim()

    def stride(self):
        return self.t.stride()

    def data_ptr(self):
        return self.t.data_ptr()

    def element_size(self):
        return self.t.element_size()


class _Allocated(Exception):
    pass


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("Sq", [1, 80])              # a decode, a prefill
@pytest.mark.parametrize("row,aligned", [
    (72, True), (64, True),                          # aligned views
    ("off", False),                                  # data one value off
    (66, False), (68, None),                         # rows 66 / 68 apart
])
def test_wrapper_refuses_misaligned_views(monkeypatch, dtype, Sq, row,
                                          aligned):
    """q, k and v are read with 16-byte copies: a view whose data is not
    16-byte aligned, or whose rows are not a multiple of 16 bytes apart,
    raises ValueError before any launch, in float32 as in bf16."""
    def no_alloc(*a, **k):
        raise _Allocated

    monkeypatch.setattr(flash.torch, "empty", no_alloc)
    if aligned is None:              # 68 floats are 16-byte rows, 68 bf16 not
        aligned = dtype == F32
    wide = torch.zeros((1, 80, 2, 72 if row == "off" else row), dtype=dtype)
    qv = (wide[..., 1:65] if row == "off" else wide[..., :64])[:, :Sq]
    k = torch.zeros((1, 80, 1, 64), dtype=dtype).transpose(1, 2)
    q = _CudaView(qv.transpose(1, 2))
    kind = flash.variant(dtype, Sq, 2, 64)
    assert kind == ("f32_" if dtype == F32 else "") + \
        ("decode" if Sq == 1 else "prefill")
    build.reset_launches()
    with pytest.raises(_Allocated if aligned else ValueError,
                       match=None if aligned else "16-byte"):
        flash.flash_attention_cuda(q, _CudaView(k), _CudaView(k))
    assert build.launches()["flash_attention"] == 0


def _qkv(B=1, H=4, Hkv=2, Sq=4, Skv=100, D=16):
    g = torch.Generator().manual_seed(0)
    return (torch.randn((B, H, Sq, D), generator=g),
            torch.randn((B, Hkv, Skv, D), generator=g),
            torch.randn((B, Hkv, Skv, D), generator=g))


@pytest.mark.parametrize("shapes,kw,match", [
    (dict(), dict(kv_len=0), "kv_len"),
    (dict(), dict(kv_len=101), "kv_len"),
    (dict(), dict(offset=-1), "offset"),
    (dict(Sq=101), dict(), "offset"),          # more queries than columns
    (dict(H=3), dict(), "GQA"),                # H not a multiple of Hkv
])
def test_geometry_refusals_unchanged(shapes, kw, match):
    q, k, v = _qkv(**shapes)
    with pytest.raises(ValueError, match=match):
        ref.geometry(q, k, True, kw.get("offset"), kw.get("kv_len"))
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, v, causal=True, **kw)


def test_geometry_defaults_and_bidirectional():
    q, k, _ = _qkv(Sq=4, Skv=100)
    assert ref.geometry(q, k) == (100, 96)
    assert ref.geometry(q, k, kv_len=37) == (37, 33)
    # without the causal mask a negative offset leaves every row columns
    assert ref.geometry(q, k, causal=False, offset=-5, kv_len=3) == (3, -5)
    with pytest.raises(ValueError, match="GQA"):
        ref.geometry(q, k[..., :8])
