"""Which of flash attention's (K10's) three CUDA kernels serves a call, on
the CPU.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 15); here the plain functions around them are held
to their contract: ``flash.variant`` picks the kernel from (dtype, Sq,
group, D) -- float32 on the CUDA cores, bf16 decode for at most
``DECODE_ROWS`` query rows per kv head, bf16 prefill above it;
``flash.decode_splits`` splits only long caches and gives every split a
tile; the launch counters count each call and its kernel; and the geometry
refusals of ``ref.geometry`` are those of the JAX reference's callers.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels.attention import flash, ops, ref

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("dtype,Sq,group,D,want", [
    (F32, 1, 3, 64, "f32"),
    (F32, 2048, 3, 64, "f32"),
    (F32, 1, 1, 16, "f32"),
    (F32, 7, 8, 128, "f32"),
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
    ("smollm-135m", True, "float32", 1, "f32"),
    ("qwen2-72b", False, "bfloat16", 1, "decode"),
    ("deepseek-7b", False, "bfloat16", 2048, "prefill"),
])
def test_model_paths_choose_their_kernels(arch, reduced, compute, Sq, want):
    """The LM zoo's heads: the serve step takes the decode kernel, a long
    prompt the prefill kernel, float32 compute the CUDA-core kernel."""
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
    kernels = [f"flash_attention_{k}" for k in ("f32", "prefill", "decode")]
    assert all(build.launches()[k] == 0 for k in ["flash_attention"] +
               kernels)
    build.count("flash_attention_decode")
    assert build.launches()["flash_attention_decode"] == 1
    build.reset_launches()
    assert build.launches()["flash_attention_decode"] == 0
    assert {"flash_attention", "flash_prefill",
            "flash_decode"} <= set(build.SOURCES)


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
