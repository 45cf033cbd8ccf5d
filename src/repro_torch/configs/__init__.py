"""Architecture registry: ``get_config(name)`` / ``--arch <id>``."""
from __future__ import annotations

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, shape_applicable
from repro_torch.configs.deepseek_7b import CONFIG as deepseek_7b
from repro_torch.configs.qwen2_72b import CONFIG as qwen2_72b
from repro_torch.configs.internlm2_20b import CONFIG as internlm2_20b
from repro_torch.configs.smollm_135m import CONFIG as smollm_135m
from repro_torch.configs.arctic_480b import CONFIG as arctic_480b
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as qwen3_moe_30b_a3b
from repro_torch.configs.internvl2_1b import CONFIG as internvl2_1b
from repro_torch.configs.rwkv6_7b import CONFIG as rwkv6_7b
from repro_torch.configs.whisper_base import CONFIG as whisper_base
from repro_torch.configs.zamba2_7b import CONFIG as zamba2_7b

ARCHS = {
    c.name: c for c in [
        deepseek_7b, qwen2_72b, internlm2_20b, smollm_135m, arctic_480b,
        qwen3_moe_30b_a3b, internvl2_1b, rwkv6_7b, whisper_base, zamba2_7b,
    ]
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
