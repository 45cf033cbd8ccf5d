"""qwen3-moe-30b-a3b: 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab=151936,
    n_experts=128, top_k=8,
    source="hf:Qwen/Qwen3-30B-A3B",
)
