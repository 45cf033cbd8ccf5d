"""arctic-480b: 128-expert top-2 MoE with dense residual FFN
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000,
    n_experts=128, top_k=2, dense_residual=True,
    source="hf:Snowflake/snowflake-arctic-base",
)
