"""zamba2-7b: Mamba2 backbone + shared attention block every 6 layers
[arXiv:2411.15242; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000,
    ssm_state=64, shared_attn_every=6,
    source="arXiv:2411.15242",
)
