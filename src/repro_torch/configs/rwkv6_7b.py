"""rwkv6-7b "Finch": attention-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=14336, vocab=65536,
    source="arXiv:2404.05892",
)
