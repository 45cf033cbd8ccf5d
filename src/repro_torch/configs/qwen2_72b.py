"""qwen2-72b: dense GQA (kv=8) with QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, qkv_bias=True,
    source="arXiv:2407.10671",
)
