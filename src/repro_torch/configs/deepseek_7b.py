"""deepseek-7b: llama-arch dense [arXiv:2401.02954; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=102400,
    source="arXiv:2401.02954",
)
