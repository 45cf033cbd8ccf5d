"""internvl2-1b: InternViT (stub patch embeds) + InternLM2 backbone
[arXiv:2404.16821; hf].  VLM frontend is a STUB per the assignment:
input_specs supplies precomputed patch embeddings [B, 256, d]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151655,
    n_patches=256,
    source="arXiv:2404.16821",
)
