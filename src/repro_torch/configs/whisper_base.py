"""whisper-base: enc-dec with conv frontend STUB (input_specs supplies
log-mel frame embeddings [B, 1500, d]) [arXiv:2212.04356; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865,
    enc_layers=6, enc_frames=1500,
    source="arXiv:2212.04356",
)
