"""Architecture + run configuration.

One ``ArchConfig`` per architecture (see sibling modules), field for field
the JAX package's ``repro/configs``; ``reduced()`` derives the small-CPU
smoke-test variant of the same family.  ``pdtype()``/``cdtype()`` return
torch dtypes.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1.0e4
    tie_embeddings: bool = True
    # MoE
    n_experts: int = 0
    top_k: int = 0
    dense_residual: bool = False     # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    shared_attn_every: int = 0       # zamba2: shared attn block period
    # modality stubs
    n_patches: int = 0               # vlm: prepended patch embeddings
    enc_layers: int = 0              # audio: encoder depth
    enc_frames: int = 0              # audio: encoder frame count
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # notes
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        return replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16 if self.n_heads else 0,
            d_ff=128,
            vocab=256,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16),
            shared_attn_every=2 if self.shared_attn_every else 0,
            n_patches=8 if self.n_patches else 0,
            enc_layers=min(self.enc_layers, 2),
            enc_frames=16 if self.enc_frames else 0,
            param_dtype="float32",
            compute_dtype="float32",
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: pure full-attention arch (see DESIGN.md)"
    return True, ""
