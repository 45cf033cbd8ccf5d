"""Shared building blocks for the LM zoo.

Dtype policy (as the JAX package's): parameters are stored in
``cfg.param_dtype``; matmuls take operands rounded to ``cfg.compute_dtype``
(bf16) and return float32 products.  ``mm`` computes that as a float32
GEMM of the rounded operands on every device -- a ``matmul`` of bf16
tensors would return bf16, a different function -- so TF32 must stay off
for float32 matmuls on the card.  PyTorch's default is off; it is set
here so that the model's function does not depend on a caller's setting.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False


def mm(x, w, compute_dtype=torch.bfloat16):
    """Matmul with ``compute_dtype`` inputs, float32 accumulation and
    result (``x [..., d_in] @ w [d_in, d_out]``)."""
    return torch.matmul(x.to(compute_dtype).to(torch.float32),
                        w.to(compute_dtype).to(torch.float32))


def dense_init(gen, d_in, d_out, dtype, scale=None, device="cpu"):
    """Normal(0, scale) weights drawn from ``gen``, a CPU
    ``torch.Generator`` (the same weights on every device)."""
    scale = scale if scale is not None else (d_in ** -0.5)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32) * scale
    return w.to(dtype=dtype, device=device)


def rms_norm(x, gamma, eps=1e-6):
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return x32 * torch.rsqrt(var + eps) * gamma.to(torch.float32)


def rope_tables(positions, head_dim, theta=1e4):
    """positions: int[...]; returns (cos, sin) with trailing dim
    head_dim // 2."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (idx / half))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: [..., S, H, D]; cos/sin: [..., S, D//2] (broadcast over heads)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :] if x.dim() == cos.dim() + 2 else cos
    s = sin[..., None, :] if x.dim() == sin.dim() + 2 else sin
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def swiglu(x_gate, x_up):
    return F.silu(x_gate) * x_up
