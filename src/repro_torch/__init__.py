"""PyTorch/CUDA port of the fully-asynchronous variable-step neural simulator.

The package mirrors ``src/repro/`` (the JAX reference) module for module.
It imports ``torch`` and ``numpy`` only.  On a CUDA device the per-step
numerics and the scheduler's horizon run in hand-written kernels
(``repro_torch/csrc``); on the CPU the same entry points run the kernels'
plain PyTorch versions, which is what the parity tests use.

Every entry point takes ``device=``.  The default is ``"cuda"``, and it
raises when no card is present rather than running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point; CUDA must really be there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
