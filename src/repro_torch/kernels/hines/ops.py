"""Dispatch of the Hines factor (K1), factored solve (K2) and fused solve (K3).

CPU tensors take the plain version; CUDA tensors launch the kernel, and a
kernel that cannot launch raises -- there is no fallback.  Arrays are
``[C, N]`` as in ``repro.kernels.hines.ops``.
"""
from __future__ import annotations

from repro_torch.kernels.hines import ref
from repro_torch.kernels.hines.hines import (hines_factor_cuda,
                                             hines_solve_cuda,
                                             hines_solve_factored_cuda)


def _device_type(x) -> str:
    t = x.device.type
    if t not in ("cpu", "cuda"):
        raise ValueError(f"no Hines kernel for device {x.device}")
    return t


def hines_factor(parent, g_axial, d):
    """parent i32[C], g_axial f64[C], d f64[C, N] -> d_elim f64[C, N]."""
    if _device_type(d) == "cuda":
        return hines_factor_cuda(parent, g_axial, d)
    return ref.hines_factor_ref(parent, g_axial, d)


def hines_solve_factored(parent, g_axial, d_elim, b):
    """d_elim, b f64[C, N] -> x f64[C, N]."""
    if _device_type(b) == "cuda":
        return hines_solve_factored_cuda(parent, g_axial, d_elim, b)
    return ref.hines_solve_factored_ref(parent, g_axial, d_elim, b)


def hines_solve(parent, g_axial, d, b):
    """d, b f64[C, N] -> x f64[C, N] (fused eliminate + solve)."""
    if _device_type(b) == "cuda":
        return hines_solve_cuda(parent, g_axial, d, b)
    return ref.hines_solve_ref(parent, g_axial, d, b)
