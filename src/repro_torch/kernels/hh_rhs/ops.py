"""Dispatch of the fused HH right-hand side (K4).

CPU tensors take the plain version; CUDA tensors launch the kernel, and a
kernel that cannot launch raises -- there is no fallback.
"""
from __future__ import annotations

from repro_torch.kernels.hh_rhs import ref
from repro_torch.kernels.hh_rhs.hh_rhs import hh_rhs_cuda


def hh_rhs(area, v, m, h, n):
    """area [C]; v, m, h, n [N, C] -> (dm, dh, dn, i_ion, g_tot) [N, C]."""
    if v.device.type == "cuda":
        return hh_rhs_cuda(area, v, m, h, n)
    if v.device.type == "cpu":
        return ref.hh_rhs_ref(area, v, m, h, n)
    raise ValueError(f"no HH-RHS kernel for device {v.device}")
