"""Plain PyTorch versions of the Hines kernels, in the ``[C, N]`` layout."""
from __future__ import annotations

from repro_torch.core import hines as core_hines


def hines_factor_ref(parent, g_axial, d):
    """d: [C, N] -> d_elim: [C, N]."""
    return core_hines.hines_factor(parent, g_axial, d.T).T


def hines_solve_factored_ref(parent, g_axial, d_elim, b):
    """d_elim, b: [C, N] -> x: [C, N]."""
    return core_hines.hines_solve_factored(parent, g_axial, d_elim.T, b.T).T


def hines_solve_ref(parent, g_axial, d, b):
    """d, b: [C, N] -> x: [C, N] (fused eliminate + solve)."""
    return core_hines.hines_solve(parent, g_axial, d.T, b.T).T
