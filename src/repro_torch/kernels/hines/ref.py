"""Plain PyTorch versions of the Hines kernels, in the ``[C, N]`` layout,
and the three kernels' orders on the level schedule that each tile block
derives from the tree and the warp frame is handed
(``core.hines.hines_schedule``, re-exported here): ``hines_*_sched_ref``."""
from __future__ import annotations

import torch

from repro_torch.core import hines as core_hines
from repro_torch.core.hines import HinesSchedule, hines_schedule

__all__ = ["HinesSchedule", "hines_schedule", "hines_factor_ref",
           "hines_solve_factored_ref", "hines_solve_ref",
           "hines_factor_sched_ref", "hines_solve_factored_sched_ref",
           "hines_solve_sched_ref"]


def hines_factor_ref(parent, g_axial, d):
    """d: [C, N] -> d_elim: [C, N]."""
    return core_hines.hines_factor(parent, g_axial, d.T).T


def hines_solve_factored_ref(parent, g_axial, d_elim, b):
    """d_elim, b: [C, N] -> x: [C, N]."""
    return core_hines.hines_solve_factored(parent, g_axial, d_elim.T, b.T).T


def hines_solve_ref(parent, g_axial, d, b):
    """d, b: [C, N] -> x: [C, N] (fused eliminate + solve)."""
    return core_hines.hines_solve(parent, g_axial, d.T, b.T).T


def _eliminate(sched: HinesSchedule, gax, w, x=None):
    """K1's and K3's elimination in the order of the level schedule, in
    place: deepest level first, each parent adding its children in
    descending index, each multiplier formed from the child's final row."""
    lv, nodes = sched.level_ptr, sched.nodes
    for L in range(sched.depth, 0, -1):
        for p in nodes[lv[L - 1]:lv[L]]:
            acc_w, acc_x = w[p], None if x is None else x[p]
            for i in sched.children[sched.child_ptr[p]:sched.child_ptr[p + 1]]:
                f = gax[i] / w[i]
                acc_w = acc_w + (-f * gax[i])
                if x is not None:
                    acc_x = acc_x + f * x[i]
            w[p] = acc_w
            if x is not None:
                x[p] = acc_x


def _back_substitute(sched: HinesSchedule, gax, diag, x):
    """The back substitution of K2 and K3, level by level, in place."""
    lv, nodes = sched.level_ptr, sched.nodes
    x[0] = x[0] / diag[0]
    for L in range(1, sched.depth + 1):
        for i in nodes[lv[L]:lv[L + 1]]:
            x[i] = (x[i] + gax[i] * x[sched.parent[i]]) / diag[i]


def hines_factor_sched_ref(sched: HinesSchedule, g_axial, d):
    """K1's elimination in the order of its level schedule: d [C, N] ->
    d_elim [C, N].  Each value sees the operations of
    ``core.hines.hines_factor`` in the same order, so the two are equal
    bit for bit."""
    gax = torch.as_tensor(g_axial, dtype=d.dtype, device=d.device)
    w = d.clone()
    _eliminate(sched, gax, w)
    return w


def hines_solve_factored_sched_ref(sched: HinesSchedule, g_axial, d_elim, b):
    """K2's sweeps in the order of its level schedule: d_elim, b [C, N] ->
    x [C, N].  The multipliers first; the forward sweep deepest level
    first, each parent adding its children in descending index; the back
    substitution level by level.  Each value sees the operations of
    ``core.hines.hines_solve_factored`` in the same order, so the two are
    equal bit for bit."""
    gax = torch.as_tensor(g_axial, dtype=d_elim.dtype, device=d_elim.device)
    C = d_elim.shape[0]
    x = b.clone()
    f = [None] + [gax[i] / d_elim[i] for i in range(1, C)]
    lv, nodes = sched.level_ptr, sched.nodes
    for L in range(sched.depth, 0, -1):
        for p in nodes[lv[L - 1]:lv[L]]:
            acc = x[p]
            for i in sched.children[sched.child_ptr[p]:sched.child_ptr[p + 1]]:
                acc = acc + f[i] * x[i]
            x[p] = acc
    _back_substitute(sched, gax, d_elim, x)
    return x


def hines_solve_sched_ref(sched: HinesSchedule, g_axial, d, b):
    """K3's fused solve in the order of its level schedule: d, b [C, N] ->
    x [C, N].  K1's elimination carrying the right-hand side with the same
    multipliers, then K2's back substitution on the eliminated diagonal:
    bit for bit ``core.hines.hines_solve`` and K2's model applied to K1's."""
    gax = torch.as_tensor(g_axial, dtype=d.dtype, device=d.device)
    w, x = d.clone(), b.clone()
    _eliminate(sched, gax, w, x)
    _back_substitute(sched, gax, w, x)
    return x
