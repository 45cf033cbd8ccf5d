"""Plain PyTorch versions of the Hines kernels, in the ``[C, N]`` layout,
a model of the level schedule that each block of the kernels derives from
the tree (``hines_schedule``), and the three kernels' orders on it
(``hines_*_sched_ref``)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

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


@dataclass(frozen=True)
class HinesSchedule:
    """The level schedule of one Hines-ordered tree, as the kernels walk it.

    ``nodes`` lists the compartments by depth (the root alone at depth 0),
    ascending within a depth; depth L holds ``nodes[level_ptr[L]:
    level_ptr[L + 1]]``.  ``children[child_ptr[p]:child_ptr[p + 1]]`` are
    p's children in descending index, the order in which the sequential
    forward sweep adds them."""
    parent: tuple
    depth: int
    level_ptr: tuple
    nodes: tuple
    child_ptr: tuple
    children: tuple


def hines_schedule(parent) -> HinesSchedule:
    """The level schedule of a tree given in Hines order (parent[i] < i)."""
    par = [int(p) for p in parent]
    C = len(par)
    if C < 1 or par[0] >= 0 or any(not 0 <= par[i] < i for i in range(1, C)):
        raise ValueError("parent must be in Hines order: parent[0] < 0 and "
                         "0 <= parent[i] < i")
    depth = [0] * C
    for i in range(1, C):
        depth[i] = depth[par[i]] + 1
    D = max(depth)
    nodes = sorted(range(C), key=lambda i: (depth[i], i))
    level_ptr = [0] * (D + 2)
    for i in range(C):
        level_ptr[depth[i] + 1] += 1
    for L in range(D + 1):
        level_ptr[L + 1] += level_ptr[L]
    kids = [[] for _ in range(C)]
    for i in range(C - 1, 0, -1):
        kids[par[i]].append(i)
    child_ptr = [0]
    for p in range(C):
        child_ptr.append(child_ptr[-1] + len(kids[p]))
    return HinesSchedule(tuple(par), D, tuple(level_ptr), tuple(nodes),
                         tuple(child_ptr), tuple(c for k in kids for c in k))


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
