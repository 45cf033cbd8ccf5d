"""Plain PyTorch versions of the Hines kernels, in the ``[C, N]`` layout,
and a model of the level schedule that K2's kernel derives from the tree
(``hines_schedule``)."""
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
    """K2's level schedule of one Hines-ordered tree.

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
    x[0] = x[0] / d_elim[0]
    for L in range(1, sched.depth + 1):
        for i in nodes[lv[L]:lv[L + 1]]:
            x[i] = (x[i] + gax[i] * x[sched.parent[i]]) / d_elim[i]
    return x
