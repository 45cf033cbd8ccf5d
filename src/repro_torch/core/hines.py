"""Hines solve of the quasi-tridiagonal compartmental-tree system (plain torch).

The membrane system of one neuron is ``(D - A) v = b``: D is diagonal and A
couples each compartment i to ``parent[i]`` with the symmetric off-diagonal
``-g_axial[i]``.  In Hines order (``parent[i] < i``) one child->parent
elimination sweep and one parent->child substitution sweep solve it in O(C).

Batched over a leading neuron axis: ``d``, ``b`` are ``[N, C]``.  The sweeps
are Python loops over the static compartment order, in the float operation
order of ``repro.core.hines``, so ``hines_factor`` followed by
``hines_solve_factored`` equals ``hines_solve`` bit for bit.  This module is
the reference the Hines kernels (``repro_torch.kernels.hines``) are held to.
"""
from __future__ import annotations

import torch


def _parents(parent) -> list:
    return [int(p) for p in (parent.tolist() if torch.is_tensor(parent)
                             else list(parent))]


def _gax(g_axial, like):
    # a tensor, so ``g / d`` is a true division on every device (a Python
    # float numerator would become ``reciprocal(d) * g``)
    return torch.as_tensor(g_axial, dtype=like.dtype, device=like.device)


def child_levels(parent) -> list:
    """Non-root compartments grouped by their rank among siblings:
    ``[(children, parents), ...]``, level r holding every (r+1)-th child,
    so within a level each parent appears once.  Adding level after level
    adds a parent's children in index order."""
    levels, seen = [], {}
    for i, p in enumerate(_parents(parent)[1:], start=1):
        r = seen.get(p, 0)
        seen[p] = r + 1
        if r == len(levels):
            levels.append(([], []))
        levels[r][0].append(i)
        levels[r][1].append(p)
    return levels


def hines_assemble(parent, g_axial, diag_extra):
    """Diagonal of the tree matrix: diag_extra[i] + g_ax[i] + sum_children g_ax[c].

    ``diag_extra``: ``[N, C]`` capacitive + ionic terms.  The root
    (``parent[0] == -1``) has no to-parent conductance and is skipped:
    JAX's ``.at[-1].add(0.0)`` wraps to the last row as a no-op, while
    torch's index ops would reject the -1.
    """
    gax = _gax(g_axial, diag_extra)
    return diag_extra + gax + axial_contrib(parent, gax)


def axial_contrib(parent, g_axial):
    """Each child's axial conductance summed onto its parent, f64[C], added
    level by level (``child_levels``): no atomics, children in index
    order, so every device gives the same sums."""
    contrib = torch.zeros_like(g_axial)
    for c, p in child_levels(parent):
        contrib[p] = contrib[p] + g_axial[c]
    return contrib


def hines_solve(parent, g_axial, d, b):
    """Solve the Hines-ordered tree systems; returns v with (D-A)v = b.

    parent: int[C] (parent[0] == -1), g_axial: f64[C] (to-parent
    conductance), d: f64[N, C] assembled diagonals, b: f64[N, C].
    """
    par, gax = _parents(parent), _gax(g_axial, d)
    C = d.shape[-1]
    dd, bb = d.clone(), b.clone()
    for idx in range(C - 1, 0, -1):
        p = par[idx]
        f = gax[idx] / dd[:, idx]
        dd[:, p] = dd[:, p] + (-f * gax[idx])
        bb[:, p] = bb[:, p] + f * bb[:, idx]
    v = torch.zeros_like(bb)
    v[:, 0] = bb[:, 0] / dd[:, 0]
    for i in range(1, C):
        v[:, i] = (bb[:, i] + gax[i] * v[:, par[i]]) / dd[:, i]
    return v


def hines_factor(parent, g_axial, d):
    """Forward-eliminate the assembled diagonals; returns ``d_elim`` [N, C].

    The elimination updates the diagonal independently of the right-hand
    side, so ``d_elim`` with ``g_axial`` is an LU-style factor of the tree
    matrix, reused by :func:`hines_solve_factored`.
    """
    par, gax = _parents(parent), _gax(g_axial, d)
    C = d.shape[-1]
    dd = d.clone()
    for idx in range(C - 1, 0, -1):
        p = par[idx]
        f = gax[idx] / dd[:, idx]
        dd[:, p] = dd[:, p] + (-f * gax[idx])
    return dd


def hines_solve_factored(parent, g_axial, d_elim, b):
    """Solve ``(D - A) v = b`` from a stored :func:`hines_factor` result.

    Two O(C) sweeps with the same value sequence on ``b`` as
    :func:`hines_solve`, so factor + factored solve == fused solve bitwise.
    """
    par, gax = _parents(parent), _gax(g_axial, d_elim)
    C = d_elim.shape[-1]
    bb = b.clone()
    for idx in range(C - 1, 0, -1):
        p = par[idx]
        f = gax[idx] / d_elim[:, idx]
        bb[:, p] = bb[:, p] + f * bb[:, idx]
    v = torch.zeros_like(bb)
    v[:, 0] = bb[:, 0] / d_elim[:, 0]
    for i in range(1, C):
        v[:, i] = (bb[:, i] + gax[i] * v[:, par[i]]) / d_elim[:, i]
    return v


def dense_tree_matrix(parent, g_axial, diag_extra):
    """Materialise the dense matrices ``[N, C, C]`` (test oracle only)."""
    par = torch.as_tensor(parent, device=diag_extra.device).long()
    gax = torch.as_tensor(g_axial, dtype=diag_extra.dtype,
                          device=diag_extra.device)
    C = diag_extra.shape[-1]
    d = hines_assemble(par, gax, diag_extra)
    mat = torch.diag_embed(d)
    rows = torch.arange(1, C, device=d.device)
    cols = par[1:]
    mat[:, rows, cols] -= gax[1:]
    mat[:, cols, rows] -= gax[1:]
    return mat
