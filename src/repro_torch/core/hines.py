"""Hines solve of the quasi-tridiagonal compartmental-tree system (plain torch).

The membrane system of one neuron is ``(D - A) v = b``: D is diagonal and A
couples each compartment i to ``parent[i]`` with the symmetric off-diagonal
``-g_axial[i]``.  In Hines order (``parent[i] < i``) one child->parent
elimination sweep and one parent->child substitution sweep solve it in O(C).

Batched over a leading neuron axis: ``d``, ``b`` are ``[N, C]``.  Each
value sees the float operations of ``repro.core.hines``'s sequential loops
over the compartments in the same order, so ``hines_factor`` followed by
``hines_solve_factored`` equals ``hines_solve`` bit for bit; the loops run
over batches of compartments that do not depend on each other (the tree's
depths, and siblings by rank, ``tree_sweeps``), about 2 D + its
branchings of them for a tree of depth D instead of C, so a
reconstructed-size cell (C = 1021) solves on the CPU in about 40 steps.
This module is the reference the Hines kernels (``repro_torch.kernels
.hines``) are held to.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

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


@dataclass(frozen=True)
class HinesSchedule:
    """The level schedule of one Hines-ordered tree, as the sweeps walk it.

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
    par = _parents(parent)
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


class Sweeps(NamedTuple):
    """A tree's level schedule and the tensors on one device that walk it.
    ``elim``: the child -> parent elimination, deepest depth first and
    within a depth by each child's rank among its siblings, as (children,
    parents) index pairs in which a parent appears at most once, so adding
    batch after batch adds each parent's children in the order of the
    sequential loop, each from its final row.  ``back``: the substitution,
    depth by depth from 1, (compartments, parents).  ``words``: the
    schedule as the Hines kernels' warp frame reads it (``warp_words``),
    int32 on the device."""
    schedule: HinesSchedule
    elim: list
    back: list
    words: torch.Tensor


def warp_words(s: HinesSchedule) -> list:
    """The schedule in the form the warp frame of ``csrc/hines.cu`` reads,
    one shared-memory read per step of a lane, as int32 words:

    - a header ``[F, M, D, n]``: F parents (compartments with children), M
      words of ``more``, the deepest depth D, and n words in all (a
      multiple of 4, so the entries stay 16-byte aligned);
    - F forward entries ``(p, c0, c1, m)``, the parents by depth and index:
      p's children in descending index are c0, then c1 (-1: none), then,
      where m >= 0, the ``more[m]`` children ``more[m + 1:...]``;
    - C back entries ``(i, parent[i])``, the compartments by depth and
      index (the root's parent is -1);
    - ``more``; ``fptr`` (D + 1): the parents at depth L are the forward
      entries ``fptr[L]:fptr[L + 1]``; ``lvl`` (D + 2): depth L's
      compartments are the back entries ``lvl[L]:lvl[L + 1]``;
    - zeros up to n, at most 8 C + 4 (a chain's)."""
    lv, nodes, cptr, kids = s.level_ptr, s.nodes, s.child_ptr, s.children
    fwd, more, fptr = [], [], [0]
    for L in range(s.depth):
        for p in nodes[lv[L]:lv[L + 1]]:
            ch = list(kids[cptr[p]:cptr[p + 1]])
            if ch:
                m = -1 if len(ch) < 3 else len(more)
                if m >= 0:
                    more += [len(ch) - 2] + ch[2:]
                fwd += [p, ch[0], ch[1] if len(ch) > 1 else -1, m]
        fptr.append(len(fwd) // 4)
    back = [w for i in nodes for w in (i, s.parent[i])]
    body = fwd + back + more + fptr + list(lv)
    n = -(-(4 + len(body)) // 4) * 4
    return [len(fwd) // 4, len(more), s.depth, n] + body \
        + [0] * (n - 4 - len(body))


@functools.lru_cache(maxsize=64)
def tree_sweeps(par: tuple, device: str) -> Sweeps:
    """The sweeps of the tree ``par`` (a tuple in Hines order) on
    ``device``, built once per tree and device."""
    s = hines_schedule(par)
    lv, nodes, cptr = s.level_ptr, s.nodes, s.child_ptr

    def idx(xs, dtype=torch.int64):
        return torch.tensor(xs, dtype=dtype, device=device)

    elim = []
    for L in range(s.depth, 0, -1):
        ranks: list = []
        for p in nodes[lv[L - 1]:lv[L]]:
            for r, i in enumerate(s.children[cptr[p]:cptr[p + 1]]):
                if r == len(ranks):
                    ranks.append(([], []))
                ranks[r][0].append(i)
                ranks[r][1].append(p)
        elim += [(idx(c), idx(p)) for c, p in ranks]
    back = [(idx(nodes[lv[L]:lv[L + 1]]),
             idx([par[i] for i in nodes[lv[L]:lv[L + 1]]]))
            for L in range(1, s.depth + 1)]
    words = idx(warp_words(s), torch.int32)
    return Sweeps(s, elim, back, words)


def _batches(parent, like):
    sw = tree_sweeps(tuple(_parents(parent)), str(like.device))
    return sw.elim, sw.back


def _eliminate(elim, gax, dd, bb=None):
    """The child -> parent elimination, in place, batch by batch."""
    for c, p in elim:
        f = gax[c] / dd[:, c]
        dd[:, p] = dd[:, p] + (-f * gax[c])
        if bb is not None:
            bb[:, p] = bb[:, p] + f * bb[:, c]


def _forward(elim, gax, d_elim, bb):
    """K2's forward sweep on a factored diagonal, in place."""
    for c, p in elim:
        f = gax[c] / d_elim[:, c]
        bb[:, p] = bb[:, p] + f * bb[:, c]


def _back_substitute(back, gax, dd, bb):
    v = torch.zeros_like(bb)
    v[:, 0] = bb[:, 0] / dd[:, 0]
    for i, p in back:
        v[:, i] = (bb[:, i] + gax[i] * v[:, p]) / dd[:, i]
    return v


def hines_solve(parent, g_axial, d, b):
    """Solve the Hines-ordered tree systems; returns v with (D-A)v = b.

    parent: int[C] (parent[0] == -1), g_axial: f64[C] (to-parent
    conductance), d: f64[N, C] assembled diagonals, b: f64[N, C].
    """
    elim, back = _batches(parent, d)
    gax = _gax(g_axial, d)
    dd, bb = d.clone(), b.clone()
    _eliminate(elim, gax, dd, bb)
    return _back_substitute(back, gax, dd, bb)


def hines_factor(parent, g_axial, d):
    """Forward-eliminate the assembled diagonals; returns ``d_elim`` [N, C].

    The elimination updates the diagonal independently of the right-hand
    side, so ``d_elim`` with ``g_axial`` is an LU-style factor of the tree
    matrix, reused by :func:`hines_solve_factored`.
    """
    elim, _ = _batches(parent, d)
    dd = d.clone()
    _eliminate(elim, _gax(g_axial, d), dd)
    return dd


def hines_solve_factored(parent, g_axial, d_elim, b):
    """Solve ``(D - A) v = b`` from a stored :func:`hines_factor` result.

    Two O(C) sweeps with the same value sequence on ``b`` as
    :func:`hines_solve`, so factor + factored solve == fused solve bitwise.
    """
    elim, back = _batches(parent, d_elim)
    gax = _gax(g_axial, d_elim)
    bb = b.clone()
    _forward(elim, gax, d_elim, bb)
    return _back_substitute(back, gax, d_elim, bb)


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
