"""Locality-aware neuron-to-shard placement for the SPMD FAP round.

Host NumPy, a copy of ``repro.distributed.placement``: the same passes give
the same permutations, cuts and frontier statistics.

The round block-shards neurons by global id (shard of gid g = g // n_local),
so *which ids sit together* decides the communication bill: every neuron
with a cross-shard out-edge joins the notify frontier
(``sharding.shard_frontier``) and every cross-shard edge routes spike
parcels off-shard.  With uniform-random wiring every neuron is boundary —
the documented worst case — but on structured nets
(``repro_torch.core.topology``) a relabeling can place most of each neuron's
neighbourhood on its own shard.

Placement is expressed as a *permutation of neuron ids* applied before
sharding and inverted on outputs: the four execution models and the SPMD
round run completely unmodified on the permuted ids (``place_network``
keeps the grouped by-post edge layout, so the grouped queue-insert fast
paths and ``WheelSpec.auto`` hold), and ``unpermute_result`` restores the
original neuron order on the spike record — runs are event-for-event
identical to the unpermuted anchor, only cheaper to communicate.

Passes (``compute_placement(method=...)``):

``identity``
    No relabeling (the baseline the benchmarks compare against).
``block``
    Contiguous-block pass: stable-sort neurons by their topology block id
    so each locality unit maps to a contiguous id range, hence (blocks
    dividing evenly) to whole shards.  Exactly recovers native block
    locality on label-shuffled nets.
``greedy``
    Greedy edge-cut refinement on top of ``block`` (or identity when the
    net carries no block metadata): balanced pairwise swap passes — each
    neuron scores its edge count per shard, positive-gain movers between
    shard pairs are matched and swapped, keeping shard sizes exactly equal.
    A Kernighan-Lin-flavoured descent: never increases the cut.
``auto``
    ``greedy`` when block metadata exists, else ``identity``.

Cut edges are *counted, not estimated* (``cut_edges``), and the realized
frontier under a placement is measured by ``frontier_stats`` through the
same ``shard_frontier`` tables the sparse transport ships.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import shard_frontier

PLACEMENTS = ("identity", "block", "greedy", "auto")


class Placement(NamedTuple):
    """A neuron relabeling: old id g lands at new id ``perm[g]`` (and
    ``inv[perm[g]] == g``), sharded as new_id // (n // n_shards)."""
    perm: np.ndarray       # i32[N] old -> new
    inv: np.ndarray        # i32[N] new -> old
    n_shards: int
    method: str
    cut: int               # realized cross-shard edges under this placement

    @property
    def n(self) -> int:
        return int(self.perm.shape[0])


def shard_of(ids: np.ndarray, n: int, n_shards: int,
             perm: Optional[np.ndarray] = None) -> np.ndarray:
    """Shard of each (optionally relabeled) neuron id under block sharding."""
    ids = np.asarray(ids, np.int64)
    if perm is not None:
        ids = np.asarray(perm, np.int64)[ids]
    return ids // (n // n_shards)


def cut_edges(pre: np.ndarray, post: np.ndarray, n: int, n_shards: int,
              perm: Optional[np.ndarray] = None) -> int:
    """Number of edges whose endpoints land on different shards."""
    return int((shard_of(pre, n, n_shards, perm)
                != shard_of(post, n, n_shards, perm)).sum())


def _perm_from_order(order: np.ndarray):
    """order[j] = old id placed at new id j  ->  (perm, inv)."""
    inv = np.asarray(order, np.int32)
    perm = np.empty_like(inv)
    perm[inv] = np.arange(inv.shape[0], dtype=np.int32)
    return perm, inv


def from_order(order: np.ndarray, n_shards: int, net=None,
               method: str = "external") -> Placement:
    """Wrap an explicit new-id ordering (order[j] = old id at new id j) as
    a Placement; the cut is counted when the concrete net is given (e.g.
    label-shuffle permutations in benchmarks/tests)."""
    perm, inv = _perm_from_order(order)
    cut = 0 if net is None else cut_edges(np.asarray(net.pre),
                                          np.asarray(net.post), int(net.n),
                                          n_shards, perm)
    return Placement(perm=perm, inv=inv, n_shards=n_shards, method=method,
                     cut=cut)


def _greedy_refine(pre, post, assign, n_shards, passes: int = 3):
    """Balanced pairwise-swap descent on the edge cut.

    Each pass scores conn[i, s] = edges between neuron i and shard s (both
    directions), then matches positive-gain movers between shard pairs
    (i: a->b with j: b->a, best gains first) and swaps them — shard sizes
    never change.  Gains are recomputed between passes; within a pass they
    are stale after a swap (e.g. two mutually-connected movers swapped into
    each other's shard keep their shared edges cut), so the cut is
    re-counted after every pass and the best assignment seen — including
    the starting one — is returned: refinement never loses locality.
    """
    n = assign.shape[0]
    assign = assign.copy()
    pre = np.asarray(pre, np.int64)
    post = np.asarray(post, np.int64)

    def cut_of(a):
        return int((a[pre] != a[post]).sum())

    best_assign, best_cut = assign.copy(), cut_of(assign)
    for _ in range(passes):
        conn = np.zeros((n, n_shards), np.int64)
        np.add.at(conn, (pre, assign[post]), 1)
        np.add.at(conn, (post, assign[pre]), 1)
        cur = conn[np.arange(n), assign]
        best = conn.argmax(axis=1).astype(assign.dtype)
        gain = conn.max(axis=1) - cur
        movers = np.flatnonzero((best != assign) & (gain > 0))
        by_pair: dict = {}
        for i in movers:
            by_pair.setdefault((int(assign[i]), int(best[i])), []).append(i)
        swapped = 0
        for (a, b), fwd in sorted(by_pair.items()):
            if a >= b:
                continue
            rev = by_pair.get((b, a), [])
            fwd = sorted(fwd, key=lambda i: -gain[i])
            rev = sorted(rev, key=lambda i: -gain[i])
            for i, j in zip(fwd, rev):
                assign[i], assign[j] = b, a
                swapped += 1
        if not swapped:
            break
        c = cut_of(assign)
        if c < best_cut:
            best_assign, best_cut = assign.copy(), c
    return best_assign


def compute_placement(net, n_shards: int, method: str = "auto",
                      passes: int = 3) -> Placement:
    """Derive a shard placement for ``net`` (see module docstring)."""
    n = int(net.n)
    if n % n_shards:
        raise ValueError(f"n={n} not divisible by n_shards={n_shards}")
    if method not in PLACEMENTS:
        raise ValueError(f"unknown placement {method!r} "
                         f"(want one of {PLACEMENTS})")
    if method == "auto":
        method = "greedy" if net.block is not None else "identity"
    pre, post = np.asarray(net.pre), np.asarray(net.post)
    if method == "identity" or (method == "block" and net.block is None):
        order = np.arange(n, dtype=np.int32)
        method_out = "identity"
    else:
        if net.block is not None:
            order = np.argsort(np.asarray(net.block), kind="stable")
        else:
            order = np.arange(n, dtype=np.int64)
        if method == "greedy":
            perm0, _ = _perm_from_order(order)
            assign = shard_of(np.arange(n), n, n_shards, perm0)
            assign = _greedy_refine(pre, post, assign.astype(np.int32),
                                    n_shards, passes=passes)
            # contiguify: stable sort by refined shard keeps each shard's
            # neurons in block order within its id range
            order = np.argsort(assign, kind="stable")
        method_out = method
    perm, inv = _perm_from_order(order)
    cut = cut_edges(pre, post, n, n_shards, perm)
    return Placement(perm=perm, inv=inv, n_shards=n_shards,
                     method=method_out, cut=cut)


# ---------------------------------------------------------------------------
# applying / inverting a placement
# ---------------------------------------------------------------------------
def place_network(net, pl: Placement):
    """Relabel a network's neuron ids by ``pl.perm``.

    The grouped by-post layout is preserved (new neuron j's in-edge group
    is old neuron inv[j]'s group with pre relabeled), so every grouped
    fast path sees the same static structure.  Non-grouped edge lists are
    relabeled and re-sorted by new post (stable).
    """
    n, E = int(net.n), int(net.pre.shape[0])
    perm, inv = pl.perm, pl.inv
    pre = np.asarray(net.pre)
    post = np.asarray(net.post)
    block = None if net.block is None else np.asarray(net.block)[inv]
    k = E // n if E % n == 0 else 0
    grouped = k > 0 and np.array_equal(
        post, np.repeat(np.arange(n, dtype=post.dtype), k))
    if grouped:
        def regroup(a):
            return np.asarray(a).reshape(n, k)[inv].reshape(-1)
        pre2 = regroup(perm[pre])
        post2 = np.repeat(np.arange(n, dtype=post.dtype), k)
        delay2, wa2, wg2 = map(regroup, (net.delay, net.w_ampa, net.w_gaba))
    else:
        pre2, post2 = perm[pre], perm[post]
        order = np.argsort(post2, kind="stable")
        pre2, post2 = pre2[order], post2[order]
        delay2 = np.asarray(net.delay)[order]
        wa2 = np.asarray(net.w_ampa)[order]
        wg2 = np.asarray(net.w_gaba)[order]
    return net._replace(pre=pre2, post=post2, delay=delay2, w_ampa=wa2,
                        w_gaba=wg2, block=block)


def permute_dense(x, pl: Placement):
    """Per-neuron vector/rows old order -> new order (e.g. iinj)."""
    x = np.asarray(x)
    if x.ndim == 0 or x.shape[0] != pl.n:
        return x                          # scalars broadcast unchanged
    return x[pl.inv]


def unpermute_rows(x, pl: Placement):
    """Per-neuron rows of a permuted run (array or tensor) back to the
    original order."""
    if isinstance(x, torch.Tensor):
        return x[torch.as_tensor(pl.perm, dtype=torch.int64, device=x.device)]
    return x[pl.perm]


def unpermute_result(res, pl: Placement):
    """Restore original neuron order on a RunResult from a permuted run."""
    rec = res.rec._replace(times=unpermute_rows(res.rec.times, pl),
                           count=unpermute_rows(res.rec.count, pl))
    y = res.y_final
    if getattr(y, "ndim", 0) >= 1 and y.shape[0] == pl.n:
        y = unpermute_rows(y, pl)
    return res._replace(rec=rec, y_final=y)


def place_inputs(net, iinj, pl: Placement):
    """(net, iinj) relabeled for a placed run."""
    return place_network(net, pl), permute_dense(iinj, pl)


# ---------------------------------------------------------------------------
# realized-locality measurement (through the transport's own tables)
# ---------------------------------------------------------------------------
def frontier_stats(net, n_shards: int,
                   pl: Optional[Placement] = None) -> dict:
    """Measured notify-frontier statistics under an (optional) placement.

    Derived from the same ``shard_frontier`` tables the sparse transport
    ships, on the relabeled edge list: F (the padded per-shard frontier
    width that sizes the notify gather), the true per-shard boundary
    counts, the boundary fraction of N, and the cut-edge count/fraction.
    """
    n = int(net.n)
    pre, post = np.asarray(net.pre), np.asarray(net.post)
    perm = None if pl is None else pl.perm
    fr = shard_frontier(pre, post, n, n_shards, perm=perm)
    sizes = fr.sizes
    cut = cut_edges(pre, post, n, n_shards, perm)
    return {
        "F": int(fr.frontier_size),
        "sizes": sizes.astype(int).tolist(),
        "boundary_frac": float(sizes.sum() / n),
        "cut_edges": cut,
        "cut_frac": float(cut / max(1, pre.shape[0])),
    }
