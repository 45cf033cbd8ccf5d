"""Static shard-frontier routing tables of the sparse spike-parcel
transport.  Host NumPy, a copy of ``ShardFrontier`` / ``shard_frontier``
from ``repro.distributed.sharding``: the tables are array-identical to the
JAX package's for the same edge list.  (The LM sharding specs of that file
belong to the LM zoo and are not ported here.)
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ShardFrontier(NamedTuple):
    """Static routing tables for the sparse exchange, one row per shard.

    boundary_rel: i32[n_shards, F] -- shard-relative indices of each shard's
        boundary neurons (local neurons with at least one cross-shard
        out-edge); pad slots hold 0 and are neutralised by the gid sentinel.
    boundary_gid: i32[n_shards, F] -- the same neurons as global ids; pad
        slots hold the sentinel ``n``.
    dest_map: bool[N, n_shards] -- dest_map[i, d] iff neuron i has at least
        one out-edge into shard d (self-shard included, so parcels
        self-deliver through the same path).
    """
    boundary_rel: np.ndarray
    boundary_gid: np.ndarray
    dest_map: np.ndarray

    @property
    def frontier_size(self) -> int:
        return int(self.boundary_rel.shape[1])

    @property
    def sizes(self) -> np.ndarray:
        """True per-shard boundary counts (pad sentinels excluded)."""
        n = int(self.dest_map.shape[0])
        return (self.boundary_gid < n).sum(axis=1)


def shard_frontier(pre: np.ndarray, post: np.ndarray, n: int,
                   n_shards: int, perm: np.ndarray = None) -> ShardFrontier:
    """Derive the per-shard cross-shard frontier from the edge list.

    Neurons are block-sharded (shard of gid g = g // n_local).  ``perm``
    (optional, from ``distributed.placement``) relabels both endpoints
    first; the tables are then in the new (placed) ids.
    """
    if n % n_shards:
        raise ValueError(f"n={n} not divisible by n_shards={n_shards}")
    n_local = n // n_shards
    pre = np.asarray(pre, np.int64)
    post = np.asarray(post, np.int64)
    if perm is not None:
        perm = np.asarray(perm, np.int64)
        pre, post = perm[pre], perm[post]
    src_shard = pre // n_local
    dst_shard = post // n_local

    dest_map = np.zeros((n, n_shards), bool)
    dest_map[pre, dst_shard] = True

    cross = src_shard != dst_shard
    bnd = np.unique(np.stack([src_shard[cross], pre[cross]], axis=1), axis=0)
    sizes = np.bincount(bnd[:, 0], minlength=n_shards) if bnd.size else \
        np.zeros(n_shards, np.int64)
    F = max(1, int(sizes.max()) if sizes.size else 1)
    boundary_gid = np.full((n_shards, F), n, np.int32)
    boundary_rel = np.zeros((n_shards, F), np.int32)
    for s in range(n_shards):
        gids = bnd[bnd[:, 0] == s, 1]
        boundary_gid[s, : len(gids)] = gids
        boundary_rel[s, : len(gids)] = gids - s * n_local
    return ShardFrontier(boundary_rel, boundary_gid, dest_map)
