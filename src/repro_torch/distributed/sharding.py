"""Sharding rules of the LM zoo and the shard-frontier routing tables
of the sparse spike-parcel transport (``repro/distributed/sharding.py``).

**LM specs** -- the scheme of the JAX package's rules, copied:
  * TP: attention/FFN output features, the MoE expert dim and the vocab
    over ``model``;
  * FSDP: the complementary feature dim over ('pod', 'data') (ZeRO-3; the
    AdamW moments shard identically);
  * SP: the residual stream's sequence dim over ``model`` between layers
    (``distributed/ctx.py``);
  * batch over ('pod', 'data'); decode caches' sequence dim over ``model``.

The rules are name-based over the parameter tree; anything unmatched
replicates.  ``P`` is the port's ``PartitionSpec``: a tuple with one entry
per dim, each an axis name, a tuple of names or ``None``.  The JAX
package stacks layers ``[L, ...]`` under ``layers``, ``enc`` and ``dec``
and gives them a leading ``None``; the port keeps one dict per layer, so
a port leaf's spec is JAX's spec of the stacked leaf without that entry
(``_leaf_spec`` checks a rule against the stacked rank, as JAX does).
Decode states are stacked in both packages and map one to one.  In place
of ``to_named`` (``NamedSharding``), ``shard_shape`` and ``shard_bytes``
reckon a device's shard from a ``launch.mesh.Mesh``; the dry run
(``launch/dryrun.py``) reads them.

**Routing tables** -- host NumPy, a copy of ``ShardFrontier`` /
``shard_frontier``: array-identical to the JAX package's for the same
edge list.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
from torch.utils._pytree import (MappingKey, tree_flatten, tree_map,
                                 tree_map_with_path)

from repro_torch.configs.base import ArchConfig, ShapeConfig


class P(tuple):
    """PartitionSpec: ``P(*entries)``, one entry per leading dim (an axis
    name, a tuple of axis names or ``None``); missing trailing entries
    replicate.  A one-name tuple is stored as the name, as JAX stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and
                                     len(e) == 1 else e for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _is_spec(x) -> bool:
    return isinstance(x, P)


# parameter-name classes
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "cm_k", "w_in", "w1",
        "w_lora_a", "wr", "wg", "cm_r"}          # [d_in, d_out]: shard d_out
_ROW = {"wo", "w_down", "cm_v", "w2", "w_out", "w_lora_b", "wv_rwkv"}
_EMB = {"emb", "enc_pos"}
_MOE_COL = {"w_gate", "w_up"}                     # under "moe": [E, d, ff]
_MOE_ROW = {"w_down"}                             # under "moe": [E, ff, d]
_REPL_SMALL = {"ln1", "ln2", "ln", "lnx", "ln_f", "ln_x", "ln_y", "b1", "b2",
               "bx", "bn_f", "bq", "bk", "bv", "conv_b", "A_log", "D",
               "dt_bias", "w_bias", "bonus_u", "mu_r", "mu_k", "mu_v", "mu_w",
               "mu_g", "mu_ck", "mu_cr", "router", "conv_w", "patch_proj"}
STACKED = ("layers", "dec", "enc")     # one dict per layer in the port


def mesh_axes(mesh) -> Tuple[tuple, str]:
    dp = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    return dp, "model"


def _names(path):
    return [p.key for p in path if isinstance(p, MappingKey)]


def _leaf_spec(path, leaf, dp, tp) -> P:
    """JAX's rule of the leaf at ``path``, for the port's leaf: for a
    per-layer leaf the rule is checked against the stacked rank (one more
    than the port's) and the stacked leading ``None`` is left out."""
    names = _names(path)
    name = names[-1] if names else ""
    in_moe = "moe" in names
    stacked = any(n in STACKED for n in names)
    nd = leaf.dim() + (1 if stacked else 0)       # JAX's rank of the leaf
    pre = (None,) if stacked else ()

    def spec(*dims):
        full = pre + dims
        if len(full) != nd:
            return P()                            # fallback: replicate
        return P(*dims)

    if in_moe and name in _MOE_COL:
        return spec(tp, dp, None)
    if in_moe and name in _MOE_ROW:
        return spec(tp, None, dp)
    if name == "router":
        return spec(dp, None)
    if name in _EMB:
        return P(tp, dp)
    if name in _COL:
        return spec(dp, tp)
    if name in _ROW:
        return spec(tp, dp)
    if name in ("wq", "wk", "wv", "wo"):
        return spec(dp, tp)
    return P()                                     # norms, biases, scalars


def param_specs(cfg: ArchConfig, params_tree, mesh):
    """A ``P`` tree matching a params (or grads / AdamW moment) tree of
    tensors (``meta`` ones included)."""
    dp, tp = mesh_axes(mesh)
    return tree_map_with_path(lambda path, leaf: _leaf_spec(path, leaf, dp,
                                                            tp),
                              params_tree)


def opt_specs(cfg: ArchConfig, opt_state, mesh):
    """AdamWState(step, mu, nu): the moments shard like the parameters."""
    from repro_torch.optim import AdamWState
    return AdamWState(step=P(), mu=param_specs(cfg, opt_state.mu, mesh),
                      nu=param_specs(cfg, opt_state.nu, mesh))


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """Input shardings of a train/prefill batch dict."""
    dp, tp = mesh_axes(mesh)
    specs = {"tokens": P(dp, None), "labels": P(dp, None)}
    if cfg.family == "audio":
        specs["frames"] = P(dp, None, None)
    if cfg.family == "vlm":
        specs["patches"] = P(dp, None, None)
    return specs


def _batch_dim(shape: ShapeConfig, mesh, dp):
    ndp = int(np.prod([mesh.shape[a] for a in dp]))
    return dp if shape.global_batch >= ndp else None   # tiny batches replicate


def decode_state_specs(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """Shardings of the decode cache / recurrent state (stacked ``[L,
    ...]`` in both packages)."""
    dp, tp = mesh_axes(mesh)
    bdim = _batch_dim(shape, mesh, dp)
    if cfg.family in ("dense", "vlm", "moe"):
        # [L, B, S, Hkv, hd]: sequence over model (SP decode)
        kv = P(None, bdim, tp, None, None)
        return {"k": kv, "v": kv}
    if cfg.family == "ssm":
        return {"tm_x": P(None, bdim, tp), "cm_x": P(None, bdim, tp),
                "S": P(None, bdim, tp, None, None)}
    if cfg.family == "hybrid":
        kv = P(None, bdim, tp, None, None)
        return {"conv": P(None, bdim, None, tp),
                "h": P(None, bdim, tp, None, None), "k": kv, "v": kv}
    if cfg.family == "audio":
        kv = P(None, bdim, tp, None, None)
        return {"k": kv, "v": kv, "ek": P(None, bdim, None, None, None),
                "ev": P(None, bdim, None, None, None)}
    raise ValueError(cfg.family)


def token_spec(cfg: ArchConfig, shape: ShapeConfig, mesh) -> P:
    dp, _ = mesh_axes(mesh)
    return P(_batch_dim(shape, mesh, dp), None)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _fit_one(spec: P, shape, mesh) -> P:
    """Drop axis assignments whose size does not divide the dim (e.g.
    vocab = 151655 against 16), as jit's ``in_shardings`` require."""
    if len(spec) > len(shape):
        return P()
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) -
                                                          len(spec))):
        if entry is None:
            out.append(None)
            continue
        kept = []
        prod = 1
        for a in _axes(entry):
            if dim % (prod * mesh.shape[a]) == 0:
                kept.append(a)
                prod *= mesh.shape[a]
        out.append(tuple(kept) if len(kept) > 1 else
                   (kept[0] if kept else None))
    return P(*out)


def fit_specs(spec_tree, tree, mesh):
    """``_fit_one`` leafwise: ``spec_tree`` parallel to ``tree`` (tensors
    or anything with ``.shape``)."""
    return tree_map(lambda s, leaf: _fit_one(s, tuple(leaf.shape), mesh),
                    spec_tree, tree, is_leaf=_is_spec)


def shard_shape(shape, spec: P, mesh) -> tuple:
    """One device's block of a ``shape`` array under ``spec``
    (``NamedSharding.shard_shape``): each dim divided by the product of
    its axes' sizes, which must divide it."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        n = math.prod(mesh.shape[a] for a in _axes(entry))
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"over {entry} ({n} devices)")
        out.append(dim // n)
    return tuple(out)


def shard_bytes(tree, spec_tree, mesh) -> int:
    """Bytes of one device's shards of every leaf of ``tree`` (tensors,
    ``meta`` ones included) under the parallel ``spec_tree``."""
    leaves = tree_flatten(tree)[0]
    specs = tree_flatten(spec_tree)[0]
    if len(leaves) != len(specs):
        raise ValueError(f"{len(leaves)} leaves against {len(specs)} specs")
    return sum(math.prod(shard_shape(tuple(x.shape), s, mesh)) *
               x.dtype.itemsize for x, s in zip(leaves, specs))


# ---------------------------------------------------------------------------
# neuro workload: static shard-frontier routing tables (sparse transport)
# ---------------------------------------------------------------------------
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
