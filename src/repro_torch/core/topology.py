"""Structured connectivity generators: the ``topology=`` knob of make_network.

Host numpy, a copy of the JAX package's ``repro.core.topology``: the same
seed draws the same arrays in both packages.

Real cortical models are not uniform-random: long-range interconnections
ride on locally-clustered wiring (Pastorelli et al., arXiv:1902.08410), and
simulators have always exploited that structure (Brette et al. review).
For the asynchronous execution model the structure is *the* lever on
communication cost — with uniform wiring every neuron sits on a shard
boundary and the notify frontier (``sharding.shard_frontier``) degenerates
to all-gather-shaped traffic, while clustered wiring lets locality-aware
placement (``distributed.placement``) shrink it by the locality factor.

Every generator preserves ``make_network``'s static edge layout — edges
grouped by postsynaptic neuron with uniform in-degree k_in (``post ==
repeat(arange(n), k_in)``) — so the grouped queue-insert fast paths,
``WheelSpec.auto`` and the SPMD round's shard-local insert all run
unmodified on structured nets.

Generators (``TopologyConfig.name``):

``uniform``
    The seed behaviour: presynaptic ids i.i.d. uniform over [0, n).  Draws
    the same rng stream as the pre-knob ``make_network``, so seeded
    networks are bit-identical to before the knob existed.
``block``
    Clustered/block-modular wiring: neurons partition into ``n_blocks``
    contiguous blocks; each in-edge draws its pre from the post's own
    block with probability ``p_in``, else uniformly from the other blocks.
``ring``
    1-D distance-dependent falloff: pre at signed circular offset whose
    magnitude is geometric with mean ``sigma`` neurons.
``grid2d``
    2-D torus (row-major ids on a side x side grid, n = side**2): pre at a
    wrapped 2-D offset with isotropic discrete-Gaussian components of
    scale ``sigma``.
``smallworld``
    Watts-Strogatz: ring lattice of the k_in nearest neighbours, each
    edge rewired to a uniform pre with probability ``p_rewire``.

Each structured net carries per-neuron *block metadata* (``Network.block``:
i32[N], the locality unit — the cluster for ``block``, a contiguous tile of
``n // n_blocks`` neurons otherwise) from which per-edge locality is
*measured*, never assumed: ``edge_block_pairs`` / ``intra_block_frac`` here,
cut-edge and frontier statistics in ``distributed.placement``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np

TOPOLOGIES = ("uniform", "block", "ring", "grid2d", "smallworld")


class TopologyConfig(NamedTuple):
    """Static connectivity-structure parameters (host-side constants).

    n_blocks: locality units for ``block`` (and the metadata tiling of the
        spatial topologies); must divide n.
    p_in:     ``block`` — probability an in-edge stays within its block.
    sigma:    ``ring``/``grid2d`` — distance-falloff scale in neurons
              (mean |offset| on the ring, per-axis std on the grid).
    p_rewire: ``smallworld`` — Watts-Strogatz rewiring probability.
    """
    name: str = "uniform"
    n_blocks: int = 8
    p_in: float = 0.9
    sigma: float = 4.0
    p_rewire: float = 0.05


def as_config(topology) -> TopologyConfig:
    """Coerce the ``topology=`` knob (name or config) to a TopologyConfig."""
    if isinstance(topology, TopologyConfig):
        cfg = topology
    elif isinstance(topology, str):
        cfg = TopologyConfig(name=topology)
    else:
        raise TypeError(f"topology must be a name or TopologyConfig, "
                        f"got {topology!r}")
    if cfg.name not in TOPOLOGIES:
        raise ValueError(f"unknown topology {cfg.name!r} "
                         f"(want one of {TOPOLOGIES})")
    return cfg


def _tile_blocks(n: int, n_blocks: int) -> np.ndarray:
    if n_blocks <= 0 or n % n_blocks:
        raise ValueError(f"n_blocks={n_blocks} must divide n={n}")
    return (np.arange(n, dtype=np.int32) // (n // n_blocks)).astype(np.int32)


def _pre_uniform(rng, n, k_in, cfg):
    # exactly the seed network's single draw — keeps seeded nets identical
    return rng.integers(0, n, size=n * k_in).astype(np.int32), None


def _pre_block(rng, n, k_in, cfg):
    block = _tile_blocks(n, cfg.n_blocks)
    bs = n // cfg.n_blocks
    E = n * k_in
    post_block = np.repeat(block, k_in).astype(np.int64)
    stay = rng.random(E) < cfg.p_in
    off_in = rng.integers(0, bs, size=E)
    pre_in = post_block * bs + off_in
    if cfg.n_blocks == 1:
        return pre_in.astype(np.int32), block     # one block: nowhere else
    off_out = rng.integers(0, n - bs, size=E)        # uniform over other blocks
    out = off_out + np.where(off_out >= post_block * bs, bs, 0)
    pre = np.where(stay, pre_in, out)
    return pre.astype(np.int32), block


def _pre_ring(rng, n, k_in, cfg):
    E = n * k_in
    post = np.repeat(np.arange(n, dtype=np.int64), k_in)
    p = 1.0 / max(float(cfg.sigma), 1.0)
    mag = rng.geometric(p, size=E)                    # >= 1: never self
    sign = rng.integers(0, 2, size=E) * 2 - 1
    pre = (post + sign * mag) % n
    return pre.astype(np.int32), _tile_blocks(n, cfg.n_blocks)


def _pre_grid2d(rng, n, k_in, cfg):
    side = math.isqrt(n)
    if side * side != n:
        raise ValueError(f"grid2d needs a square neuron count, got n={n}")
    E = n * k_in
    post = np.repeat(np.arange(n, dtype=np.int64), k_in)
    px, py = post % side, post // side
    dx = np.rint(rng.normal(0.0, cfg.sigma, size=E)).astype(np.int64)
    dy = np.rint(rng.normal(0.0, cfg.sigma, size=E)).astype(np.int64)
    dx = np.where((dx == 0) & (dy == 0), 1, dx)       # no zero offset
    pre = ((py + dy) % side) * side + (px + dx) % side
    return pre.astype(np.int32), _tile_blocks(n, cfg.n_blocks)


def _pre_smallworld(rng, n, k_in, cfg):
    if k_in >= n:
        raise ValueError(f"smallworld lattice needs k_in < n ({k_in} vs {n})")
    half = k_in // 2
    offs = np.concatenate([np.arange(1, half + 1),
                           -np.arange(1, k_in - half + 1)])[:k_in]
    post = np.repeat(np.arange(n, dtype=np.int64), k_in)
    lattice = (post + np.tile(offs, n)) % n
    E = n * k_in
    rew = rng.random(E) < cfg.p_rewire
    rand = rng.integers(0, n, size=E)
    pre = np.where(rew, rand, lattice)
    return pre.astype(np.int32), _tile_blocks(n, cfg.n_blocks)


_GENERATORS = {"uniform": _pre_uniform, "block": _pre_block,
               "ring": _pre_ring, "grid2d": _pre_grid2d,
               "smallworld": _pre_smallworld}


def sample_pre(cfg: TopologyConfig, rng: np.random.Generator, n: int,
               k_in: int):
    """Draw the presynaptic ids of the grouped by-post edge layout.

    Returns (pre i32[n*k_in], block i32[n] | None): edge j*k_in+e is the
    e-th in-edge of postsynaptic neuron j; ``block`` is the per-neuron
    locality metadata (None for the structureless ``uniform``).
    """
    return _GENERATORS[cfg.name](rng, n, k_in, cfg)


# ---------------------------------------------------------------------------
# measured per-edge locality (never assumed from the generator parameters)
# ---------------------------------------------------------------------------
def edge_block_pairs(net) -> Optional[np.ndarray]:
    """Per-edge block metadata: i32[E, 2] of (block[pre], block[post]),
    or None when the net carries no block structure."""
    if net.block is None:
        return None
    b = np.asarray(net.block)
    return np.stack([b[np.asarray(net.pre)], b[np.asarray(net.post)]], axis=1)


def intra_block_frac(net) -> float:
    """Measured fraction of edges that stay inside their block."""
    pairs = edge_block_pairs(net)
    if pairs is None:
        raise ValueError("net has no block metadata (uniform topology)")
    return float((pairs[:, 0] == pairs[:, 1]).mean())


def ring_distance(net) -> np.ndarray:
    """Per-edge circular |pre - post| distance (neurons)."""
    n = int(net.n)
    d = (np.asarray(net.pre, np.int64) - np.asarray(net.post, np.int64)) % n
    return np.minimum(d, n - d)
