"""Synthetic neural networks: connectivity, synaptic delays, spiking regimes.

Host numpy, a copy of the JAX package's ``repro.core.network``:
``make_network`` rebuilds array-identical networks from the same seed.

Connectivity mirrors the statistics the paper reports for the Markram et al.
digital reconstruction: per-neuron in-degree with AMPA/GABA receptor mix,
synaptic delays >= 0.1 ms with a long-tailed (lognormal) distribution whose
mode sits well above the BSP communication interval (paper Fig. 3 — only
~0.13% of synapses sit at the 0.1 ms minimum).

Wiring *structure* is the ``topology=`` knob (``repro_torch.core.topology``):
uniform-random (the seed behaviour, bit-identical for a given seed) or the
structured generators (block/clustered, ring and 2-D-grid distance falloff,
small-world) whose per-neuron block metadata (``Network.block``) makes
locality measurable — the input to locality-aware shard placement
(``repro.distributed.placement`` in the JAX package).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from repro_torch.core import topology as topo

MIN_DELAY = 0.1      # ms — the BSP communication interval (paper §1)
MAX_DELAY = 7.0      # ms — Fig. 3 cut-off (>7 ms is <1% of synapses)


class Network(NamedTuple):
    n: int
    pre: np.ndarray        # i32[E]
    post: np.ndarray       # i32[E]
    delay: np.ndarray      # f64[E] ms
    w_ampa: np.ndarray     # f64[E] uS (0 for GABA synapses)
    w_gaba: np.ndarray     # f64[E] uS (0 for AMPA synapses)
    min_delay: float
    block: Optional[np.ndarray] = None   # i32[N] locality unit (topology)

    @property
    def n_edges(self) -> int:
        return int(self.pre.shape[0])


def sample_delays(rng: np.random.Generator, size: int) -> np.ndarray:
    """Lognormal delays clipped to [MIN_DELAY, MAX_DELAY] (Fig. 3 shape)."""
    d = rng.lognormal(mean=0.0, sigma=0.75, size=size)      # mode ~ 0.57 ms
    return np.clip(d, MIN_DELAY, MAX_DELAY)


def make_network(n: int, k_in: int = 16, pct_gaba: float = 0.2,
                 w_exc: float = 1.0e-4, w_inh: float = 3.0e-4,
                 seed: int = 0, allow_self: bool = False,
                 topology="uniform") -> Network:
    """Network with k_in synapses per neuron, wired per the topology knob.

    topology: a ``repro_torch.core.topology`` generator name ("uniform", "block",
    "ring", "grid2d", "smallworld") or a ``TopologyConfig``; "uniform"
    reproduces the historical networks bit-for-bit at a given seed.
    Weights are conductance increments per event (uS); defaults produce
    physiological EPSP sizes on the 20 um soma used in benchmarks.
    """
    cfg = topo.as_config(topology)
    rng = np.random.default_rng(seed)
    post = np.repeat(np.arange(n, dtype=np.int32), k_in)
    pre, block = topo.sample_pre(cfg, rng, n, k_in)
    if not allow_self:
        clash = pre == post
        pre[clash] = (pre[clash] + 1) % n
    delay = sample_delays(rng, n * k_in)
    is_gaba = rng.random(n * k_in) < pct_gaba
    w = rng.exponential(1.0, size=n * k_in)
    w_ampa = np.where(is_gaba, 0.0, w * w_exc)
    w_gaba = np.where(is_gaba, w * w_inh, 0.0)
    return Network(n=n, pre=pre, post=post, delay=delay,
                   w_ampa=w_ampa, w_gaba=w_gaba, min_delay=float(delay.min()),
                   block=block)


def regime_current(regime: str, i_thresh: float) -> float:
    """Continuous current driving a neuron to a given spiking regime.

    The five regimes of paper §4 (quiet 0.25 Hz .. burst 55.8 Hz) are set up
    in benchmarks by calibrating current against the threshold current, as
    the paper does (Fig. 6's x-axis is % of threshold current).
    """
    factors = {"quiet": 0.95, "slow": 1.02, "moderate": 1.12,
               "fast": 1.8, "burst": 3.2}
    if regime not in factors:
        raise ValueError(f"unknown regime {regime!r}")
    return factors[regime] * i_thresh


def delay_histogram(net: Network, bin_ms: float = 0.1):
    """Paper Fig. 3: histogram of synaptic delays, 0.1 ms bins."""
    bins = np.arange(MIN_DELAY, MAX_DELAY + bin_ms, bin_ms)
    hist, edges = np.histogram(net.delay, bins=bins)
    return hist, edges


def tile_network(net: Network, copies: int) -> Network:
    """``copies`` disjoint copies of ``net`` as one network of copies * N
    neurons: copy t's neuron i is t * N + i, its edges those of ``net``
    shifted by t * N, in copy order (the by-post grouping of
    ``make_network`` holds).  The lanes of the tenant-batched round
    (``exec_fap``'s ``tenant_round``)."""
    n, E = int(net.n), net.n_edges
    shift = np.repeat(np.arange(copies, dtype=np.int64) * n, E)
    tile = lambda a: np.tile(np.asarray(a), copies)  # noqa: E731
    return Network(n=n * copies,
                   pre=(tile(net.pre) + shift).astype(np.int32),
                   post=(tile(net.post) + shift).astype(np.int32),
                   delay=tile(net.delay), w_ampa=tile(net.w_ampa),
                   w_gaba=tile(net.w_gaba), min_delay=net.min_delay,
                   block=None if net.block is None else tile(net.block))
