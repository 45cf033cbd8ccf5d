"""The SPMD round's host tables in the port against the JAX package:
``sharding.shard_frontier`` (with and without a placement), every
placement pass (permutation, inverse, cut, ``frontier_stats``) and
``place_network``, array-identical on all five topologies."""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import network as jnet  # noqa: E402
from repro.distributed import placement as jplc  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402

from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.distributed import placement as tplc  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402

TOPOLOGIES = ("uniform", "block", "ring", "grid2d", "smallworld")
N, K_IN, SHARDS = 64, 4, 4           # grid2d: an 8 x 8 grid


def _nets(topo, seed=7):
    j = jnet.make_network(N, k_in=K_IN, seed=seed, topology=topo)
    t = tnet.make_network(N, k_in=K_IN, seed=seed, topology=topo)
    for f in ("pre", "post", "delay", "w_ampa", "w_gaba"):
        assert np.array_equal(getattr(j, f), getattr(t, f)), f
    return j, t


def _same_tables(a, b):
    for f in ("boundary_rel", "boundary_gid", "dest_map"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.frontier_size == b.frontier_size
    assert np.array_equal(a.sizes, b.sizes)


@pytest.mark.parametrize("placed", [False, True])
@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_shard_frontier_identical(topo, placed):
    j, t = _nets(topo)
    perm = jplc.compute_placement(j, SHARDS, "greedy").perm if placed \
        else None
    for shards in (2, SHARDS):
        _same_tables(tsh.shard_frontier(t.pre, t.post, N, shards, perm=perm),
                     jsh.shard_frontier(j.pre, j.post, N, shards, perm=perm))


@pytest.mark.parametrize("method", jplc.PLACEMENTS)
@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_placement_passes_identical(topo, method):
    j, t = _nets(topo)
    pj = jplc.compute_placement(j, SHARDS, method)
    pt = tplc.compute_placement(t, SHARDS, method)
    assert np.array_equal(pt.perm, pj.perm) and np.array_equal(pt.inv, pj.inv)
    assert pt.perm.dtype == pj.perm.dtype
    assert (pt.method, pt.cut, pt.n_shards) == (pj.method, pj.cut,
                                                pj.n_shards)
    assert tplc.cut_edges(t.pre, t.post, N, SHARDS, pt.perm) == pj.cut
    assert tplc.frontier_stats(t, SHARDS, pt) == \
        jplc.frontier_stats(j, SHARDS, pj)
    assert tplc.frontier_stats(t, SHARDS) == jplc.frontier_stats(j, SHARDS)


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_place_network_identical(topo):
    j, t = _nets(topo)
    pj = jplc.compute_placement(j, SHARDS, "greedy")
    pt = tplc.compute_placement(t, SHARDS, "greedy")
    a, b = tplc.place_network(t, pt), jplc.place_network(j, pj)
    for f in ("pre", "post", "delay", "w_ampa", "w_gaba", "block"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert np.array_equal(x, y), f
    iinj = np.linspace(0.1, 0.2, N)
    assert np.array_equal(tplc.place_inputs(t, iinj, pt)[1],
                          jplc.place_inputs(j, iinj, pj)[1])
    assert tplc.permute_dense(0.16, pt) == 0.16


def test_unpermute_inverts_the_placement():
    """Results of a placed run come back in the caller's order, for numpy
    rows and for tensors alike."""
    import torch
    _, t = _nets("block")
    pl = tplc.compute_placement(t, SHARDS, "greedy")
    x = np.arange(N * 3).reshape(N, 3)
    placed = tplc.permute_dense(x, pl)
    assert np.array_equal(tplc.unpermute_rows(placed, pl), x)
    assert torch.equal(tplc.unpermute_rows(torch.as_tensor(placed), pl),
                       torch.as_tensor(x))


def test_from_order_and_bad_shapes():
    j, t = _nets("ring")
    order = np.random.default_rng(0).permutation(N)
    a = tplc.from_order(order, SHARDS, t)
    b = jplc.from_order(order, SHARDS, j)
    assert np.array_equal(a.perm, b.perm) and a.cut == b.cut
    with pytest.raises(ValueError):
        tplc.compute_placement(t, 5)
    with pytest.raises(ValueError):
        tplc.compute_placement(t, SHARDS, "spectral")
    with pytest.raises(ValueError):
        tsh.shard_frontier(t.pre, t.post, N, 5)
