"""Parity of the port's event wheel (``repro_torch.sched.wheel``) against
the JAX package's (``repro.sched.wheel``), on the CPU.

The JAX wheel runs under ``jax.jit``, as its runners run it: there XLA
turns the division by the bucket width into a product by its reciprocal,
and the port's bucket index follows that product (``_bucket_of``), so
events that lie exactly on bucket boundaries land in the same buckets.
Slot layouts (the queue's ``t`` arrays, bit for bit), ``dropped`` and
occupancy counters are exact; delivered weights agree within 1e-15
relative (``jnp.sum`` against the port's fixed-order ``fixed_sum``).
The last tests drive the port's runner: the wheel against the dense queue
(spike trains within 1e-9 ms) and the compact fan-out into either queue
under a synchronized burst, fallback included (exact).
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)

from repro import sched as jsched  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.core.topology import TopologyConfig as JTopo  # noqa: E402
from repro.sched import wheel as jwh  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch import sched as tsched  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import exec_fap as tfap  # noqa: E402
from repro_torch.core import morphology as tmorph  # noqa: E402
from repro_torch.core.cell import CellModel as TCell  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core.topology import TopologyConfig as TTopo  # noqa: E402
from repro_torch.sched import wheel as twh  # noqa: E402

W_RTOL = 1e-15
SPEC = (8, 4, 0.703125)          # n_buckets, bucket_slots, bucket_width

_jins = jax.jit(jwh.insert, static_argnums=0)
_jgrp = jax.jit(jwh.insert_grouped, static_argnums=0)
_jdel = jax.jit(jwh.deliver_until)
_jocc = jax.jit(jwh.bucket_occupancy, static_argnums=0)


def _specs(n_buckets, slots, width):
    return (jsched.WheelSpec(n_buckets, slots, width),
            tsched.WheelSpec(n_buckets, slots, width))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _same_queue(teq, jeq):
    for f in ("t", "w_ampa", "w_gaba", "dropped"):
        np.testing.assert_array_equal(getattr(teq, f).numpy(),
                                      np.asarray(getattr(jeq, f)), err_msg=f)


def _same_delivery(tout, jout):
    teq, twa, twg, tc = tout
    jeq, jwa, jwg, jc = jout
    _same_queue(teq, jeq)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(twa.numpy(), np.asarray(jwa), rtol=W_RTOL,
                               atol=0)
    np.testing.assert_allclose(twg.numpy(), np.asarray(jwg), rtol=W_RTOL,
                               atol=0)


def _traffic(rng, n, E, width, t_hi=12.0):
    """Random events; a quarter of them exactly on bucket boundaries, some
    one ulp off them."""
    t = rng.uniform(0.0, t_hi, E)
    on = rng.random(E) < 0.25
    t[on] = rng.integers(0, int(t_hi / width), on.sum()) * width
    nudge = rng.random(E) < 0.05
    t[nudge] = np.nextafter(t[nudge], np.inf)
    return (rng.integers(0, n, E).astype(np.int32), t,
            rng.exponential(1.0, E), rng.exponential(1.0, E),
            rng.random(E) < 0.8)


# ------------------------------------------------------------- geometry --
@pytest.mark.parametrize("n,k,seed,topology", [
    (64, 16, 9, "uniform"), (16, 4, 3, "uniform"), (64, 8, 1, "ring"),
    (64, 6, 5, "block"), (49, 5, 2, "grid2d"), (64, 7, 4, "smallworld"),
    (16384, 16, 11, "uniform")])
def test_wheel_spec_auto_field_equal(n, k, seed, topology):
    kw = dict(n_blocks=7) if topology == "grid2d" else {}
    a = jsched.WheelSpec.auto(jnet.make_network(
        n, k_in=k, seed=seed, topology=JTopo(topology, **kw)))
    b = tsched.WheelSpec.auto(tnet.make_network(
        n, k_in=k, seed=seed, topology=TTopo(topology, **kw)))
    assert tuple(a) == tuple(b)
    assert a.capacity == b.capacity


def test_wheel_spec_auto_ungrouped_net():
    """The histogram branch (edges not grouped by post)."""
    net = jnet.make_network(32, k_in=4, seed=1)
    perm = np.random.default_rng(0).permutation(net.pre.shape[0])
    shuffled = net._replace(pre=net.pre[perm], post=net.post[perm],
                            delay=net.delay[perm])
    assert tuple(jsched.WheelSpec.auto(shuffled)) == \
        tuple(tsched.WheelSpec.auto(interop.network_from_numpy(shuffled)))


def test_synchronized_burst_matches_jax():
    """Every in-edge fires at t=0 (``test_event_wheel.py:267``): the auto
    geometry holds the burst, and the port places it slot for slot."""
    n, k = 64, 16
    jn = jnet.make_network(n, k_in=k, seed=9)
    js, ts = jsched.WheelSpec.auto(jn), tsched.WheelSpec.auto(
        tnet.make_network(n, k_in=k, seed=9))
    t_ev = jn.delay.reshape(n, k)
    jeq = _jgrp(js, jsched.make_wheel(n, js), jnp.asarray(t_ev),
                jnp.ones((n, k)), jnp.zeros((n, k)), jnp.ones((n, k), bool))
    teq = twh.insert_grouped(ts, twh.make_wheel(n, ts, "cpu"), _t(t_ev),
                             torch.ones((n, k), dtype=torch.float64),
                             torch.zeros((n, k), dtype=torch.float64),
                             torch.ones((n, k), dtype=torch.bool))
    _same_queue(teq, jeq)
    assert int(teq.dropped) == 0
    occ, jocc = twh.bucket_occupancy(ts, teq), _jocc(js, jeq)
    for f in ("per_bucket", "max_bucket", "occupied"):
        np.testing.assert_array_equal(occ[f].numpy(), np.asarray(jocc[f]))
    assert int(occ["occupied"]) == n * k
    assert int(occ["max_bucket"]) <= ts.bucket_slots


# ------------------------------------------------------------ insertion --
def test_bucket_of_follows_the_jitted_reference_on_boundaries():
    js, ts = _specs(*SPEC)
    k = np.arange(0, 400, dtype=np.float64)
    t = np.concatenate([k * SPEC[2], np.nextafter(k * SPEC[2], np.inf),
                        np.nextafter(k * SPEC[2], -np.inf)[1:],
                        np.random.default_rng(0).uniform(0, 300, 20000)])
    valid = np.ones(t.shape, bool)
    jb = jax.jit(functools.partial(jwh._bucket_of, js))(jnp.asarray(t),
                                                         jnp.asarray(valid))
    tb = twh._bucket_of(ts, _t(t), _t(valid))
    assert tb.dtype == torch.int32
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_insert_and_deliver_match_jax(seed):
    """Generic insert (ranked by the K8 plain version) with overflow and
    interleaved partial deliveries: queue, drops and deliveries equal."""
    rng = np.random.default_rng(seed)
    js, ts = _specs(4, 3, 0.5) if seed % 2 else _specs(*SPEC)
    n = 6
    jeq, teq = jsched.make_wheel(n, js), twh.make_wheel(n, ts, "cpu")
    for _ in range(4):
        tgt, t, wa, wg, valid = _traffic(rng, n, int(rng.integers(5, 40)),
                                         js.bucket_width)
        jeq = _jins(js, jeq, *map(jnp.asarray, (tgt, t, wa, wg, valid)))
        teq = twh.insert(ts, teq, *map(_t, (tgt, t, wa, wg, valid)))
        _same_queue(teq, jeq)
        np.testing.assert_array_equal(twh.next_time(teq).numpy(),
                                      np.asarray(jwh.next_time(jeq)))
        cut = rng.uniform(0.0, 12.0, n)
        jout = _jdel(jeq, jnp.asarray(cut))
        tout = twh.deliver_until(teq, _t(cut))
        _same_delivery(tout, jout)
        jeq, teq = jout[0], tout[0]
    assert int(teq.dropped) > 0 or seed % 2 == 0     # small wheel overflows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_insert_grouped_matches_jax(seed):
    rng = np.random.default_rng(10 + seed)
    js, ts = _specs(4, 3, 0.5) if seed else _specs(*SPEC)
    n, k = 12, 6
    jeq, teq = jsched.make_wheel(n, js), twh.make_wheel(n, ts, "cpu")
    for _ in range(3):
        t = rng.uniform(0, 10, (n, k))
        t[:, :2] = rng.integers(0, 14, (n, 2)) * js.bucket_width
        wa, wg = rng.exponential(1.0, (n, k)), rng.exponential(1.0, (n, k))
        valid = rng.random((n, k)) < 0.7
        jeq = _jgrp(js, jeq, *map(jnp.asarray, (t, wa, wg, valid)))
        teq = twh.insert_grouped(ts, teq, *map(_t, (t, wa, wg, valid)))
        _same_queue(teq, jeq)
        cut = rng.uniform(0, 10, n)
        jout, tout = _jdel(jeq, jnp.asarray(cut)), twh.deliver_until(
            teq, _t(cut))
        _same_delivery(tout, jout)
        jeq, teq = jout[0], tout[0]
    if seed:
        assert int(teq.dropped) > 0


def test_grouped_and_generic_insert_agree_in_port():
    """The grouped fast path places the same events as the generic insert
    (same slots: the grouped ranks are the generic ranks of the flat
    by-post order)."""
    rng = np.random.default_rng(5)
    _, ts = _specs(*SPEC)
    n, k = 12, 6
    t, wa, wg = (_t(rng.uniform(0, 10, (n, k))),
                 _t(rng.exponential(1.0, (n, k))),
                 _t(rng.exponential(1.0, (n, k))))
    valid = _t(rng.random((n, k)) < 0.6)
    a = twh.insert_grouped(ts, twh.make_wheel(n, ts, "cpu"), t, wa, wg, valid)
    tgt = torch.arange(n, dtype=torch.int32).repeat_interleave(k)
    b = twh.insert(ts, twh.make_wheel(n, ts, "cpu"), tgt, t.reshape(-1),
                   wa.reshape(-1), wg.reshape(-1), valid.reshape(-1))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_wheel_delivers_like_the_dense_queue():
    """Inside the port the wheel and the dense queue deliver the same
    event sets (delivery is a set operation; only slots differ)."""
    rng = np.random.default_rng(7)
    _, ts = _specs(*SPEC)
    n = 8
    deq, weq = tev.make_queue(n, ts.capacity, "cpu"), \
        twh.make_wheel(n, ts, "cpu")
    for _ in range(4):
        tgt, t, wa, wg, valid = map(_t, _traffic(rng, n, 20, ts.bucket_width,
                                                 t_hi=10.0))
        deq = tev.insert(deq, tgt, t, wa, wg, valid)
        weq = twh.insert(ts, weq, tgt, t, wa, wg, valid)
        assert int(deq.dropped) == int(weq.dropped) == 0
        cut = _t(rng.uniform(0, 10, n))
        deq, da, dg, dc = tev.deliver_until(deq, cut)
        weq, wa_, wg_, wc = twh.deliver_until(weq, cut)
        np.testing.assert_allclose(da.numpy(), wa_.numpy(), rtol=W_RTOL)
        np.testing.assert_allclose(dg.numpy(), wg_.numpy(), rtol=W_RTOL)
        assert torch.equal(dc, wc)
        assert torch.equal(tev.next_time(deq), twh.next_time(weq))


def test_bucket_occupancy_matches_jax():
    js, ts = _specs(4, 3, 0.5)
    tgt = np.array([0, 0, 1, 2, 2, 2], np.int32)
    t = np.array([0.2, 0.3, 1.2, 0.5, 2.5, 4.5])   # buckets 0 0 2 1 1 1
    args = (tgt, t, np.ones(6), np.zeros(6), np.ones(6, bool))
    jeq = _jins(js, jsched.make_wheel(3, js), *map(jnp.asarray, args))
    teq = twh.insert(ts, twh.make_wheel(3, ts, "cpu"), *map(_t, args))
    occ, jocc = twh.bucket_occupancy(ts, teq), _jocc(js, jeq)
    for f in ("per_bucket", "max_bucket", "occupied"):
        np.testing.assert_array_equal(occ[f].numpy(), np.asarray(jocc[f]))
    assert occ["per_bucket"].tolist() == [2, 3, 1, 0]
    assert int(occ["max_bucket"]) == 3 and int(occ["occupied"]) == 6


def test_queue_ops_wheel():
    _, ts = _specs(*SPEC)
    q = tsched.get_queue_ops("wheel", wheel=ts)
    assert q.name == "wheel" and q.capacity == ts.capacity
    eq = q.make(5, "cpu")
    assert isinstance(eq, tsched.WheelQueue)
    assert eq.t.shape == (5, ts.capacity)
    assert q.insert_batch.func is twh.insert
    with pytest.raises(ValueError):
        tsched.get_queue_ops("calendar")


def test_wheel_queue_interop_round_trip():
    js, ts = _specs(*SPEC)
    rng = np.random.default_rng(3)
    tgt, t, wa, wg, valid = _traffic(rng, 5, 30, js.bucket_width)
    jeq = _jins(js, jsched.make_wheel(5, js),
                *map(jnp.asarray, (tgt, t, wa, wg, valid)))
    teq = interop.wheel_queue_from_numpy(
        jax.tree_util.tree_map(np.asarray, jeq), "cpu")
    assert isinstance(teq, tsched.WheelQueue)
    _same_queue(teq, jeq)
    back = jsched.WheelQueue(**interop.wheel_queue_to_numpy(teq))
    for a, b in zip(back, jeq):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------- the wheel in the runner --
def _net16():
    return tnet.make_network(16, k_in=4, seed=3)


def _trun(net, t_end=8.0, iinj=None, **kw):
    return tfap.make_fap_vardt_runner(TCell(tmorph.soma_only(), device="cpu"),
                                      net, iinj, t_end, device="cpu", **kw)()


def _trains(res):
    ts, c = res.rec.times.numpy(), res.rec.count.numpy()
    return [np.sort(ts[i][: c[i]]) for i in range(len(c))]


def _exact_same(a, b):
    assert torch.equal(a.rec.times, b.rec.times)
    assert torch.equal(a.y_final, b.y_final)
    assert int(a.n_events) == int(b.n_events)
    assert int(a.dropped) == int(b.dropped) == 0
    assert not bool(a.failed) and not bool(b.failed)


@pytest.mark.parametrize("queue", ["dense", "wheel"])
def test_compact_fanout_burst_and_fallback(queue):
    """All neurons driven hard: the compact fan-out equals the dense one
    both when the spiking set fits spike_cap and when it overflows every
    round (spike_cap=1: the dense fallback)."""
    net = _net16()
    burst = np.full(16, 0.22)
    kw = dict(queue=queue, ev_cap=128, wheel=tsched.WheelSpec.auto(net))
    r_d, rounds_d = _trun(net, iinj=burst, **kw)
    assert int(r_d.rec.count.sum()) >= 16
    for cap in (16, 1):
        r_c, rounds_c = _trun(net, iinj=burst, fanout="compact",
                              spike_cap=cap, **kw)
        _exact_same(r_d, r_c)
        assert rounds_c == rounds_d


def test_wheel_equals_dense_queue_in_port():
    """``test_event_wheel.py::test_fap_e2e_wheel_equals_dense`` for the
    port: spike trains within 1e-9 ms, equal n_events."""
    net = tnet.make_network(12, k_in=4, seed=3)
    iinj = 0.16 + 0.004 * np.random.default_rng(1).standard_normal(12)
    r_d, _ = _trun(net, 15.0, iinj)
    r_w, _ = _trun(net, 15.0, iinj, queue="wheel")
    assert int(r_d.dropped) == int(r_w.dropped) == 0
    assert not bool(r_w.failed) and int(r_d.rec.count.sum()) > 0
    for a, b in zip(_trains(r_d), _trains(r_w)):
        assert len(a) == len(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    assert int(r_d.n_events) == int(r_w.n_events)
