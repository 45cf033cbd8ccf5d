"""The port's active-set path (``batch="compact"``, ``fanout="compact"``,
``queue="wheel"``, ``select="threshold"``, the auto caps and the
incremental horizon) end to end, on the CPU.

* Against the JAX package: the auto caps, the compact helpers, the first
  3 ms of a compact run (every counter exact, spike times within 1e-8 ms)
  and the spike counts of 15 ms runs; ``test_compact_rounds_from_jax_carry``
  holds every per-lane counter exact over ten rounds run from the JAX
  runner's carried state.  Past ~3 ms the port's and JAX's step sequences
  drift (ROADMAP §3), so the long runs compare counts only.

Inside the port, ``tests/test_torch_compact_identity.py`` holds compact ==
dense on five topologies x two queues, and ``tests/test_torch_wheel.py``
the wheel against the dense queue and the compact fan-out under bursts.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)

from repro import sched as jsched  # noqa: E402
from repro.core import exec_common as jxc  # noqa: E402
from repro.core import exec_fap as jfap  # noqa: E402
from repro.core import morphology as jmorph  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.core.cell import CellModel as JCell  # noqa: E402
from repro.core.topology import TopologyConfig as JTopo  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch import sched as tsched  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import exec_common as xc  # noqa: E402
from repro_torch.core import exec_fap as tfap  # noqa: E402
from repro_torch.core import morphology as tmorph  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core.cell import CellModel as TCell  # noqa: E402
from repro_torch.core.topology import TopologyConfig as TTopo  # noqa: E402

N, K, T_END = 16, 4, 8.0       # square N: grid2d needs one
T_FULL, T_LONG = 3.0, 15.0     # ms: full port-vs-JAX parity, counts only
T_TOL = 1e-8                   # ms, port-vs-JAX spike times up to T_FULL
TOPO_KW = {"uniform": None, "block": dict(n_blocks=4, p_in=0.9),
           "ring": dict(sigma=3.0), "grid2d": dict(n_blocks=4, sigma=2.0),
           "smallworld": dict(p_rewire=0.1)}
IINJ = 0.16 + 0.004 * np.random.default_rng(1).standard_normal(N)


def _topo(cls, name):
    kw = TOPO_KW[name]
    return name if kw is None else cls(name, **kw)


@functools.lru_cache(maxsize=None)
def _tnet(topo="uniform", n=N):
    return tnet.make_network(n, k_in=K, seed=3, topology=_topo(TTopo, topo))


def _jnet(topo="uniform", n=N):
    return jnet.make_network(n, k_in=K, seed=3, topology=_topo(JTopo, topo))


@functools.lru_cache(maxsize=None)
def _tmodel():
    return TCell(tmorph.soma_only(), device="cpu")


def _trun(net, t_end=T_END, iinj=IINJ, **kw):
    return tfap.make_fap_vardt_runner(_tmodel(), net, iinj, t_end,
                                      device="cpu", **kw)()


def test_unknown_modes_and_unported_knobs():
    net = _tnet()
    mk = functools.partial(tfap.make_fap_vardt_runner, _tmodel(), net, IINJ,
                           T_END, device="cpu")
    for bad in (dict(batch="x"), dict(fanout="x"), dict(select="x"),
                dict(queue="x")):
        with pytest.raises(ValueError):
            mk(**bad)
    run = mk(batch="compact")
    # the robustness knobs are ported; checkpoints need a directory
    with pytest.raises(ValueError, match="ckpt_dir"):
        run(checkpoint_every=4)
    # the service's round takes the compact knobs since they were ported
    # (held to JAX in tests/test_torch_serve_compact.py)
    from repro_torch.serve import stack_lanes
    out = run.tenant_round(stack_lanes([run.init_carry()] * 2),
                           np.stack([IINJ, IINJ]),
                           torch.ones(2, dtype=torch.bool))
    assert out[0].t.shape == (2, IINJ.shape[0])
    assert bool((out[0].t > 0).any(dim=1).all())


# ------------------------------------------------- helpers against JAX ---
@pytest.mark.parametrize("topo", sorted(TOPO_KW))
def test_out_tables_array_identical(topo):
    for a, b in zip(jxc.out_tables(_jnet(topo)), xc.out_tables(_tnet(topo))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(jxc.out_post_table(_jnet(topo)),
                          xc.out_post_table(_tnet(topo)))
    assert np.array_equal(jxc.out_edge_table(_jnet(topo)),
                          xc.out_edge_table(_tnet(topo)))


def test_compact_frontier_matches_jax():
    rng = np.random.default_rng(4)
    n = 64
    for cap in (8, 32, 64, 100):
        for frac in (0.0, 0.2, 1.0):
            t = rng.uniform(0.0, 5.0, n)
            r = rng.random(n) < frac
            ji, jc = jxc.compact_frontier(jnp.asarray(r), jnp.asarray(t),
                                          min(cap, n))
            ti, tc = xc.compact_frontier(torch.from_numpy(r),
                                         torch.from_numpy(t), min(cap, n))
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            assert int(tc) == int(jc)
            sel = xc.select_active(torch.from_numpy(r), torch.from_numpy(t),
                                   cap)
            np.testing.assert_array_equal(
                sel.numpy(), np.asarray(jxc.select_active(
                    jnp.asarray(r), jnp.asarray(t), cap)))


def test_compact_frontier_forces_the_earliest_lane():
    """Clock ties below the bisection resolution crowd the earliest lane
    (index 7) out of the index-ordered compaction; it takes the last
    filled slot, as in JAX."""
    t = np.full(8, 1.0)
    t[7] = 1.0 - 1e-15
    r = np.ones(8, bool)
    ti, tc = xc.compact_frontier(torch.from_numpy(r), torch.from_numpy(t), 2)
    ji, jc = jxc.compact_frontier(jnp.asarray(r), jnp.asarray(t), 2)
    assert ti.tolist() == [0, 7] == np.asarray(ji).tolist()
    assert int(tc) == int(jc) == 8


def test_scatter_helpers_drop_sentinels():
    full = torch.arange(5, dtype=torch.float64)
    ids = torch.tensor([3, 5, 0, 5], dtype=torch.int32)
    vals = torch.tensor([30.0, -1.0, 10.0, -2.0], dtype=torch.float64)
    got = xc.scatter_at(full, ids, vals)
    want = jxc.scatter_at(jnp.arange(5.0), jnp.asarray(ids.numpy()),
                          jnp.asarray(vals.numpy()))
    assert got.tolist() == [10.0, 1.0, 2.0, 30.0, 4.0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert xc.unique_pad_ids(ids, 5).tolist() == [3, 6, 0, 8]
    eq = tev.make_queue(5, 3, "cpu")
    rows = torch.zeros((4, 3), dtype=torch.float64)
    out = tsched.scatter_rows(eq, ids, rows)
    assert torch.isinf(out.t[[1, 2, 4]]).all() and (out.t[[0, 3]] == 0).all()


def test_spike_rates_match_jax():
    rec = tev.make_spike_record(4, 6, "cpu")
    t = torch.tensor([0.5, 1.5, 2.5, 3.5], dtype=torch.float64)
    for _ in range(3):
        rec = tev.record_spikes(rec, torch.arange(4), t,
                                torch.tensor([True, True, False, True]))
        t = t + 1.0
    jrec = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), rec)
    np.testing.assert_array_equal(xc.spike_rates(rec, 1.0, 4.0).numpy(),
                                  np.asarray(jxc.spike_rates(jrec, 1.0, 4.0)))


def test_auto_caps_match_jax():
    """batch_cap/spike_cap="auto" pick the same caps as JAX from a probe
    short enough (2 ms) that the two probes agree; the pickers themselves
    agree on synthetic telemetry."""
    n = 64
    tn, jn = tnet.make_network(n, k_in=K, seed=3), \
        jnet.make_network(n, k_in=K, seed=3)
    iinj = 0.17 + 0.01 * np.random.default_rng(2).standard_normal(n)
    kw = dict(batch="compact", batch_cap="auto", fanout="compact",
              spike_cap="auto", probe_t=2.0)
    jrun = jfap.make_fap_vardt_runner(JCell(jmorph.soma_only()), jn, iinj,
                                      10.0, **kw)
    trun = tfap.make_fap_vardt_runner(_tmodel(), tn, iinj, 10.0,
                                      device="cpu", **kw)
    assert (trun.batch_cap, trun.spike_cap) == (jrun.batch_cap,
                                                jrun.spike_cap)
    for runnable, rounds, spikes in ((1000, 10, 7), (5, 3, 400), (0, 0, 0)):
        ts = xc.SchedStats(torch.tensor(runnable), torch.tensor(0),
                           torch.tensor(0), torch.tensor(rounds))
        js = jxc.SchedStats(jnp.asarray(runnable), jnp.asarray(0),
                            jnp.asarray(0), jnp.asarray(rounds))
        for nn in (64, 1 << 16):
            assert xc.auto_batch_cap(ts, nn) == jxc.auto_batch_cap(js, nn)
            trec = tev.make_spike_record(nn, 2, "cpu")._replace(
                count=torch.full((nn,), spikes // nn, dtype=torch.int32))
            jrec = jxc.ev.make_spike_record(nn, 2)._replace(
                count=jnp.full((nn,), spikes // nn, jnp.int32))
            assert xc.auto_spike_cap(trec, ts, nn) == \
                jxc.auto_spike_cap(jrec, js, nn)


# ------------------------------------------- the slice against live JAX --
def _active_kw(net_np):
    return dict(batch="compact", batch_cap=8, fanout="compact", spike_cap=2,
                queue="wheel", horizon_impl="fused")


@pytest.fixture(scope="module", params=[T_FULL, T_LONG],
                ids=["3ms", "15ms"])
def live_pair(request):
    t_end = request.param
    jn = _jnet()
    jr, jrounds = jfap.make_fap_vardt_runner(
        JCell(jmorph.soma_only()), jn, IINJ, t_end,
        wheel=jsched.WheelSpec.auto(jn), **_active_kw(jn))()
    tr, trounds = _trun(_tnet(), t_end, wheel=tsched.WheelSpec.auto(_tnet()),
                        **_active_kw(_tnet()))
    return t_end, (jr, int(jrounds)), (tr, trounds)


def test_port_compact_matches_live_jax(live_pair):
    t_end, (jr, jrounds), (tr, trounds) = live_pair
    jcount = np.asarray(jr.rec.count)
    assert jcount.sum() > 0
    assert np.array_equal(tr.rec.count.numpy(), jcount)
    assert int(tr.dropped) == int(jr.dropped) == 0
    assert int(tr.rec.overflow) == int(jr.rec.overflow) == 0
    assert not bool(tr.failed) and not bool(jr.failed)
    if t_end > T_FULL:
        return
    assert trounds == jrounds
    assert int(tr.n_steps) == int(jr.n_steps)
    assert int(tr.n_events) == int(jr.n_events)
    assert int(tr.n_resets) == int(jr.n_resets)
    for k, v in jr.solver.items():
        assert int(tr.solver[k]) == int(v), k
    for f in tr.sched._fields:
        assert int(getattr(tr.sched, f)) == int(getattr(jr.sched, f)), f
    jt, tt = np.asarray(jr.rec.times), tr.rec.times.numpy()
    fin = np.isfinite(jt)
    assert np.array_equal(np.isfinite(tt), fin)
    np.testing.assert_allclose(tt[fin], jt[fin], rtol=0, atol=T_TOL)


def test_compact_rounds_from_jax_carry():
    """Ten compact rounds (wheel, compact fan-out with a small spike_cap,
    binding batch_cap, incremental horizon) around the first spikes, each
    run from the JAX runner's carried state: every per-lane counter, the
    slot layout, the record and the event counters exact; clocks, steps
    and the horizon within 1e-8 relative."""
    jn, tn = _jnet(), _tnet()
    kw = dict(batch="compact", batch_cap=8, fanout="compact", spike_cap=2,
              queue="wheel", horizon_impl="scatter")
    jrun = jfap.make_fap_vardt_runner(JCell(jmorph.soma_only()), jn, IINJ,
                                      T_END, wheel=jsched.WheelSpec.auto(jn),
                                      **kw)
    trun = tfap.make_fap_vardt_runner(_tmodel(), tn, IINJ, T_END,
                                      wheel=tsched.WheelSpec.auto(tn),
                                      device="cpu", **kw)
    assert trun.incremental
    jround = jax.jit(jrun.round_body)
    jc, tc = jrun.init_carry(), trun.init_carry()
    np.testing.assert_array_equal(tc[3].numpy(), np.asarray(jc[3]))
    for _ in range(4):
        jc = jround(jc)
    ints = ("q", "nst", "nfe", "nni", "netf", "nncf", "nreset", "nsetups",
            "qwait", "failed", "jbad")
    spiked = 0
    for _ in range(10):
        np_ = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
        tc = (interop.bdf_state_from_numpy(np_(jc[0]), "cpu"),
              interop.wheel_queue_from_numpy(np_(jc[1]), "cpu"),
              interop.spike_record_from_numpy(np_(jc[2]), "cpu"),
              interop.horizon_from_numpy(np_(jc[3]), "cpu")) + tc[4:]
        before = int(tc[2].count.sum())
        jc, tc = jround(jc), trun.round_body(tc)
        spiked += int(tc[2].count.sum()) - before
        got = interop.bdf_state_to_numpy(tc[0])
        for k in ints:
            assert np.array_equal(got[k], np.asarray(getattr(jc[0], k))), k
        for k in ("t", "h"):
            np.testing.assert_allclose(got[k], np.asarray(getattr(jc[0], k)),
                                       rtol=1e-8, atol=0, err_msg=k)
        jq = np.asarray(jc[1].t)
        assert np.array_equal(np.isfinite(tc[1].t.numpy()), np.isfinite(jq))
        assert int(tc[1].dropped) == int(jc[1].dropped) == 0
        assert np.array_equal(tc[2].count.numpy(), np.asarray(jc[2].count))
        np.testing.assert_allclose(interop.horizon_to_numpy(tc[3]),
                                   np.asarray(jc[3]), rtol=1e-8, atol=0)
        assert int(tc[4]) == int(jc[4]) and int(tc[5]) == int(jc[5])
    assert spiked > 2                     # the spike_cap fallback ran too
