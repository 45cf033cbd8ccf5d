"""The port's carefully-speculative FAP runner (``core/exec_speculative.py``)
against live JAX and against the port's own non-speculative 2c runner,
on the CPU.

* ``tests/test_speculative.py``'s three checks on the port (40 ms, N = 16):
  quiet networks validate speculation and take fewer validated steps than
  2c; an active network keeps 2c's physics; the hit and backstep counters
  move.
* Live JAX, 3 ms (first spikes and deliveries): ``SpecStats``, rounds,
  steps, every solver counter, spike counts and events equal, spike times
  within 1e-6 ms, under the dense and compact fan-outs and the wheel.
  Later the step sequences drift by a step as 2c's do (ROADMAP §3).
* Compact fan-out equals dense fan-out event for event, the dense fallback
  of a small spike cap included.
* Backsteps: a round's validation reads the queue as it stood when the
  speculation was decided, so in a plain run no event can land inside a
  speculated span and ``backsteps`` stays 0 -- in the reference too.  The
  restore path is driven here by inserting such an event by hand: the
  lane gets its snapshot back bit for bit, its held spike is dropped and
  the wasted steps are counted; and no later round writes into a
  snapshot it has handed on.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)

from repro.core import exec_speculative as jspec  # noqa: E402
from repro.core import morphology as jmorph  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.core.cell import CellModel as JCell  # noqa: E402
from repro.sched import WheelSpec as JWheelSpec  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core import exec_fap as tfap  # noqa: E402
from repro_torch.core import exec_speculative as tspec  # noqa: E402
from repro_torch.core import morphology as tmorph  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core.cell import CellModel as TCell  # noqa: E402
from repro_torch.sched import WheelSpec  # noqa: E402

T = 40.0          # ms, the JAX tests' runs
T_FULL = 3.0      # ms, full-parity horizon against live JAX
T_TOL = 1e-6      # ms, spike times
N = 16


@pytest.fixture(scope="module")
def setup():
    return (TCell(tmorph.soma_only(), device="cpu"),
            tnet.make_network(N, k_in=4, seed=5))


def _iinj(base, seed):
    rng = np.random.default_rng(seed)
    return base + 0.004 * rng.standard_normal(N)


def _trains(res):
    ts, c = res.rec.times.numpy(), res.rec.count.numpy()
    return [np.sort(ts[i][: c[i]]) for i in range(len(c))]


# ------------------------------------- tests/test_speculative.py, ported --
def test_quiet_speculation_validates_and_extends_steps(setup):
    model, net = setup
    iinj = np.zeros(N)
    res, stats, _ = tspec.make_spec_runner(model, net, iinj, T,
                                           spec_window=4.0, device="cpu")()
    assert not bool(res.failed)
    assert int(stats.backsteps) == 0              # nothing to invalidate
    assert int(stats.hits) > 0                    # speculation engaged
    r_ns = tfap.run_fap_vardt(model, net, iinj, T, device="cpu")
    assert int(res.n_steps) < int(r_ns.n_steps)


def test_active_network_matches_nonspeculative_physics(setup):
    model, net = setup
    iinj = _iinj(0.16, 2)
    res, stats, _ = tspec.make_spec_runner(model, net, iinj, T,
                                           device="cpu")()
    assert not bool(res.failed)
    assert int(res.dropped) == 0
    r_ns = tfap.run_fap_vardt(model, net, iinj, T, device="cpu")
    ta, tb = _trains(res), _trains(r_ns)
    assert sum(len(a) != len(b) for a, b in zip(ta, tb)) <= 2
    for a, b in zip(ta, tb):
        if len(a) == len(b) and len(a):
            assert np.abs(a - b).max() < 0.25
    tot_a, tot_b = sum(map(len, ta)), sum(map(len, tb))
    assert tot_b > 0 and abs(tot_a - tot_b) <= max(2, 0.1 * tot_b)


def test_backsteps_are_local_and_counted(setup):
    model, net = setup
    res, stats, _ = tspec.make_spec_runner(model, net, _iinj(0.17, 3), T,
                                           spec_window=4.0, device="cpu")()
    assert not bool(res.failed)
    assert int(stats.backsteps) + int(stats.hits) > 0
    assert int(stats.wasted_steps) >= int(stats.backsteps)


# ------------------------------------------------------------- live JAX --
KNOBS = {"dense": {}, "compact": dict(fanout="compact"),
         "wheel-compact": dict(fanout="compact", queue="wheel")}


@pytest.mark.parametrize("knobs", list(KNOBS))
def test_matches_live_jax(knobs):
    kw = dict(KNOBS[knobs], spec_window=4.0)
    iinj = _iinj(0.17, 3)
    jnet_ = jnet.make_network(N, k_in=4, seed=5)
    tnet_ = tnet.make_network(N, k_in=4, seed=5)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("queue") == "wheel":
        jkw["wheel"] = JWheelSpec.auto(jnet_)
        tkw["wheel"] = WheelSpec.auto(tnet_)
        assert tuple(tkw["wheel"]) == tuple(jkw["wheel"])
    jr, js, jrounds = jspec.make_spec_runner(JCell(jmorph.soma_only()),
                                             jnet_, iinj, T_FULL, **jkw)()
    tr, ts, trounds = tspec.make_spec_runner(
        TCell(tmorph.soma_only(), device="cpu"), tnet_, iinj, T_FULL,
        device="cpu", **tkw)()
    got = interop.spec_stats_to_numpy(ts)
    for k, v in interop.spec_stats_to_numpy(
            interop.spec_stats_from_numpy(
                jax.tree_util.tree_map(np.asarray, js), "cpu")).items():
        assert int(got[k]) == int(v), k
    assert int(ts.hits) > 0 and int(ts.held_spikes) > 0
    assert trounds == int(jrounds)
    jcount = np.asarray(jr.rec.count)
    assert jcount.sum() > 0
    assert np.array_equal(tr.rec.count.numpy(), jcount)
    jt, tt = np.asarray(jr.rec.times), tr.rec.times.numpy()
    fin = np.isfinite(jt)
    assert np.array_equal(np.isfinite(tt), fin)
    np.testing.assert_allclose(tt[fin], jt[fin], rtol=0, atol=T_TOL)
    for k in ("n_steps", "n_events", "n_resets", "dropped", "failed"):
        assert int(getattr(tr, k)) == int(getattr(jr, k)), k
    for k, v in jr.solver.items():
        assert int(tr.solver[k]) == int(v), k


# ------------------------------------------------------------ port alone --
@pytest.mark.parametrize("queue", ["dense", "wheel"])
def test_compact_fanout_equals_dense(setup, queue):
    """15 ms at 0.17 nA: compact fan-out (spike cap 2, so crowded rounds
    take the dense fallback) equals dense fan-out event for event."""
    model, net = setup
    kw = dict(queue=queue, spec_window=4.0, device="cpu")
    if queue == "wheel":
        kw["wheel"] = WheelSpec.auto(net)
    iinj = _iinj(0.17, 3)
    a, sa, ra = tspec.make_spec_runner(model, net, iinj, 15.0, **kw)()
    b, sb, rb = tspec.make_spec_runner(model, net, iinj, 15.0,
                                       fanout="compact", spike_cap=2, **kw)()
    assert int(a.rec.count.sum()) > 2
    assert ra == rb
    assert torch.equal(a.rec.times, b.rec.times)
    assert torch.equal(a.rec.count, b.rec.count)
    assert torch.equal(a.y_final, b.y_final)
    for k in ("n_steps", "n_events", "n_resets", "dropped"):
        assert int(getattr(a, k)) == int(getattr(b, k)), k
    assert all(int(x) == int(y) for x, y in zip(sa, sb))


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return type(x)(*[_clone(y) for y in x]) if hasattr(x, "_fields") \
            else tuple(_clone(y) for y in x)
    return x


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_forced_backstep_restores_the_exact_snapshot(setup):
    model, net = setup
    run = tspec.make_spec_runner(model, net, _iinj(0.17, 3), 15.0,
                                 spec_window=4.0, device="cpu")
    carry = run.init_carry()
    seen_held = False
    while run.cond(carry):
        handed, copy = carry, _clone(carry)
        carry = run.round_body(handed)
        # the round never writes into the tuple it was handed: the
        # snapshot it hands on stays what it was
        assert _equal(handed, copy)
        sts, snap, spec_on, held_sp = carry[:4]
        ahead = spec_on & (sts.nst > snap.nst)
        seen_held |= bool((ahead & held_sp).any())
        if seen_held and bool((ahead & held_sp).any()):
            break
    assert seen_held, "no lane held a spike inside a speculated span"
    sts, snap, spec_on, held_sp, held_t, eq = carry[:6]
    lane = int(torch.nonzero(spec_on & held_sp & (sts.nst > snap.nst))[0])
    snap_copy = _clone(snap)
    # an event inside the lane's speculated span (snapshot clock < t <
    # speculated clock), as a late spike of another rank would bring
    t_ev = 0.5 * (float(snap.t[lane]) + float(sts.t[lane]))
    one = torch.ones((1,), dtype=torch.bool)
    eq = ev.insert(eq, torch.tensor([lane]), torch.tensor([t_ev],
                   dtype=torch.float64), torch.tensor([1e-4],
                   dtype=torch.float64), torch.zeros((1,),
                   dtype=torch.float64), one)
    carry = carry[:5] + (eq,) + carry[6:]
    out = run.validate(carry)
    r_sts, r_held, r_stats = out[0], out[3], out[9]
    others = torch.arange(N) != lane
    for f_new, f_snap, f_old in zip(r_sts, snap_copy, sts):
        assert torch.equal(f_new[lane], f_snap[lane])      # bit for bit
        assert torch.equal(f_new[others], f_old[others])
    assert not bool(r_held[lane]) and torch.equal(r_held[others],
                                                  held_sp[others])
    stats = carry[9]
    assert int(r_stats.backsteps) == int(stats.backsteps) + 1
    assert int(r_stats.wasted_steps) == int(stats.wasted_steps) + \
        int(sts.nst[lane] - snap.nst[lane])
    assert int(r_stats.hits) == int(stats.hits) + int(spec_on.sum()) - 1
    # the run goes on from the backstep: the late event is delivered
    while run.cond(carry):
        carry = run.round_body(carry)
    sts, snap = carry[:2]
    assert not bool(sts.failed.any()) and int(carry[5].dropped) == 0
    assert float(snap.t.min()) >= 15.0 - 1e-9
    assert int(carry[9].backsteps) == int(stats.backsteps) + 1
