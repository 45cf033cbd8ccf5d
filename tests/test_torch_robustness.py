"""Preemption tolerance of the port's single-device runners: round-boundary
``SimCarry`` checkpoints, kill and resume, the watchdog's rollback and
its escalation (``repro_torch.core.exec_common.run_checkpointed``).

The port's ``run()`` is a host loop over ``round_body``, and a robust run
drives the very same rounds, so every robust run here is held BITWISE to
the plain ``run()``: spike trains, steps, solver counters, every counter
and the final state.  Against live JAX (3 ms, before the two step
sequences drift apart, ROADMAP §3) the ``health`` records and every
counter are equal, and a JAX carry handed across by ``interop`` runs round
by round within ``test_torch_exec_fap.py::test_rounds_from_jax_carry``'s
tolerances.  Config: soma, N = 12, k_in 4, seed 3, 0.16 nA, 6 ms.
"""
import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.checkpoint import FaultPlan, SimulatedFailure
from repro_torch.core import exec_bsp, exec_fap, morphology, network
from repro_torch.core import exec_common as xc
from repro_torch.core.cell import CellModel
from repro_torch.sched import WheelSpec

N, T_END = 12, 6.0
T_JAX = 3.0           # ms: every counter exact against JAX (ROADMAP §3)
T_REL = 1e-8          # clocks and steps, round by round from JAX's carry

CONFIGS = {
    "dense": dict(),
    "wheel": dict(queue="wheel"),
    "compact": dict(batch="compact", batch_cap=8),
    "compact-wheel": dict(batch="compact", batch_cap=8, queue="wheel"),
}


def _iinj():
    return 0.16           # nA, every neuron (ROADMAP §3, slice 1)


def _net():
    return network.make_network(N, k_in=4, seed=3)


@pytest.fixture(scope="module")
def model():
    return CellModel(morphology.soma_only(), device="cpu")


@pytest.fixture(scope="module")
def runners(model):
    net = _net()
    out = {}
    for name, kw in CONFIGS.items():
        kw = dict(kw)
        if kw.get("queue") == "wheel":
            kw["wheel"] = WheelSpec.auto(net)
        out[name] = exec_fap.make_fap_vardt_runner(model, net, _iinj(), T_END,
                                                   device="cpu", **kw)
    return out


@pytest.fixture(scope="module")
def plain(runners):
    """The plain ``run()`` of each config: the identity target."""
    out = {}
    for name, run in runners.items():
        res, rounds = run()
        assert not bool(res.failed) and int(res.dropped) == 0
        assert int(res.rec.count.sum()) > 0 and res.health is None
        out[name] = (res, rounds)
    return out


def _same(a, b):
    """Bitwise: spike trains, every counter and the final state."""
    assert torch.equal(a.rec.times, b.rec.times)
    assert torch.equal(a.rec.count, b.rec.count)
    assert int(a.rec.overflow) == int(b.rec.overflow)
    for f in ("n_steps", "n_events", "n_resets", "dropped", "y_final"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert bool(a.failed) == bool(b.failed)
    assert {k: int(v) for k, v in a.solver.items()} == \
        {k: int(v) for k, v in b.solver.items()}
    assert [int(x) for x in a.sched] == [int(x) for x in b.sched]


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_watchdog_run_is_the_plain_run(runners, plain, cfg):
    res, rounds = runners[cfg](watchdog=True)
    p, pr = plain[cfg]
    _same(res, p)
    assert rounds == pr and type(rounds) is int
    h = res.health
    assert h["watchdog"] and h["checks"] == rounds
    assert h["nonfinite_rounds"] == h["clock_regressions"] == 0
    assert h["horizon_violations"] == h["rollbacks"] == 0
    assert h["dropped_events"] == 0 and not h["rollback_exhausted"]
    assert h["checkpoints_saved"] == 0 and h["resumed_from"] is None
    assert h["straggler"]["recorded"] == rounds


@pytest.mark.parametrize("every", [1, 3])
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_kill_resume_bitwise(runners, plain, cfg, every, tmp_path):
    run = runners[cfg]
    p, rounds0 = plain[cfg]
    kill = int(rounds0 * 0.6)
    with pytest.raises(SimulatedFailure) as e:
        run(checkpoint_every=every, ckpt_dir=str(tmp_path),
            fault=FaultPlan(fail_at_round=kill))
    assert e.value.step == kill
    res, rounds = run(checkpoint_every=every, ckpt_dir=str(tmp_path),
                      resume=True)
    _same(res, p)
    assert rounds == rounds0
    assert res.health["resumed_from"] == (kill // every) * every
    assert res.health["checks"] == rounds0 - res.health["resumed_from"]


@pytest.mark.parametrize("cfg", ["dense", "compact-wheel"])
def test_poisoned_lane_rolled_back_bitwise(runners, plain, cfg, tmp_path):
    res, _ = runners[cfg](checkpoint_every=4, ckpt_dir=str(tmp_path),
                          fault=FaultPlan(poison_at_round=9, poison_lane=3))
    assert res.health["nonfinite_rounds"] == 1
    assert res.health["rollbacks"] == 1
    assert not bool(res.failed) and not res.health["rollback_exhausted"]
    _same(res, plain[cfg][0])


def test_poison_before_any_checkpoint_restarts_from_init(runners, plain):
    res, _ = runners["dense"](fault=FaultPlan(poison_at_round=2,
                                              poison_lane=0))
    assert res.health["rollbacks"] == 1
    _same(res, plain["dense"][0])


def test_exhausted_retries_fail(runners, tmp_path):
    res, _ = runners["dense"](
        checkpoint_every=4, ckpt_dir=str(tmp_path), max_rollbacks=1,
        fault=FaultPlan(mutate=lambda r, c: xc.poison_lane(c, 0)))
    assert bool(res.failed)
    assert res.health["rollback_exhausted"]
    assert res.health["rollbacks"] == 1
    assert res.health["nonfinite_rounds"] == 2


def test_knobs_need_a_directory(runners):
    with pytest.raises(ValueError, match="ckpt_dir"):
        runners["dense"](checkpoint_every=2)


def test_simcarry_roundtrips_every_field(runners, tmp_path):
    """Every leaf of a mid-run carry -- the BDF state with its factor
    cache, the queue, the record, the incremental horizon and the counters
    (``rounds`` a Python int) -- comes back bitwise and of its kind."""
    run = runners["compact"]
    assert run.incremental
    c = run.init_carry()
    for _ in range(5):
        c = run.round_body(c)
    sc = run.pack(c)
    assert len(sc.hcarry) == 1 and type(sc.counters["rounds"]) is int
    xc.save_sim_checkpoint(str(tmp_path), 5, sc, extras={"k": 1})
    like = run.pack(run.init_carry())
    sc2, extras, skipped = xc.restore_sim_checkpoint(str(tmp_path), 5, like)
    assert extras == {"k": 1} and skipped == []
    import torch.utils._pytree as pt
    la, ta = pt.tree_flatten(sc)
    lb, tb = pt.tree_flatten(sc2)
    assert str(ta) == str(tb) and len(la) == len(lb)
    for a, b in zip(la, lb):
        assert type(a) is type(b)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b
    for f in ("gamma_saved", "nstlp", "factors", "jbad"):
        assert torch.equal(getattr(sc.sts, f), getattr(sc2.sts, f))


def test_elastic_skip_reports_hcarry_only(runners, tmp_path):
    run = runners["compact"]
    sc = run.pack(run.init_carry())
    xc.save_sim_checkpoint(str(tmp_path), 1, sc)
    like = sc._replace(hcarry=(torch.zeros(N // 2, dtype=torch.float64),))
    sc2, _, skipped = xc.restore_sim_checkpoint(str(tmp_path), 1, like)
    assert skipped == [".hcarry[0]"]
    assert torch.equal(sc2.sts.zn, sc.sts.zn)
    assert sc2.hcarry[0].shape == (N // 2,)
    bad = sc._replace(sts=sc.sts._replace(zn=sc.sts.zn[:, :2]))
    _, _, skipped = xc.restore_sim_checkpoint(str(tmp_path), 1, bad)
    assert skipped == [".sts.zn"]


@pytest.mark.parametrize("batch", ["dense", "compact"])
def test_bsp_kill_resume_bitwise(model, batch, tmp_path):
    run = exec_bsp.make_bsp_vardt_runner(model, _net(), _iinj(), 3.0,
                                         batch=batch, batch_cap=5,
                                         device="cpu")
    p = run()
    assert int(p.rec.count.sum()) > 0
    with pytest.raises(SimulatedFailure):
        run(checkpoint_every=10, ckpt_dir=str(tmp_path),
            fault=FaultPlan(fail_at_round=25))
    res = run(checkpoint_every=10, ckpt_dir=str(tmp_path), resume=True)
    assert res.health["resumed_from"] == 20
    assert res.health["checks"] == int(np.ceil(3.0 / 0.1)) - 20
    _same(res, p)


def test_fixed_step_runners_take_no_knobs(model):
    run = exec_fap.make_fap_fixed_runner(model, _net(), 0.16, 1.0,
                                         device="cpu")
    with pytest.raises(TypeError):
        run(watchdog=True)
    run = exec_bsp.make_bsp_fixed_runner(model, _net(), 0.16, 1.0,
                                         device="cpu")
    with pytest.raises(TypeError):
        run(watchdog=True)


# --- against live JAX -------------------------------------------------------

HEALTH_KEYS = ("checks", "rollbacks", "nonfinite_rounds", "checkpoints_saved",
               "resumed_from", "rollback_exhausted")


@pytest.fixture(scope="module")
def jax_pair(model):
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    from repro.core import exec_fap as jfap
    from repro.core import morphology as jmorph
    from repro.core import network as jnet
    from repro.core.cell import CellModel as JCell
    jrun = jfap.make_fap_vardt_runner(
        JCell(jmorph.soma_only()), jnet.make_network(N, k_in=4, seed=3),
        _iinj(), T_JAX, horizon_impl="fused")
    trun = exec_fap.make_fap_vardt_runner(model, _net(), _iinj(), T_JAX,
                                          horizon_impl="fused", device="cpu")
    return jax, jrun, trun


def _counters(res, rounds):
    return {"n_steps": int(res.n_steps), "n_events": int(res.n_events),
            "n_resets": int(res.n_resets), "dropped": int(res.dropped),
            "failed": bool(res.failed), "rounds": int(rounds),
            "count": np.asarray(res.rec.count).tolist(),
            "solver": {k: int(v) for k, v in res.solver.items()},
            "sched": [int(x) for x in res.sched]}


@pytest.mark.parametrize("scenario", ["poison", "kill-resume", "exhausted"])
def test_health_and_counters_match_jax(jax_pair, scenario, tmp_path):
    jax, jrun, trun = jax_pair
    from repro.checkpoint import FaultPlan as JFault
    from repro.checkpoint import SimulatedFailure as JFailure
    from repro.core import exec_common as jxc
    out = {}
    for side, run, Fault, Failure, poison in (
            ("jax", jrun, JFault, JFailure, jxc.poison_lane),
            ("port", trun, FaultPlan, SimulatedFailure, xc.poison_lane)):
        d = str(tmp_path / side)
        if scenario == "poison":
            res, rounds = run(checkpoint_every=3, ckpt_dir=d,
                              fault=Fault(poison_at_round=7, poison_lane=4))
        elif scenario == "exhausted":
            res, rounds = run(checkpoint_every=3, ckpt_dir=d,
                              max_rollbacks=1,
                              fault=Fault(poison_at_round=4,
                                          mutate=lambda r, c, p=poison:
                                          p(c, 1) if r >= 6 else c))
        else:
            with pytest.raises(Failure):
                run(checkpoint_every=4, ckpt_dir=d,
                    fault=Fault(fail_at_round=10))
            res, rounds = run(checkpoint_every=4, ckpt_dir=d, resume=True)
        out[side] = ({k: res.health[k] for k in HEALTH_KEYS},
                     _counters(res, rounds))
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    if scenario == "exhausted":
        assert out["port"][0]["rollback_exhausted"]
    else:
        assert sum(out["port"][1]["count"]) > 0


def test_rounds_from_a_jax_simcarry(jax_pair):
    """A JAX ``SimCarry`` carried across by ``interop.sim_carry_from_numpy``
    runs round by round in the port: integers exact, clocks and steps
    within 1e-8 relative, every round from JAX's own carry."""
    jax, jrun, trun = jax_pair
    jround = jax.jit(jrun.round_body)
    npy = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    jc = jrun.init_carry()
    ints = ("q", "nst", "nfe", "nni", "netf", "nncf", "nreset", "nsetups",
            "qwait", "failed", "jbad")
    for r in range(10):
        sc = interop.sim_carry_from_numpy(npy(jrun.pack(jc)), "cpu")
        assert sc.counters["rounds"] == r
        tc = trun.round_body(trun.unpack(sc))
        jc = jround(jc)
        got = interop.sim_carry_to_numpy(trun.pack(tc))
        want = npy(jrun.pack(jc))
        for k in ints:
            assert np.array_equal(got["sts"][k], getattr(want.sts, k)), k
        for k in ("t", "h"):
            np.testing.assert_allclose(got["sts"][k], getattr(want.sts, k),
                                       rtol=T_REL, atol=0, err_msg=k)
        assert np.array_equal(np.isfinite(got["eq"]["t"]),
                              np.isfinite(want.eq.t))
        assert np.array_equal(got["rec"]["count"], want.rec.count)
        for k in ("n_ev", "n_rs", "rounds"):
            assert int(got["counters"][k]) == int(want.counters[k]), k
        assert [int(v) for v in got["counters"]["stats"].values()] == \
            [int(v) for v in want.counters["stats"]]
