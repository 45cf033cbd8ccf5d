"""Tenant-isolated simulation serving in the port (``repro_torch.serve``),
the cases of ``tests/test_serve.py`` (soma, N = 10, 6 ms, 3 lanes).

The isolation contract: a tenant's lanes never mix with another's and an
inactive tenant's round leaves its state as it was, so its spike train is
BITWISE the same solo, in a full batch, next to a poisoned neighbour or
through its own quarantine and retry.  Every request ends in exactly one
of completed, evicted or rejected (``ServeResult.assert_accounting``).

Against live JAX: ``SimService`` on the same seeded requests, with a
straggler monitor that never flags and no wall deadlines, so that every
decision is deterministic, gives each request the same status, reason and
retries, and completed tenants the same spike counts; and
``run.tenant_round`` from one batched carry (handed across by
``interop.tenant_carry_from_numpy``) matches JAX's vmapped round with
mixed ``active`` and ``k_qos``: integers exact, clocks and steps within
1e-8 relative (``test_torch_exec_fap.py::test_rounds_from_jax_carry``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.checkpoint import (ExponentialBackoff, FaultPlan,
                                    StragglerMonitor, latest_tenant_step,
                                    list_tenants, restore_tenant_checkpoint)
from repro_torch.core import exec_fap, morphology, network
from repro_torch.core.cell import CellModel
from repro_torch.serve import (SimService, TenantRequest, lane_slice,
                               stack_lanes, write_lane)

ROOT = os.path.join(os.path.dirname(__file__), "..")
N = 10
T_END = 6.0
LANES = 3
T_REL = 1e-8


@pytest.fixture(scope="module")
def runner():
    model = CellModel(morphology.soma_only(), device="cpu")
    net = network.make_network(N, k_in=4, seed=3)
    return exec_fap.make_fap_vardt_runner(model, net, 0.0, T_END,
                                          device="cpu")


def _reqs(n=3, **kw):
    return [TenantRequest(rid=r, iinj=0.14 + 0.012 * r, **kw)
            for r in range(n)]


def _svc(runner, **kw):
    kw.setdefault("lanes", LANES)
    return SimService(runner=runner, t_end=T_END, **kw)


def _run(runner, reqs, **kw):
    svc = _svc(runner, **kw)
    for r in reqs:
        svc.submit(r)
    return svc.run()


def _spikes(res, rid):
    r = res.results[rid]
    assert r.status == "completed", r
    return r.times, r.count


@pytest.fixture(scope="module")
def batch_baseline(runner):
    res = _run(runner, _reqs())
    assert res.completed == 3 and res.evicted == res.rejected == 0
    return res


@pytest.fixture(scope="module")
def solo_baselines(runner):
    out = {}
    for r in _reqs():
        res = _run(runner, [r], lanes=1)
        assert res.completed == 1
        out[r.rid] = _spikes(res, r.rid)
    return out


def test_solo_vs_batch_identity(batch_baseline, solo_baselines):
    for rid in range(3):
        tb, cb = _spikes(batch_baseline, rid)
        ts, cs = solo_baselines[rid]
        assert cb.sum() > 0
        assert np.array_equal(tb, ts) and np.array_equal(cb, cs)


def test_tenant_equals_the_plain_runner_at_its_current(runner,
                                                       batch_baseline):
    """Without a QoS cap a tenant's round is the plain runner's round."""
    model = CellModel(morphology.soma_only(), device="cpu")
    res, rounds = exec_fap.make_fap_vardt_runner(
        model, network.make_network(N, k_in=4, seed=3), _reqs()[1].iinj,
        T_END, device="cpu")()
    tb, cb = _spikes(batch_baseline, 1)
    assert np.array_equal(res.rec.times.numpy(), tb)
    assert batch_baseline.results[1].rounds == rounds


def test_poison_quarantine_retry_identity(runner, batch_baseline,
                                          solo_baselines):
    fault = FaultPlan(poison_at_round=8, poison_tenant=1, poison_lane=2)
    res = _run(runner, _reqs(), fault=fault)
    assert res.completed == 3
    assert res.quarantines >= 1 and res.retried >= 1
    assert res.results[1].retries >= 1
    assert res.results[1].health["nonfinite_rounds"] >= 1
    for rid in range(3):
        tp, cp = _spikes(res, rid)
        tb, cb = _spikes(batch_baseline, rid)
        assert np.array_equal(tp, tb), f"rid {rid} perturbed by the fault"
        assert np.array_equal(cp, cb)
        assert np.array_equal(tp, solo_baselines[rid][0])


def test_retry_exhaustion_evicts(runner, batch_baseline):
    reqs = [TenantRequest(rid=0, iinj=0.14),
            TenantRequest(rid=1, iinj=0.152, max_retries=0),
            TenantRequest(rid=2, iinj=0.164)]
    fault = FaultPlan(poison_at_round=5, poison_tenant=1, poison_lane=0)
    res = _run(runner, reqs, fault=fault)
    assert res.results[1].status == "evicted"
    assert res.results[1].reason == "retries_exhausted"
    assert res.evicted == 1 and res.completed == 2
    for rid in (0, 2):
        tp, cp = _spikes(res, rid)
        tb, cb = _spikes(batch_baseline, rid)
        assert np.array_equal(tp, tb) and np.array_equal(cp, cb)


def test_deadline_eviction(runner):
    reqs = [TenantRequest(rid=0, iinj=0.15, deadline_rounds=3),
            TenantRequest(rid=1, iinj=0.15)]
    res = _run(runner, reqs)
    assert res.results[0].status == "evicted"
    assert res.results[0].reason == "deadline_rounds"
    assert res.results[0].rounds == 3
    assert res.results[1].status == "completed"


def test_queue_full_sheds_lowest_qos(runner):
    svc = _svc(runner, queue_cap=3)
    hi = [TenantRequest(rid=r, iinj=0.15, qos=2) for r in range(3)]
    lo = [TenantRequest(rid=10 + r, iinj=0.15, qos=0) for r in range(3)]
    for r in lo + hi:
        svc.submit(r)
    with pytest.raises(ValueError, match="duplicate"):
        svc.submit(hi[0])
    res = svc.run()
    assert res.shed == 3 and res.rejected == 3
    for r in lo:
        assert res.results[r.rid].status == "rejected"
        assert res.results[r.rid].reason == "shed:queue_full"
    for r in hi:
        assert res.results[r.rid].status == "completed"


def test_overload_shed_on_sustained_regression(runner):
    mon = StragglerMonitor(window=32, threshold=2.0)
    for _ in range(10):
        mon.record(0.01)
    for _ in range(8):
        mon.record(1.0)
    assert mon.sustained()
    svc = _svc(runner, straggler=mon, queue_cap=8)
    for r in _reqs(LANES, qos=2):
        svc.submit(r)
    svc.submit(TenantRequest(rid=99, iinj=0.15, qos=0))
    assert svc.step()
    assert svc.res.results[99].status == "rejected"
    assert svc.res.results[99].reason == "shed:overload"
    res = svc.run()
    assert res.shed == 1 and res.completed == LANES
    assert res.health["straggler"]["threshold"] == 2.0


def test_qos_frontier_cap_slows_not_starves(runner):
    fast = _run(runner, [TenantRequest(rid=0, iinj=0.15, qos=1)])
    slow = _run(runner, [TenantRequest(rid=0, iinj=0.15, qos=0)],
                qos_caps={0: 2})
    assert fast.results[0].status == slow.results[0].status == "completed"
    assert slow.results[0].rounds > fast.results[0].rounds


def test_per_tenant_checkpoints(runner, tmp_path):
    res = _run(runner, _reqs(2), ckpt_dir=str(tmp_path), checkpoint_every=5)
    assert res.completed == 2 and res.health["snapshots_saved"] > 0
    assert list_tenants(str(tmp_path)) == [0, 1]
    for rid in (0, 1):
        step = latest_tenant_step(str(tmp_path), rid)
        assert step is not None and step % 5 == 0
        like = runner.pack(runner.init_carry(0.0))
        carry, extras = restore_tenant_checkpoint(str(tmp_path), rid, step,
                                                  like)
        assert extras["tenant"] == rid and extras["rid"] == rid
        assert type(carry.counters["rounds"]) is int
        assert carry.counters["rounds"] == step
        assert torch.isfinite(carry.sts.t).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_partition_seeded(runner, seed):
    rng = np.random.default_rng(seed)
    bo = ExponentialBackoff(max_retries=2)
    fault = FaultPlan(poison_at_round=3,
                      poison_tenant=int(rng.integers(0, 6)),
                      poison_lane=int(rng.integers(0, N)))
    svc = _svc(runner, queue_cap=int(rng.integers(1, 5)), backoff=bo,
               fault=fault, qos_caps={0: 3})
    n_req = int(rng.integers(1, 8))
    for rid in range(n_req):
        svc.submit(TenantRequest(
            rid=rid, iinj=float(0.13 + 0.03 * rng.random()),
            qos=int(rng.integers(0, 3)),
            deadline_rounds=int(rng.integers(0, 2) * rng.integers(2, 30))))
    res = svc.run(max_rounds=2000)
    res.assert_accounting()
    assert res.submitted == n_req
    for r in res.results.values():
        assert r.retries <= bo.max_retries
        assert (r.status == "completed") == (r.times is not None)


def test_lane_plumbing_never_mixes_lanes(runner):
    a, b = runner.init_carry(0.14), runner.init_carry(0.16)
    batched = stack_lanes([a, a, a])
    assert batched[-1].tolist() == [0, 0, 0]
    out = write_lane(batched, 1, lane_slice(stack_lanes([b]), 0))
    assert torch.equal(out[0].zn[1], b[0].zn)
    assert torch.equal(out[0].zn[0], a[0].zn)
    assert torch.equal(batched[0].zn[1], a[0].zn)      # input untouched
    snap = lane_slice(out, 2)
    snap[0].zn.fill_(0.0)
    assert torch.equal(out[0].zn[2], a[0].zn)          # a copy


def test_compact_knobs_refused(runner):
    """The compact batch and fan-out, once refused by ``tenant_round``, are
    served: one round of two tenants moves both, and a ``SimService``
    over the compact runner completes its tenants
    (``tests/test_torch_serve_compact.py`` holds them to JAX)."""
    model = CellModel(morphology.soma_only(), device="cpu")
    run = exec_fap.make_fap_vardt_runner(
        model, network.make_network(N, k_in=4, seed=3), 0.0, T_END,
        batch="compact", batch_cap=4, fanout="compact", spike_cap=2,
        device="cpu")
    carry = stack_lanes([run.init_carry(0.15)] * 2)
    out = run.tenant_round(carry, torch.full((2,), 0.15),
                           torch.ones(2, dtype=torch.bool))
    assert out[0].t.shape == (2, N) and bool((out[0].t > 0).any(dim=1).all())
    assert out[-2].lanes.tolist() == [4, 4]
    svc = SimService(runner=run, t_end=1.0, lanes=2)
    for r in _reqs(2):
        svc.submit(r)
    res = svc.run()
    assert res.completed == 2


def test_sim_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--sim",
         "--device", "cpu", "--n", "8", "--tenants", "4", "--lanes", "2",
         "--t-end", "2", "--poison-tenant", "1", "--poison-round", "2"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("served 4 tenants in ")
    assert "4 completed, 0 evicted, 0 rejected (0 shed)" in lines[0]
    assert "1 retries / 1 quarantines" in lines[0]
    assert lines[1].startswith("admission wait: mean ")


# --- against live JAX -------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runner():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    from repro.core import exec_fap as jfap
    from repro.core import morphology as jmorph
    from repro.core import network as jnet
    from repro.core.cell import CellModel as JCell
    return jfap.make_fap_vardt_runner(JCell(jmorph.soma_only()),
                                      jnet.make_network(N, k_in=4, seed=3),
                                      0.0, T_END)


def _seeded_service(svc_cls, req_cls, fault_cls, mon_cls, bo_cls, runner,
                    seed):
    """A seeded request mix of ``test_admission_partition_seeded`` without
    wall deadlines, under a straggler monitor that never flags."""
    rng = np.random.default_rng(seed)
    fault = fault_cls(poison_at_round=3,
                      poison_tenant=int(rng.integers(0, 6)),
                      poison_lane=int(rng.integers(0, N)))
    svc = svc_cls(runner=runner, t_end=T_END, lanes=LANES,
                  queue_cap=int(rng.integers(1, 5)),
                  backoff=bo_cls(max_retries=2), fault=fault,
                  qos_caps={0: 3}, straggler=mon_cls(threshold=1e12))
    for rid in range(int(rng.integers(3, 8))):
        svc.submit(req_cls(
            rid=rid, iinj=float(0.13 + 0.03 * rng.random()),
            qos=int(rng.integers(0, 3)),
            deadline_rounds=int(rng.integers(0, 2) * rng.integers(2, 30))))
    return svc.run(max_rounds=2000)


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_service_decisions_match_jax(runner, jax_runner, seed):
    from repro.checkpoint import ExponentialBackoff as JBackoff
    from repro.checkpoint import FaultPlan as JFault
    from repro.checkpoint.fault_tolerance import StragglerMonitor as JMon
    from repro.serve import SimService as JService
    from repro.serve import TenantRequest as JRequest
    got = _seeded_service(SimService, TenantRequest, FaultPlan,
                          StragglerMonitor, ExponentialBackoff, runner, seed)
    want = _seeded_service(JService, JRequest, JFault, JMon, JBackoff,
                           jax_runner, seed)
    for k in ("submitted", "admitted", "completed", "evicted", "rejected",
              "retried", "quarantines", "shed", "rounds"):
        assert getattr(got, k) == getattr(want, k), k
    assert sorted(got.results) == sorted(want.results)
    for rid, w in want.results.items():
        g = got.results[rid]
        assert (g.status, g.reason, g.retries, g.rounds, g.wait_rounds) == \
            (w.status, w.reason, w.retries, w.rounds, w.wait_rounds), rid
        if w.status == "completed":
            assert np.array_equal(g.count, np.asarray(w.count)), rid
            assert g.count.sum() > 0


@pytest.mark.parametrize("knobs", [
    dict(),
    dict(horizon_impl="fused", queue="wheel", k_select=4,
         select="threshold"),
    dict(horizon_impl="fused", k_select=3),
])
def test_tenant_round_matches_jax(knobs):
    """Each of 8 rounds from JAX's batched carry: four tenants, mixed
    ``active`` and ``k_qos`` (one tenant masked out, two QoS caps)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    from repro import sched as jsched
    from repro.core import exec_fap as jfap
    from repro.core import morphology as jmorph
    from repro.core import network as jnet
    from repro.core.cell import CellModel as JCell
    from repro.serve.tenants import stack_lanes as jstack
    from repro_torch import sched
    kw = dict(knobs)
    jkw = dict(knobs)
    if kw.get("queue") == "wheel":
        kw["wheel"] = sched.WheelSpec.auto(network.make_network(N, 4, seed=3))
        jkw["wheel"] = jsched.WheelSpec.auto(jnet.make_network(N, 4, seed=3))
    jrun = jfap.make_fap_vardt_runner(JCell(jmorph.soma_only()),
                                      jnet.make_network(N, k_in=4, seed=3),
                                      0.0, T_END, **jkw)
    trun = exec_fap.make_fap_vardt_runner(
        CellModel(morphology.soma_only(), device="cpu"),
        network.make_network(N, k_in=4, seed=3), 0.0, T_END, device="cpu",
        **kw)
    iinj = np.array([0.15, 0.17, 0.16, 0.2])
    jround = jax.jit(jax.vmap(jrun.tenant_round, in_axes=(0, 0, 0, 0)))
    jc = jstack([jrun.init_carry(i) for i in iinj])
    npy = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    ints = ("q", "nst", "nfe", "nni", "netf", "nncf", "nreset", "nsetups",
            "qwait", "failed", "jbad")
    for r in range(8):
        active = np.array([True, r % 3 != 1, True, True])
        kq = np.array([0, 2, 5, 0], np.int32)
        tc = interop.tenant_carry_from_numpy(npy(jc), "cpu")
        out = trun.tenant_round(tc, torch.as_tensor(iinj),
                                torch.as_tensor(active), torch.as_tensor(kq))
        jc = jround(jc, jax.numpy.asarray(iinj), jax.numpy.asarray(active),
                    jax.numpy.asarray(kq))
        got, want = interop.tenant_carry_to_numpy(out), npy(jc)
        for k in ints:
            assert np.array_equal(got[0][k], getattr(want[0], k)), (r, k)
        for k in ("t", "h"):
            np.testing.assert_allclose(got[0][k], getattr(want[0], k),
                                       rtol=T_REL, atol=0, err_msg=k)
        assert np.array_equal(np.isfinite(got[1]["t"]),
                              np.isfinite(want[1].t))
        assert np.array_equal(got[1]["dropped"], want[1].dropped)
        assert np.array_equal(got[2]["count"], want[2].count)
        assert np.array_equal(got[2]["overflow"], want[2].overflow)
        for i in (3, 4, 6):
            assert np.array_equal(got[i], want[i]), (r, i)
        for k, v in got[5].items():
            assert np.array_equal(v, getattr(want[5], k)), (r, k)
    assert int(got[2]["count"].sum()) >= 0
