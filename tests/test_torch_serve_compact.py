"""The simulation service over a runner built with the active-set knobs:
``run.tenant_round`` under ``batch="compact"``, ``fanout="compact"``,
``queue="wheel"`` and the incremental horizon (soma, N = 10, the cases of
``tests/test_torch_serve.py``).

Each tenant gets its own [batch_cap] batch (K6's rows form), its own
compact fan-out or dense fallback (K7's rows form) and its own incremental
horizon, as JAX's ``vmap`` of the one-tenant round gives it:

* against live JAX, round by round from JAX's batched carry (handed across
  by ``interop.tenant_carry_from_numpy``) over 30 rounds, with mixed
  ``active`` and ``k_qos``: integers exact, clocks and the incremental
  horizon within 1e-8 relative, step sizes within 1e-6 (``H_REL``),
  including rounds where one tenant's spikes overflow ``spike_cap`` and
  another's do not; the dense round (no active-set knob) runs the same
  30 rounds under the same tolerances beside them;
* inside the port, bitwise: each tenant the same solo, in the batch and
  through its own quarantine and retry;
* ``SimService`` against JAX's on a seeded request mix: the same statuses,
  reasons, retries, rounds and spike counts;
* the rows forms of K6 and K7 (their plain versions here; the kernels in
  ``tests/test_torch_cuda.py``) and ``exec_common.compact_frontier``'s
  rows form equal T calls of the one-row functions.
"""
import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.checkpoint import (ExponentialBackoff, FaultPlan,
                                    StragglerMonitor)
from repro_torch.core import exec_common as xc
from repro_torch.core import exec_fap, morphology, network
from repro_torch.core.cell import CellModel
from repro_torch.kernels import build
from repro_torch.kernels.event_wheel import event_wheel as ew_cuda
from repro_torch.kernels.event_wheel import ops as ew_ops
from repro_torch.kernels.event_wheel import ref as ew_ref
from repro_torch.serve import SimService, TenantRequest

jax = pytest.importorskip("jax")

N = 10
T_END = 6.0
T_SERVE = 3.0     # ms, the services' target (the runner's t_end stays T_END)
LANES = 3
T_REL = 1e-8
# Step sizes h against JAX.  Over these 30 rounds h drifts past 1e-8 in
# the dense round too (the "dense" knob set: 9.0e-8 in round 18), with the
# steps, orders and every other counter exact, so the gap is the per-lane
# solver's arithmetic against XLA's, which the step controller's
# eta = (1 / (6 dsm))^(1 / (q + 1)) amplifies, and not the compaction; the
# compact sets reach 2.15e-7 (round 26; ROADMAP §3).
H_REL = 1e-6
SPIKE_CAP = 2
# the knob sets: the dense round, the baseline of the tolerances; the
# compact batch under the fused horizon; with the compact fan-out into the
# wheel (the card's service runner); under the scatter horizon, kept
# incrementally, with the compact fan-out
KNOBS = {
    "dense": dict(),
    "fused": dict(batch="compact", batch_cap=4, horizon_impl="fused"),
    "fanout_wheel": dict(batch="compact", batch_cap=4, fanout="compact",
                         spike_cap=SPIKE_CAP, queue="wheel",
                         horizon_impl="fused"),
    "incremental": dict(batch="compact", batch_cap=4, fanout="compact",
                        spike_cap=SPIKE_CAP),
}
INTS = ("q", "nst", "nfe", "nni", "netf", "nncf", "nreset", "nsetups",
        "qwait", "failed", "jbad")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the runs are small, and the tests share the
    machine with other workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _wheel_kw(kw, sched_mod, net):
    kw = dict(kw)
    if kw.get("queue") == "wheel":
        kw["wheel"] = sched_mod.WheelSpec.auto(net)
    return kw


def _port_runner(name):
    from repro_torch import sched
    net = network.make_network(N, k_in=4, seed=3)
    return exec_fap.make_fap_vardt_runner(
        CellModel(morphology.soma_only(), device="cpu"), net, 0.0, T_END,
        device="cpu", **_wheel_kw(KNOBS[name], sched, net))


def _jax_runner(name):
    jax.config.update("jax_enable_x64", True)
    from repro import sched as jsched
    from repro.core import exec_fap as jfap
    from repro.core import morphology as jmorph
    from repro.core import network as jnet
    from repro.core.cell import CellModel as JCell
    net = jnet.make_network(N, k_in=4, seed=3)
    return jfap.make_fap_vardt_runner(JCell(jmorph.soma_only()), net, 0.0,
                                      T_END,
                                      **_wheel_kw(KNOBS[name], jsched, net))


@pytest.fixture(scope="module", params=list(KNOBS))
def rounds(request):
    """30 rounds of 4 tenants, the port's round run from JAX's carry of
    each: (name, [(port out, JAX out, JAX in) as numpy])."""
    from repro.serve.tenants import stack_lanes as jstack
    name = request.param
    jrun, trun = _jax_runner(name), _port_runner(name)
    iinj = np.array([0.15, 0.2, 0.16, 0.24])
    jround = jax.jit(jax.vmap(jrun.tenant_round, in_axes=(0, 0, 0, 0)))
    jc = jstack([jrun.init_carry(i) for i in iinj])
    npy = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    out = []
    for r in range(30):
        active = np.array([True, r % 3 != 1, True, r % 5 != 2])
        kq = np.array([0, 2, 5, 0], np.int32)
        before = npy(jc)
        tc = interop.tenant_carry_from_numpy(before, "cpu")
        got = trun.tenant_round(tc, torch.as_tensor(iinj),
                                torch.as_tensor(active), torch.as_tensor(kq))
        jc = jround(jc, jax.numpy.asarray(iinj), jax.numpy.asarray(active),
                    jax.numpy.asarray(kq))
        out.append((interop.tenant_carry_to_numpy(got), npy(jc), before))
    return name, out


def test_compact_tenant_round_matches_jax(rounds, request):
    """Each round against JAX's; the largest relative h error of each
    round goes into the test's junit record (``h_rel_by_round``)."""
    name, out = rounds
    incremental = name == "incremental"
    assert len(out[0][0]) == (8 if incremental else 7)
    h_rel = [float((np.abs(got[0]["h"] - want[0].h)
                    / np.maximum(np.abs(want[0].h), 1e-300)).max())
             for got, want, _ in out]
    request.node.user_properties.append(
        ("h_rel_by_round", " ".join(f"{e:.3e}" for e in h_rel)))
    for r, (got, want, _) in enumerate(out):
        for k in INTS:
            assert np.array_equal(got[0][k], getattr(want[0], k)), (r, k)
        for k, rtol in (("t", T_REL), ("h", H_REL)):
            np.testing.assert_allclose(got[0][k], getattr(want[0], k),
                                       rtol=rtol, atol=0, err_msg=k)
        assert np.array_equal(np.isfinite(got[1]["t"]),
                              np.isfinite(want[1].t)), r
        assert np.array_equal(got[1]["dropped"], want[1].dropped)
        assert np.array_equal(got[2]["count"], want[2].count), r
        assert np.array_equal(got[2]["overflow"], want[2].overflow)
        fin = np.isfinite(want[2].times)
        assert np.array_equal(np.isfinite(got[2]["times"]), fin)
        np.testing.assert_allclose(got[2]["times"][fin], want[2].times[fin],
                                   rtol=0, atol=1e-9)
        if incremental:
            hor = np.asarray(want[3])
            np.testing.assert_allclose(got[3], hor, rtol=T_REL, atol=0,
                                       err_msg=f"horizon, round {r}")
        for i in (-4, -3, -1):
            assert np.array_equal(got[i], np.asarray(want[i])), (r, i)
        for k, v in got[-2].items():
            assert np.array_equal(v, getattr(want[-2], k)), (r, k)
    assert int(out[-1][1][2].count.sum()) > 0


def test_spike_cap_overflows_in_one_tenant_and_not_another(rounds):
    """Under the compact fan-out some round has a tenant past
    ``spike_cap`` (the dense insert of its own rows) beside a tenant with
    1..spike_cap spikes (its compact batch); that round matched JAX in
    ``test_compact_tenant_round_matches_jax``."""
    name, out = rounds
    mixed = []
    for r, (_, want, before) in enumerate(out):
        new = want[2].count.sum(axis=1) - before[2].count.sum(axis=1)
        if (new > SPIKE_CAP).any() and ((new > 0) & (new <= SPIKE_CAP)).any():
            mixed.append(r)
    if KNOBS[name].get("fanout") == "compact":
        assert mixed, name
    # every round moved the same tenants' queues as JAX's
    for got, want, _ in out:
        assert np.array_equal(np.isfinite(got[1]["t"]),
                              np.isfinite(want[1].t))


def _reqs(n=3, **kw):
    return [TenantRequest(rid=r, iinj=0.14 + 0.012 * r, **kw)
            for r in range(n)]


def _run(runner, reqs, lanes=LANES, **kw):
    svc = SimService(runner=runner, t_end=T_SERVE, lanes=lanes, **kw)
    for r in reqs:
        svc.submit(r)
    return svc.run()


@pytest.mark.parametrize("name", ["fanout_wheel", "incremental"])
def test_tenant_bitwise_solo_batched_and_retried(name):
    """Three tenants, tenant 1 poisoned at its round 8, quarantined and
    retried: tenant 1 and tenant 0 (batched beside it) each bitwise equal
    to its solo 1-lane service.  The two knob sets cover the compact
    fan-out into the wheel and the incremental horizon riding the
    per-tenant snapshots (the fused set differs from the first only in
    the fan-out)."""
    run = _port_runner(name)
    res = _run(run, _reqs(), fault=FaultPlan(poison_at_round=8,
                                             poison_tenant=1, poison_lane=2))
    assert res.completed == 3
    assert res.results[1].retries >= 1 and res.quarantines >= 1
    for rid in (1, 0):
        solo = _run(run, _reqs()[rid:rid + 1], lanes=1).results[rid]
        b = res.results[rid]
        assert solo.status == "completed" and b.count.sum() > 0, rid
        assert np.array_equal(solo.times, b.times), (name, rid)
        assert np.array_equal(solo.count, b.count), (name, rid)


def _seeded_service(svc_cls, req_cls, fault_cls, mon_cls, bo_cls, runner,
                    seed):
    """``test_torch_serve.py``'s seeded request mix without wall
    deadlines, under a straggler monitor that never flags."""
    rng = np.random.default_rng(seed)
    fault = fault_cls(poison_at_round=3,
                      poison_tenant=int(rng.integers(0, 6)),
                      poison_lane=int(rng.integers(0, N)))
    svc = svc_cls(runner=runner, t_end=T_SERVE, lanes=LANES,
                  queue_cap=int(rng.integers(1, 5)),
                  backoff=bo_cls(max_retries=2), fault=fault,
                  qos_caps={0: 3}, straggler=mon_cls(threshold=1e12))
    for rid in range(int(rng.integers(3, 8))):
        svc.submit(req_cls(
            rid=rid, iinj=float(0.13 + 0.03 * rng.random()),
            qos=int(rng.integers(0, 3)),
            deadline_rounds=int(rng.integers(0, 2) * rng.integers(2, 30))))
    return svc.run(max_rounds=2000)


@pytest.mark.parametrize("name,seed", [("fanout_wheel", 6)])
def test_compact_service_decisions_match_jax(name, seed):
    from repro.checkpoint import ExponentialBackoff as JBackoff
    from repro.checkpoint import FaultPlan as JFault
    from repro.checkpoint.fault_tolerance import StragglerMonitor as JMon
    from repro.serve import SimService as JService
    from repro.serve import TenantRequest as JRequest
    got = _seeded_service(SimService, TenantRequest, FaultPlan,
                          StragglerMonitor, ExponentialBackoff,
                          _port_runner(name), seed)
    want = _seeded_service(JService, JRequest, JFault, JMon, JBackoff,
                           _jax_runner(name), seed)
    for k in ("submitted", "admitted", "completed", "evicted", "rejected",
              "retried", "quarantines", "shed", "rounds"):
        assert getattr(got, k) == getattr(want, k), k
    assert sorted(got.results) == sorted(want.results)
    assert got.completed > 0
    for rid, w in want.results.items():
        g = got.results[rid]
        assert (g.status, g.reason, g.retries, g.rounds, g.wait_rounds) == \
            (w.status, w.reason, w.retries, w.rounds, w.wait_rounds), rid
        if w.status == "completed":
            assert np.array_equal(g.count, np.asarray(w.count)), rid
            assert g.count.sum() > 0


@pytest.mark.parametrize("T,n", [(1, 1), (3, 17), (4, 1000), (2, 16385)])
def test_rows_plain_versions_equal_row_by_row(T, n):
    """K6's and K7's plain rows versions (what the dispatchers run on the
    CPU) equal T calls of the one-row plain versions, at caps below, at
    and above the row's set lanes; nothing is launched."""
    gen = np.random.default_rng(T * 7 + n)
    before = build.launches()
    for dens in (0.0, 0.03, 0.5, 1.0):
        m = torch.from_numpy(gen.random((T, n)) < dens)
        for mo in (1, 33):
            table = torch.from_numpy(gen.integers(-99, 99, (n, mo))
                                     .astype(np.int32))
            for cap in sorted({1, 4, n}):
                ids, cnt = ew_ops.compact_ids_rows(m, cap)
                gi, grows, gcnt = ew_ops.compact_gather_rows(m, table, cap,
                                                             fill=-5)
                for t in range(T):
                    r_ids, r_cnt = ew_ref.compact_ids_ref(m[t], cap)
                    assert torch.equal(ids[t], r_ids)
                    assert torch.equal(cnt[t], r_cnt)
                    g = ew_ref.compact_gather_ref(m[t], table, cap, -5)
                    assert torch.equal(gi[t], g[0])
                    assert torch.equal(grows[t], g[1])
                    assert torch.equal(gcnt[t], g[2])
    assert ew_ops.compact_gather_rows(m, table, 2)[1].dtype == torch.int32
    assert build.launches() == before


@pytest.mark.parametrize("cap", [1, 3, 8, 12])
def test_compact_frontier_rows_equal_row_by_row(cap):
    """The rows form of ``compact_frontier`` (per-tenant selection, K6's
    rows form, the forced earliest lane per row) equals the one-row form
    on each row, with ties, empty rows and full rows."""
    gen = np.random.default_rng(cap)
    T, n = 5, 12
    t = torch.from_numpy(np.round(gen.random((T, n)) * 4) / 4)
    run = torch.from_numpy(gen.random((T, n)) < 0.6)
    run[1] = False
    run[2] = True
    ids, cnt = xc.compact_frontier(run, t, cap)
    assert ids.shape == (T, cap) and cnt.shape == (T,)
    for r in range(T):
        i1, c1 = xc.compact_frontier(run[r], t[r], cap)
        assert torch.equal(ids[r], i1) and torch.equal(cnt[r], c1), r


def test_rows_wrappers_refuse_cpu_and_other_devices():
    m = torch.ones((2, 8), dtype=torch.bool)
    table = torch.zeros((8, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ew_cuda.compact_ids_rows_cuda(m, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ew_cuda.compact_gather_rows_cuda(m, table, 2, 8)
    meta = torch.ones((2, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="compact_ids_rows"):
        ew_ops.compact_ids_rows(meta, 2)
    with pytest.raises(ValueError, match="compact_gather_rows"):
        ew_ops.compact_gather_rows(meta, table.to("meta"), 2)
