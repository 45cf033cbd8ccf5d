"""End-to-end parity of the port's FAP variable-step runner (method 2c)
against a live JAX run, on the CPU.

Up to ``T_FULL`` = 3 ms -- first spikes and their deliveries -- every
counter (n_steps and the solver's), n_events, n_resets, dropped and
failed are equal and spike times agree within 1e-6 ms.  Over the longer
``T_END`` = 10 ms runs the two step sequences drift apart: XLA's CPU exp
and FMA contraction differ from torch's in the last bit, the step-size
controller amplifies that, and after the first spike the runs take
different numbers of steps (and land later spikes up to ~0.05 ms apart,
inside the integrator's own error).  Those runs compare spike counts,
n_events, n_resets, dropped and failed (ROADMAP §3 records the case).
``test_rounds_from_jax_carry`` holds every counter exactly, round by
round, from the JAX run's own carried state.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)

from repro.core import exec_fap as jfap  # noqa: E402
from repro.core import morphology as jmorph  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.core.cell import CellModel as JCell  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import exec_common as xc  # noqa: E402
from repro_torch.core import exec_fap as tfap  # noqa: E402
from repro_torch.core import morphology as tmorph  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core.cell import CellModel as TCell  # noqa: E402

T_TOL = 1e-6      # ms, spike times
T_FULL = 3.0      # ms, full-parity horizon
T_END = 10.0      # ms, long runs

# (morphology, topology, N, iinj nA, runner knobs)
CASES = {
    "soma-uniform-fused": ("soma", "uniform", 12, 0.16,
                           dict(horizon_impl="fused")),
    "soma-ring-fused": ("soma", "ring", 16, 0.16,
                        dict(horizon_impl="fused")),
    "bs-uniform-fused": ("ball_and_stick", "uniform", 12, 0.3,
                         dict(horizon_impl="fused")),
    "soma-uniform-scatter-k-eg": ("soma", "uniform", 12, 0.16,
                                  dict(horizon_impl="scatter", k_select=5,
                                       eg_window=0.0125)),
    # the other three topologies, dense knobs (their generators need N
    # divisible by 8 blocks, and grid2d a square grid: N = 16)
    "soma-block-fused": ("soma", "block", 16, 0.16,
                         dict(horizon_impl="fused")),
    "soma-grid2d-fused": ("soma", "grid2d", 16, 0.16,
                          dict(horizon_impl="fused")),
    "bs-smallworld-fused": ("ball_and_stick", "smallworld", 16, 0.3,
                            dict(horizon_impl="fused")),
}
LONG = ["soma-uniform-fused", "soma-ring-fused", "bs-uniform-fused"]


def _iinj(N, base, seed):
    # one current per neuron
    return base * (1.0 + 0.2 * np.random.default_rng(seed).random(N))


def _run_pair(name, t_end):
    morph, topo, N, base, kw = CASES[name]
    iinj = _iinj(N, base, N)
    jr, _ = jfap.make_fap_vardt_runner(
        JCell(jmorph.by_name(morph)),
        jnet.make_network(N, k_in=4, seed=3, topology=topo), iinj, t_end,
        **kw)()
    run = tfap.make_fap_vardt_runner(
        TCell(tmorph.by_name(morph), device="cpu"),
        tnet.make_network(N, k_in=4, seed=3, topology=topo), iinj, t_end,
        device="cpu", **kw)
    carry = run.init_carry()
    while run.cond(carry):
        carry = run.round_body(carry)
    return jr, run, carry


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    return _run_pair(request.param, T_FULL)


@pytest.fixture(scope="module", params=LONG)
def long_pair(request):
    return _run_pair(request.param, T_END)


def _assert_events_equal(jr, carry, t_end):
    sts, eq, rec, n_ev, n_rs, _, _ = carry
    jcount = np.asarray(jr.rec.count)
    assert jcount.sum() > 0
    assert np.array_equal(rec.count.numpy(), jcount)
    assert int(n_ev) == int(jr.n_events)
    assert int(n_rs) == int(jr.n_resets)
    assert int(eq.dropped) == int(jr.dropped) == 0
    assert bool(sts.failed.any()) == bool(jr.failed) is False
    assert float(sts.t.min()) >= t_end - 1e-9


def test_end_to_end_matches_live_jax(pair):
    jr, _, carry = pair
    _assert_events_equal(jr, carry, T_FULL)
    sts, rec = carry[0], carry[2]
    jt, tt = np.asarray(jr.rec.times), rec.times.numpy()
    fin = np.isfinite(jt)
    assert np.array_equal(np.isfinite(tt), fin)
    np.testing.assert_allclose(tt[fin], jt[fin], rtol=0, atol=T_TOL)
    assert int(sts.nst.sum()) == int(jr.n_steps)
    for k, v in jr.solver.items():
        assert int(getattr(sts, k).sum()) == int(v), k


def test_long_run_spike_counts_match_live_jax(long_pair):
    jr, _, carry = long_pair
    _assert_events_equal(jr, carry, T_END)


def test_rounds_after_the_end_change_nothing(pair):
    """The host loop stops where the JAX while_loop stops; a further round
    is a no-op (every horizon is clamped at t_end)."""
    _, run, carry = pair
    again = run.round_body(carry)
    for a, b in zip(carry[0], again[0]):
        assert torch.equal(a, b)
    assert torch.equal(carry[1].t, again[1].t)
    assert torch.equal(carry[2].count, again[2].count)
    assert int(again[3]) == int(carry[3]) and int(again[4]) == int(carry[4])


def test_run_result_matches_round_loop(pair):
    _, run, carry = pair
    res, rounds = run()
    assert rounds == carry[-1]
    assert torch.equal(res.rec.times, carry[2].times)
    assert int(res.n_steps) == int(carry[0].nst.sum())
    assert int(res.solver["nni"]) == int(carry[0].nni.sum())
    m = xc.sched_metrics(res.sched)
    assert m["rounds"] == rounds and 0.0 < m["occupancy"] <= 1.0


def test_rounds_from_jax_carry():
    """Each round run from the JAX runner's carried state: every per-lane
    counter, q and failed exact; clocks and steps within 1e-8 relative
    (last-bit differences amplified over up to 12 steps a round)."""
    N, iinj = 12, _iinj(12, 0.16, 12)
    jrun = jfap.make_fap_vardt_runner(
        JCell(jmorph.soma_only()), jnet.make_network(N, k_in=4, seed=3),
        iinj, T_END, horizon_impl="fused")
    trun = tfap.make_fap_vardt_runner(
        TCell(tmorph.soma_only(), device="cpu"),
        tnet.make_network(N, k_in=4, seed=3), iinj, T_END,
        horizon_impl="fused", device="cpu")
    jround = jax.jit(jrun.round_body)
    jc, tc = jrun.init_carry(), trun.init_carry()
    ints = ("q", "nst", "nfe", "nni", "netf", "nncf", "nreset", "nsetups",
            "qwait", "failed", "jbad")
    for _ in range(10):
        np_ = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
        tc = (interop.bdf_state_from_numpy(np_(jc[0]), "cpu"),
              interop.event_queue_from_numpy(np_(jc[1]), "cpu"),
              interop.spike_record_from_numpy(np_(jc[2]), "cpu")) + tc[3:]
        jc, tc = jround(jc), trun.round_body(tc)
        got = interop.bdf_state_to_numpy(tc[0])
        for k in ints:
            assert np.array_equal(got[k], np.asarray(getattr(jc[0], k))), k
        for k in ("t", "h"):
            np.testing.assert_allclose(got[k], np.asarray(getattr(jc[0], k)),
                                       rtol=1e-8, atol=0, err_msg=k)
        jq = np.asarray(jc[1].t)
        assert np.array_equal(np.isfinite(tc[1].t.numpy()), np.isfinite(jq))
        assert np.array_equal(tc[2].count.numpy(), np.asarray(jc[2].count))
        assert int(tc[3]) == int(jc[3]) and int(tc[4]) == int(jc[4])
