"""End-to-end parity of the port's baseline runners -- BSP fixed-step (1a,
1b, 2a), FAP fixed-step (1c) and BSP variable-step (2b) -- against live
JAX runs on ``make_network(12, k_in=4, seed=3)``, on the CPU.

Fixed-step runs: per-neuron spike counts, record slots, ``n_events``,
``n_steps`` (and 1c's rounds) exact, ``dropped == 0``, ``failed`` False;
spike times within 1e-9 ms and final states within 1e-9 mV (XLA's CPU
``exp`` and its fused multiply-adds differ from the port in the last
bit, and no step-size controller amplifies that).  2b: spike counts,
``n_events``, ``n_resets``, ``dropped`` and ``failed`` exact; its step
counts drift as 2c's do past the first spike (ROADMAP §3).

Inside the port: BSP-fixed equals FAP-fixed as ``tests/test_exec_models.py``
holds the JAX pair: spike counts, record slots, ``n_events`` and steps
exact, spike times within 1e-9 ms (the two clocks are ``w * 0.1 + j * dt``
and ``k * dt``), final states within 1e-9 (a step's due weights are summed
in slot order, and the two runners fill the slots at other times); and
BSP-vardt compact equals dense exactly at any cap, on both queues.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)

from repro.core import exec_bsp as jbsp  # noqa: E402
from repro.core import exec_fap as jfap  # noqa: E402
from repro.core import morphology as jmorph  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.core.cell import CellModel as JCell  # noqa: E402

from repro_torch.core import exec_bsp as tbsp  # noqa: E402
from repro_torch.core import exec_fap as tfap  # noqa: E402
from repro_torch.core import morphology as tmorph  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core.cell import CellModel as TCell  # noqa: E402

N, K_IN, SEED = 12, 4, 3
T_FIXED = 10.0    # ms
T_VARDT = 5.0     # ms
TOL = 1e-9        # ms for spike times, mV for final states


def _iinj(base):
    return base * (1.0 + 0.2 * np.random.default_rng(N).random(N))


def _models(morph):
    return JCell(jmorph.by_name(morph)), TCell(tmorph.by_name(morph),
                                               device="cpu")


def _nets():
    return (jnet.make_network(N, k_in=K_IN, seed=SEED),
            tnet.make_network(N, k_in=K_IN, seed=SEED))


def _same_events(jr, tr):
    jc = np.asarray(jr.rec.count)
    assert jc.sum() > 0
    assert np.array_equal(tr.rec.count.numpy(), jc)
    assert int(tr.n_events) == int(jr.n_events)
    assert int(tr.n_resets) == int(jr.n_resets)
    assert int(tr.dropped) == int(jr.dropped) == 0
    assert int(tr.rec.overflow) == 0
    assert not bool(tr.failed) and not bool(jr.failed)


def _close_times(a, b, tol=TOL):
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin)      # same record slots
    np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=tol)


FIXED = {
    "1a-dense": ("soma", 0.16, dict(method="cnexp")),
    "2a-dense": ("soma", 0.16, dict(method="derivimplicit")),
    "1a-wheel": ("soma", 0.16, dict(method="cnexp", queue="wheel")),
    "1b-compact-fanout": ("soma", 0.16, dict(method="euler",
                                             fanout="compact", spike_cap=4)),
    "2a-ball-and-stick": ("ball_and_stick", 0.3,
                          dict(method="derivimplicit")),
}


@pytest.mark.parametrize("case", list(FIXED))
def test_bsp_fixed_matches_live_jax(case):
    morph, base, kw = FIXED[case]
    jm, tm = _models(morph)
    jn, tn = _nets()
    jr = jbsp.run_bsp_fixed(jm, jn, _iinj(base), T_FIXED, **kw)
    tr = tbsp.run_bsp_fixed(tm, tn, _iinj(base), T_FIXED, device="cpu", **kw)
    _same_events(jr, tr)
    assert int(tr.n_steps) == int(jr.n_steps) == N * 400
    _close_times(tr.rec.times.numpy(), np.asarray(jr.rec.times))
    np.testing.assert_allclose(tr.y_final.numpy(), np.asarray(jr.y_final),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("kw", [dict(method="cnexp"),
                                dict(method="derivimplicit", queue="wheel",
                                     fanout="compact")],
                         ids=["1c-dense", "1c-2a-wheel-compact"])
def test_fap_fixed_matches_live_jax(kw):
    jm, tm = _models("soma")
    jn, tn = _nets()
    jr, jrounds = jfap.make_fap_fixed_runner(jm, jn, _iinj(0.16), T_FIXED,
                                             **kw)()
    tr, trounds = tfap.make_fap_fixed_runner(tm, tn, _iinj(0.16), T_FIXED,
                                             device="cpu", **kw)()
    _same_events(jr, tr)
    assert trounds == int(jrounds) > 1
    assert int(tr.n_steps) == int(jr.n_steps) == N * 400
    _close_times(tr.rec.times.numpy(), np.asarray(jr.rec.times))
    np.testing.assert_allclose(tr.y_final.numpy(), np.asarray(jr.y_final),
                               rtol=0, atol=TOL)


def test_bsp_fixed_equals_fap_fixed_in_the_port():
    _, tm = _models("soma")
    _, tn = _nets()
    rb = tbsp.run_bsp_fixed(tm, tn, _iinj(0.16), T_FIXED, method="cnexp",
                            device="cpu")
    rf = tfap.run_fap_fixed(tm, tn, _iinj(0.16), T_FIXED, method="cnexp",
                            device="cpu")
    assert int(rb.rec.count.sum()) > 0
    assert torch.equal(rb.rec.count, rf.rec.count)
    assert int(rb.n_events) == int(rf.n_events)
    assert int(rb.n_steps) == int(rf.n_steps)
    _close_times(rb.rec.times.numpy(), rf.rec.times.numpy())
    np.testing.assert_allclose(rb.y_final.numpy(), rf.y_final.numpy(),
                               rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def vardt_port():
    """The port's 2b runs: dense, compact at caps 5 and 0, and both on the
    wheel queue."""
    _, tm = _models("soma")
    _, tn = _nets()
    out = {}
    for name, kw in {"dense": {}, "compact5": dict(batch="compact",
                                                   batch_cap=5),
                     "compact0": dict(batch="compact", batch_cap=0),
                     "wheel": dict(queue="wheel"),
                     "wheel-compact7": dict(queue="wheel", batch="compact",
                                            batch_cap=7)}.items():
        out[name] = tbsp.run_bsp_vardt(tm, tn, _iinj(0.16), T_VARDT,
                                       device="cpu", **kw)
    return out


@pytest.mark.parametrize("kw", [{}, dict(batch="compact", batch_cap=5)],
                         ids=["2b-dense", "2b-compact5"])
def test_bsp_vardt_matches_live_jax(vardt_port, kw):
    jm, _ = _models("soma")
    jn, _ = _nets()
    jr = jbsp.run_bsp_vardt(jm, jn, _iinj(0.16), T_VARDT, **kw)
    _same_events(jr, vardt_port["compact5" if kw else "dense"])


def _identical(a, b):
    assert torch.equal(a.rec.times, b.rec.times)
    assert torch.equal(a.rec.count, b.rec.count)
    assert torch.equal(a.y_final, b.y_final)
    for k in ("n_steps", "n_events", "n_resets", "dropped"):
        assert int(getattr(a, k)) == int(getattr(b, k)), k
    for k, v in a.solver.items():
        assert int(b.solver[k]) == int(v), k


@pytest.mark.parametrize("dense,compact", [("dense", "compact5"),
                                           ("dense", "compact0"),
                                           ("wheel", "wheel-compact7")])
def test_bsp_vardt_compact_equals_dense_in_the_port(vardt_port, dense,
                                                    compact):
    a, b = vardt_port[dense], vardt_port[compact]
    assert int(a.rec.count.sum()) > 0
    _identical(a, b)
    # every behind-barrier lane advanced exactly once per window
    assert int(b.sched.stepped) == int(b.sched.runnable)
    if compact == "compact5":
        assert int(b.sched.rounds) > int(a.sched.rounds)   # chunks ran


def test_unported_run_knobs_raise():
    """The fixed-step runners' ``run()`` takes no knob, as JAX's; 2b's
    robustness knobs are ported and want a checkpoint directory."""
    _, tm = _models("soma")
    _, tn = _nets()
    for mk in (tbsp.make_bsp_fixed_runner, tfap.make_fap_fixed_runner):
        with pytest.raises(TypeError):
            mk(tm, tn, 0.1, 1.0, device="cpu")(checkpoint_every=4)
    with pytest.raises(ValueError, match="ckpt_dir"):
        tbsp.make_bsp_vardt_runner(tm, tn, 0.1, 1.0,
                                   device="cpu")(checkpoint_every=4)
    with pytest.raises(ValueError, match="batch"):
        tbsp.make_bsp_vardt_runner(tm, tn, 0.1, 1.0, batch="x", device="cpu")
