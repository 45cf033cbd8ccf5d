"""Parity of the port's fixed-step baselines (``core/fixed_step.py``:
cnexp 1a, euler 1b, derivimplicit 2a) and calibration
(``core/calibrate.py``) against the JAX package, on the CPU.

The JAX steppers run jitted and vmapped, as the JAX runners run them.
Their constants are matched: ``exp(-dt/tau)`` bit for bit, ``cap/dt`` by
the same true division.  What is left are last-bit differences of XLA's
CPU ``exp`` and its contraction of ``a*b + c`` into fused multiply-adds
(ROADMAP §3): one step agrees within 1e-12 relative, 400 steps through
spikes within 1e-9 mV and 1e-9 of a gate.  No step-size controller
amplifies them, so the bisections of ``calibrate`` land on the same
currents.
"""
from fractions import Fraction

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)

from repro.core import calibrate as jcal  # noqa: E402
from repro.core import fixed_step as jfs  # noqa: E402
from repro.core import mechanisms as jmech  # noqa: E402
from repro.core import morphology as jmorph  # noqa: E402
from repro.core.cell import CellModel as JCell  # noqa: E402

from repro_torch.core import calibrate as tcal  # noqa: E402
from repro_torch.core import detmath  # noqa: E402
from repro_torch.core import exec_fap as tfap  # noqa: E402
from repro_torch.core import fixed_step as tfs  # noqa: E402
from repro_torch.core import morphology as tmorph  # noqa: E402
from repro_torch.core.cell import CellModel as TCell  # noqa: E402

from test_torch_cell_bdf import _t  # noqa: E402

METHODS = ["cnexp", "euler", "derivimplicit"]
MORPHS = ["soma", "ball_and_stick", "branched"]


@pytest.fixture(scope="module")
def models():
    return {name: (JCell(jmorph.by_name(name)),
                   TCell(tmorph.by_name(name), device="cpu"))
            for name in MORPHS}


def _random_states(jm, N, seed):
    rng = np.random.default_rng(seed)
    Y = np.tile(np.asarray(jm.init_state()), (N, 1))
    C = jm.C
    Y[:, :C] += rng.normal(0.0, 20.0, (N, C))
    Y[:, C:4 * C] = rng.random((N, 3 * C))
    Y[:, 4 * C:] = rng.random((N, 2)) * 0.01
    return Y, rng.random(N) * 0.3


@pytest.mark.parametrize("dt", [0.025, 0.01, 0.1, 0.0125])
def test_decay_factors_bitwise_equal_to_jax(dt):
    want = jax.jit(lambda: jnp.stack([jnp.exp(-dt / jmech.TAU_AMPA),
                                      jnp.exp(-dt / jmech.TAU_GABA)]))()
    assert tfs.decay_factors(dt) == tuple(float(x) for x in want)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", MORPHS)
def test_one_step_vs_jax(models, name, method):
    jm, tm = models[name]
    Y, iinj = _random_states(jm, 200, len(name) + len(method))
    want = jax.jit(jax.vmap(jfs.make_stepper(jm, method, 0.025)))(Y, iinj)
    got = tfs.make_stepper(tm, method, 0.025, device="cpu")(_t(Y), _t(iinj))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-13)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", ["soma", "ball_and_stick"])
def test_run_fixed_400_steps_vs_jax(models, name, method):
    """10 ms (400 steps) through spikes, recording V_soma every 4 steps:
    final states and traces within 1e-9, the same number of spikes."""
    jm, tm = models[name]
    N = 6
    iinj = np.linspace(0.05, 0.5, N)
    Y0 = np.tile(np.asarray(jm.init_state()), (N, 1))
    jrun = jax.jit(jax.vmap(lambda y, i: jfs.run_fixed(
        jm, y, 10.0, i, method=method, record_every=4)[::2]))
    jy, jtr = jrun(Y0, iinj)
    ty, n_steps, ttr = tfs.run_fixed(tm, _t(Y0), 10.0, _t(iinj),
                                     method=method, record_every=4,
                                     device="cpu")
    assert n_steps == 400 and ttr.shape == (100, N)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ttr.numpy().T, np.asarray(jtr), rtol=0,
                               atol=1e-9)
    spikes = [tcal.spikes_in_trace(ttr[:, i]) for i in range(N)]
    assert spikes == [jcal.spikes_in_trace(np.asarray(jtr)[i])
                      for i in range(N)]
    assert max(spikes) > 0


def test_run_fixed_single_neuron_without_record(models):
    jm, tm = models["branched"]
    jy, jn, jtr = jfs.run_fixed(jm, jm.init_state(), 2.0, 0.2,
                                method="derivimplicit")
    ty, tn, ttr = tfs.run_fixed(tm, tm.init_state(), 2.0, 0.2,
                                method="derivimplicit", device="cpu")
    assert jtr is None and ttr is None and tn == jn == 80
    assert ty.shape == (tm.n_state,)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-9)


def test_stepper_rejects_bad_method_and_device(models):
    tm = models["soma"][1]
    with pytest.raises(ValueError, match="method"):
        tfs.make_stepper(tm, "rk4", device="cpu")
    with pytest.raises((ValueError, RuntimeError)):
        tfs.make_stepper(tm, "cnexp")            # model on the CPU, not cuda


def test_threshold_current_equals_jax(models):
    """The bisection at a reduced t_end and iteration count: the port lands
    on exactly the JAX current."""
    jm, tm = models["soma"]
    want = jcal.threshold_current(jm, t_end=20.0, iters=6)
    got = tcal.threshold_current(tm, t_end=20.0, iters=6, device="cpu")
    assert got == want and 0.0 < got < 1.0


def test_current_for_rate_equals_jax(models):
    jm, tm = models["soma"]
    want = jcal.current_for_rate(jm, 100.0, 0.05, t_end=30.0, iters=4)
    got = tcal.current_for_rate(tm, 100.0, 0.05, t_end=30.0, iters=4,
                                device="cpu")
    assert got == want


def test_detmath_fma_rounds_once():
    """``detmath.fma`` equals a*b + c in rational arithmetic, rounded once,
    for tensor and Python-float operands."""
    rng = np.random.default_rng(3)
    a = rng.uniform(-3.0, 10.0, 1500)
    b = rng.uniform(0.0, 5.0, 1500)
    c = rng.uniform(-50.0, 50.0, 1500)
    got = detmath.fma(_t(a), _t(b), _t(c)).numpy()
    want = [float(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(a, b, c)]
    assert np.array_equal(got, want)
    got = detmath.fma(_t(a), 40.0, 1e-9).numpy()
    want = [float(Fraction(x) * 40 + Fraction(1e-9)) for x in a]
    assert np.array_equal(got, want)


def _boundary_cases(dt):
    """(horizon - t_clock) values on and one ulp beside the points where
    ``x / dt + 1e-9`` crosses an integer, with horizon and clock on the
    1c grid (clock = k * dt) or at t_end."""
    r = 1.0 / dt
    xs = []
    for n_ in range(0, 20):
        x0 = (n_ - 1e-9) * dt
        for x in (x0, np.nextafter(x0, np.inf), np.nextafter(x0, -np.inf),
                  n_ * dt, np.nextafter(n_ * dt, -np.inf)):
            xs.append(x)
        # the exact crossing of the product itself
        x1 = (n_ - 1e-9) / r
        xs += [x1, np.nextafter(x1, np.inf), np.nextafter(x1, -np.inf)]
    k = np.arange(400)
    t = k * dt
    xs = np.array(xs)
    t_clock = np.concatenate([np.zeros_like(xs), t, t])
    horizon = np.concatenate([xs, t + 0.1,
                              np.full_like(t, 10.0)])
    return horizon, t_clock


@pytest.mark.parametrize("dt", [0.025, 0.03, 0.01])
def test_fixed_steps_below_matches_jitted_jax_on_boundaries(dt):
    """1c's whole-step count: XLA computes fma(x, 1/dt, 1e-9) before the
    floor, and an ulp there moves n_adv; the port computes the same."""
    horizon, t_clock = _boundary_cases(dt)
    want = jax.jit(lambda h, t: jnp.clip(
        jnp.floor((h - t) / dt + 1e-9).astype(jnp.int32), 0, 16))(
            horizon, t_clock)
    got = tfap.fixed_steps_below(_t(horizon), _t(t_clock), dt, 16)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # the boundaries are real: the product and the add rounded apart
    # (no fused multiply-add) give another count on some of them
    plain = np.clip(np.floor((horizon - t_clock) * (1.0 / dt) + 1e-9), 0, 16)
    assert (plain != np.asarray(want)).any()
