"""Parity of the port's fused Hines solve (kernel K3's plain version), the
fused Newton solve ``CellModel.solve_newton_mat`` and the BDF iteration
policy (``jac_policy="iteration"``) against the JAX package, on the CPU.

The fused solve is held to the JAX jnp oracle (``repro.kernels.hines.ref``;
the JAX Pallas wrapper does not run on jax 0.9, ROADMAP §3) within rtol
1e-12, and inside the port to factor + factored solve bit for bit.  The
Newton solve is held to the vmapped JAX method within rtol 1e-12.  The
iteration-policy runs are held to live JAX runs over 3 ms (first spikes
and their deliveries): every solver counter exact, ``nsetups == nni``,
spike times within 1e-6 ms.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)

from repro.core import bdf as jbdf  # noqa: E402
from repro.core import exec_fap as jfap  # noqa: E402
from repro.core import morphology as jmorph  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.core.cell import CellModel as JCell  # noqa: E402
from repro.core.hines import hines_assemble as j_assemble  # noqa: E402
from repro.kernels.hines import ref as jh_ref  # noqa: E402

from repro_torch.core import bdf as tbdf  # noqa: E402
from repro_torch.core import exec_fap as tfap  # noqa: E402
from repro_torch.core import morphology as tmorph  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core.cell import CellModel as TCell  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.hines import ops as th_ops  # noqa: E402
from repro_torch.kernels.hines import ref as th_ref  # noqa: E402

from test_torch_cell_bdf import _assert_state_equal, _close, _states, _t  # noqa: E402,E501

RTOL, ATOL = 1e-12, 1e-14
T_FULL = 3.0      # ms, full-parity horizon of the runs
T_TOL = 1e-6      # ms, spike times
ITER = dict(jac_policy="iteration")


def _hines_inputs(m, N, seed):
    rng = np.random.default_rng(seed)
    de = rng.uniform(0.5, 1.5, (N, m.n_comp))
    d = np.asarray(jax.vmap(lambda x: j_assemble(
        jnp.asarray(m.parent), jnp.asarray(m.g_axial), x))(de)).T.copy()
    return d, rng.normal(size=(m.n_comp, N))


@pytest.mark.parametrize("name,N", [("soma", 7), ("ball_and_stick", 33),
                                    ("branched", 70)])
def test_fused_solve_plain_vs_jax_and_factored(name, N):
    m = jmorph.by_name(name)
    d, b = _hines_inputs(m, N, N)
    tpar, tgax = _t(m.parent), _t(m.g_axial)
    x = th_ops.hines_solve(tpar, tgax, _t(d), _t(b))
    _close(x, jh_ref.hines_solve_ref(jnp.asarray(m.parent),
                                     jnp.asarray(m.g_axial), jnp.asarray(d),
                                     jnp.asarray(b)), rtol=RTOL, atol=ATOL)
    # inside the port: fused == factor + factored solve, bit for bit
    de = th_ops.hines_factor(tpar, tgax, _t(d))
    assert torch.equal(x, th_ops.hines_solve_factored(tpar, tgax, de, _t(b)))
    # transposed [N, C] rows give the same bits; the inputs stay untouched
    d_v, b_v = _t(d.T.copy()).T, _t(b.T.copy()).T
    assert torch.equal(x, th_ops.hines_solve(tpar, tgax, d_v, b_v))
    assert torch.equal(d_v, _t(d)) and torch.equal(b_v, _t(b))
    assert torch.equal(x, th_ref.hines_solve_ref(tpar, tgax, _t(d), _t(b)))


@pytest.fixture(scope="module")
def models():
    return {name: (JCell(jmorph.by_name(name)),
                   TCell(tmorph.by_name(name), device="cpu"))
            for name in ("soma", "ball_and_stick", "branched")}


@pytest.mark.parametrize("name", ["soma", "ball_and_stick", "branched"])
def test_solve_newton_mat_vs_jax(models, name):
    jm, tm = models[name]
    N = 13
    Y = _states(jm.C, N, seed=3 + len(name))
    rng = np.random.default_rng(len(name))
    gamma = rng.uniform(1e-3, 0.2, N)
    b = rng.normal(size=(N, jm.n_state))
    build.reset_launches()
    x = tm.solve_newton_mat(_t(Y), _t(gamma), _t(b))
    assert build.launches()["hines_solve"] == 0        # CPU: plain version
    _close(x, jax.vmap(jm.solve_newton_mat)(Y, gamma, b), rtol=RTOL,
           atol=ATOL)
    # the split pair solves the same system (to the rounding of its
    # cached reciprocal groupings)
    fac = tm.newton_setup(_t(Y), _t(gamma))
    _close(x, tm.newton_solve(fac, _t(b)).numpy(), rtol=1e-10, atol=1e-12)


def test_advance_to_iteration_policy_vs_jax(models):
    """Single-neuron trajectories to 1 ms under ``jac_policy="iteration"``:
    every counter exact (and nsetups == nni); floats within 1e-8 relative,
    1e-12 absolute (last bits accumulate over ~40 steps)."""
    jm, tm = models["ball_and_stick"]
    opts_j, opts_t = jbdf.BDFOptions(**ITER), tbdf.BDFOptions(**ITER)
    N = 4
    iinj = np.linspace(0.1, 0.4, N)
    Y0 = np.tile(np.asarray(jm.init_state()), (N, 1))
    jst = jax.vmap(lambda y, i: jbdf.reinit(jm, 0.0, y, i, opts_j))(Y0, iinj)
    j_out = jax.jit(jax.vmap(lambda s, i: jbdf.advance_to(
        jm, s, 1.0, i, opts_j)))(jst, iinj)
    tst = tbdf.reinit(tm, 0.0, _t(Y0), _t(iinj), opts_t)
    t_out = tbdf.advance_to(tm, tst, 1.0, _t(iinj), opts_t)
    _assert_state_equal(t_out, j_out, rtol=1e-8, atol=1e-12)
    assert torch.equal(t_out.nsetups, t_out.nni)


@pytest.mark.parametrize("morph,iinj", [("soma", 0.16),
                                        ("ball_and_stick", 0.3)])
def test_iteration_policy_run_matches_live_jax(morph, iinj):
    N = 12
    cur = iinj * (1.0 + 0.2 * np.random.default_rng(N).random(N))
    kw = dict(horizon_impl="fused")
    jr, jrounds = jfap.make_fap_vardt_runner(
        JCell(jmorph.by_name(morph)), jnet.make_network(N, k_in=4, seed=3),
        cur, T_FULL, opts=jbdf.BDFOptions(**ITER), **kw)()
    tr, trounds = tfap.make_fap_vardt_runner(
        TCell(tmorph.by_name(morph), device="cpu"),
        tnet.make_network(N, k_in=4, seed=3), cur, T_FULL,
        opts=tbdf.BDFOptions(**ITER), device="cpu", **kw)()
    assert trounds == int(jrounds)
    jc = np.asarray(jr.rec.count)
    assert jc.sum() > 0 and np.array_equal(tr.rec.count.numpy(), jc)
    assert int(tr.n_events) == int(jr.n_events)
    assert int(tr.n_resets) == int(jr.n_resets)
    assert int(tr.n_steps) == int(jr.n_steps)
    assert int(tr.dropped) == int(jr.dropped) == 0
    assert not bool(tr.failed) and not bool(jr.failed)
    for k, v in jr.solver.items():
        assert int(tr.solver[k]) == int(v), k
    assert int(tr.solver["nsetups"]) == int(tr.solver["nni"])
    jt, tt = np.asarray(jr.rec.times), tr.rec.times.numpy()
    fin = np.isfinite(jt)
    assert np.array_equal(np.isfinite(tt), fin)
    np.testing.assert_allclose(tt[fin], jt[fin], rtol=0, atol=T_TOL)
