"""Parity of the port's Hines solve, batched cell model and BDF integrator
against the JAX package, on the CPU (the kernels' plain versions).

The JAX side runs per neuron under ``jax.vmap``; the port runs batched.
States cross between the packages through ``repro_torch.interop`` as
numpy arrays.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)

from repro.core import bdf as jbdf  # noqa: E402
from repro.core import hines as jhines  # noqa: E402
from repro.core import morphology as jmorph  # noqa: E402
from repro.core.cell import CellModel as JCell  # noqa: E402
from repro.core.cell import weighted_rms as j_wrms  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import bdf as tbdf  # noqa: E402
from repro_torch.core import hines as thines  # noqa: E402
from repro_torch.core import morphology as tmorph  # noqa: E402
from repro_torch.core.cell import CellModel as TCell  # noqa: E402
from repro_torch.core.cell import weighted_rms as t_wrms  # noqa: E402

RTOL, ATOL = 1e-12, 1e-14
MORPHS = ["soma", "ball_and_stick", "branched"]
# a detailed cell past every Hines tile: C = 1021, depth 16
DETAILED = {"branched_8": dict(depth=8, seg_per_branch=2)}


def _morphs(name):
    """(JAX morphology, port morphology) of a ``MORPHS`` or ``DETAILED``
    name."""
    if name in DETAILED:
        return (jmorph.branched_tree(**DETAILED[name]),
                tmorph.branched_tree(**DETAILED[name]))
    return jmorph.by_name(name), tmorph.by_name(name)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def models():
    return {name: (JCell(jm), TCell(tm, device="cpu"))
            for name in MORPHS + list(DETAILED)
            for jm, tm in [_morphs(name)]}


def _states(C, N, seed):
    """Random physiological states [N, 4C+2]: v, gates, synapses."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-80.0, 40.0, (N, C))
    gates = rng.uniform(0.0, 1.0, (N, 3 * C))
    syn = rng.uniform(0.0, 2e-3, (N, 2))
    return np.concatenate([v, gates, syn], axis=1)


# -------------------------------------------------------------- hines -----
@pytest.mark.parametrize("name", ["ball_and_stick", "branched", "branched_8"])
def test_core_hines_vs_jax(name):
    m = _morphs(name)[0]
    rng = np.random.default_rng(1)
    N, C = 9, m.n_comp
    extra = rng.uniform(0.5, 2.0, (N, C))
    b = rng.normal(size=(N, C))
    par, gax = jnp.asarray(m.parent), jnp.asarray(m.g_axial)
    jd = jax.vmap(lambda x: jhines.hines_assemble(par, gax, x))(extra)
    td = thines.hines_assemble(_t(m.parent), _t(m.g_axial), _t(extra))
    _close(td, jd)
    jx = jax.vmap(lambda d, bb: jhines.hines_solve(par, gax, d, bb))(jd, b)
    tx = thines.hines_solve(m.parent, m.g_axial, td, _t(b))
    _close(tx, jx)
    jde = jax.vmap(lambda d: jhines.hines_factor(par, gax, d))(jd)
    tde = thines.hines_factor(m.parent, m.g_axial, td)
    _close(tde, jde)
    tx2 = thines.hines_solve_factored(m.parent, m.g_axial, tde, _t(b))
    _close(tx2, jax.vmap(lambda d, bb: jhines.hines_solve_factored(
        par, gax, d, bb))(jde, b))
    assert torch.equal(tx, tx2)             # factor + solve == fused, bitwise
    dense = thines.dense_tree_matrix(_t(m.parent), _t(m.g_axial), _t(extra))
    _close(dense, jax.vmap(lambda x: jhines.dense_tree_matrix(par, gax, x))(
        extra))
    # numpy's LAPACK: torch's MKL solve of [9, 1021, 1021] systems can
    # stop on a bad DLASWP argument in a process whose torch thread count
    # was changed before (the thread-pinning fixtures of other files)
    np.testing.assert_allclose(
        np.linalg.solve(dense.numpy(), b[..., None])[..., 0], np.asarray(jx),
        rtol=1e-9, atol=1e-11)


# --------------------------------------------------------------- cell -----
@pytest.mark.parametrize("name", MORPHS + list(DETAILED))
def test_cell_rhs_setup_solve_vs_jax(models, name):
    jm, tm = models[name]
    N = 11
    Y = _states(jm.C, N, seed=len(name))
    rng = np.random.default_rng(2)
    iinj = rng.uniform(0.0, 0.4, N)
    gamma = rng.uniform(1e-3, 0.2, N)
    b = rng.normal(size=(N, jm.n_state))
    _close(tm.init_state(), jm.init_state())
    jf = jax.vmap(lambda y, i: jm.rhs(0.0, y, i))(Y, iinj)
    _close(tm.rhs(0.0, _t(Y), _t(iinj)), jf)
    g_tot, d_gates, d_syn, _ = tm.jac_terms(_t(Y))
    jg_tot, jd_gates, jd_syn, _ = jax.vmap(jm.jac_terms)(Y)
    _close(g_tot, jg_tot)
    _close(d_gates, jd_gates)
    _close(d_syn.expand(N, 2), jd_syn)
    jfac = jax.vmap(lambda y, g: jm.newton_setup(y, g))(Y, gamma)
    tfac = tm.newton_setup(_t(Y), _t(gamma))
    assert tfac.shape == (N, tm.n_factors()) == tuple(jfac.shape)
    _close(tfac, jfac)
    jx = jax.vmap(jm.newton_solve)(jfac, b)
    _close(tm.newton_solve(tfac, _t(b)), jx)
    w = rng.uniform(0, 1e-3, (2, N))
    _close(tm.apply_event(_t(Y), _t(w[0]), _t(w[1])),
           jax.vmap(jm.apply_event)(Y, w[0], w[1]))
    _close(t_wrms(_t(b), _t(Y), 1e-3, 1e-6),
           jax.vmap(lambda x, y: j_wrms(x, y, 1e-3, 1e-6))(b, Y))


def test_unported_options_raise(models):
    """The options this test once held to ``NotImplementedError`` --
    ``with_plasticity=True`` and ``precond="schur"`` -- are ported: they
    construct, ``reinit`` sizes the factor rows as ``n_factors`` says, and
    only unknown names raise."""
    tp = TCell(tmorph.soma_only(), with_plasticity=True, device="cpu")
    assert (tp.n_state, tp.idx_ca) == (8, 6)
    tm = models["soma"][1]
    Y = _t(_states(1, 2, 0))
    for model, y in ((tm, Y), (tp, tp.init_state()[None].repeat(2, 1))):
        for precond in ("neuron", "schur"):
            st = tbdf.reinit(model, 0.0, y, 0.1,
                             tbdf.BDFOptions(precond=precond))
            width = model.n_state + model.C + (6 * model.C + 2) * (
                precond == "schur")
            assert st.factors.shape == (2, width) == \
                (2, model.n_factors(precond))
            f = model.newton_setup(y, _t(np.ones(2)), mode=precond)
            assert f.shape == st.factors.shape
            x = model.solve_newton_mat(y, _t(np.ones(2)), y, mode=precond)
            assert bool(x.isfinite().all())
            assert bool(model.newton_solve(f, y, mode=precond)
                        .isfinite().all())
    with pytest.raises(ValueError, match="precond"):
        tbdf.reinit(tm, 0.0, Y, 0.1, tbdf.BDFOptions(precond="exact"))
    with pytest.raises(ValueError, match="preconditioner"):
        tm.newton_setup(Y, _t(np.ones(2)), mode="exact")
    # the iteration policy is ported (the fused solve, kernel K3)
    st = tbdf.reinit(tm, 0.0, Y, 0.1, tbdf.BDFOptions(jac_policy="iteration"))
    assert st.t.shape == (2,)


# ---------------------------------------------------------------- bdf -----
@pytest.mark.parametrize("method", ["bdf", "ndf"])
def test_bdf_coefficients_vs_jax(method):
    rng = np.random.default_rng(5)
    L = 40
    q = np.tile(np.arange(1, 6, dtype=np.int32), L // 5)
    h = rng.uniform(1e-3, 0.2, L)
    tau = rng.uniform(1e-3, 0.2, (L, jbdf.LMAX + 1))
    jl, jtq, jg = jax.vmap(lambda a, b, c: jbdf._set_bdf_coeffs(
        a, b, c, method=method))(jnp.asarray(q), h, tau)
    tl, ttq, tg = tbdf._set_bdf_coeffs(_t(q), _t(h), _t(tau), method=method)
    _close(tl, jl)
    _close(tg, jg)
    for a, c in zip(ttq, jtq):
        _close(a, c)
    zn = rng.normal(size=(L, jbdf.LMAX, 7))
    acor = rng.normal(size=(L, 7))
    _close(tbdf._predict(_t(zn), _t(q)), jax.vmap(jbdf._predict)(zn, q))
    _close(tbdf._unpredict(_t(zn), _t(q)), jax.vmap(jbdf._unpredict)(zn, q))
    _close(tbdf._increase_order(_t(zn), _t(tau), _t(h), _t(q), _t(acor)),
           jax.vmap(jbdf._increase_order)(zn, tau, h, q, acor))
    _close(tbdf._decrease_order(_t(zn), _t(tau), _t(h), _t(q)),
           jax.vmap(jbdf._decrease_order)(zn, tau, h, q))
    eta = rng.uniform(0.2, 3.0, L)
    tz, th = tbdf._rescale(_t(zn), _t(tau), _t(h), _t(q), _t(eta))
    jz, jh = jax.vmap(jbdf._rescale)(zn, tau, h, q, eta)
    _close(tz, jz)
    _close(th, jh)


def _assert_state_equal(tst, jst, rtol=1e-10, atol=1e-14):
    got = interop.bdf_state_to_numpy(tst)
    for k, v in jax.tree_util.tree_map(np.asarray, jst)._asdict().items():
        if v.dtype.kind in "biu":
            assert np.array_equal(got[k], v), k
        else:
            np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol,
                                       err_msg=k)


@pytest.mark.parametrize("method", ["bdf", "ndf"])
@pytest.mark.parametrize("name", ["soma", "ball_and_stick"])
def test_step_or_deliver_from_jax_state(models, method, name):
    """One step_or_deliver call from a JAX state with history (q > 1),
    over a mix of deliver and step lanes: floats within rtol 1e-10, q,
    counters and failed exact.  One JAX compile serves the history, the
    call under test and the all-step (``step`` semantics) call."""
    jm, tm = models[name]
    opts_j = jbdf.BDFOptions(method=method)
    opts_t = tbdf.BDFOptions(method=method)
    N = 8
    rng = np.random.default_rng(N + len(name))
    fn = jax.jit(jax.vmap(lambda s, tl, a, g, d, i: jbdf.step_or_deliver(
        jm, s, tl, a, g, d, i, opts_j)))
    Y0 = np.tile(np.asarray(jm.init_state()), (N, 1))
    Y0[:, 0] += rng.uniform(-5.0, 25.0, N)          # soma voltages
    iinj = rng.uniform(0.05, 0.3, N)
    jst = jax.vmap(lambda y, i: jbdf.reinit(jm, 0.0, y, i, opts_j))(Y0, iinj)
    none, zero = np.zeros(N, bool), np.zeros(N)
    for _ in range(6):
        jst = fn(jst, np.full(N, 50.0), zero, zero, none, iinj)
    assert int(np.asarray(jst.q).max()) > 1
    deliver = np.arange(N) % 3 == 0
    wa = np.where(deliver, rng.uniform(0, 2e-3, N), 0.0)
    wg = np.where(deliver, rng.uniform(0, 1e-3, N), 0.0)
    t_lim = np.asarray(jst.t) + rng.uniform(0.05, 1.0, N)
    tst = interop.bdf_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jst), "cpu")
    t_out = tbdf.step_or_deliver(tm, tst, _t(t_lim), _t(wa), _t(wg),
                                 _t(deliver), _t(iinj), opts_t)
    _assert_state_equal(t_out, fn(jst, t_lim, wa, wg, deliver, iinj))
    # the plain step, deliver_event and interpolate on the same state
    j_step = fn(jst, t_lim, zero, zero, none, iinj)
    _assert_state_equal(tbdf.step(tm, tst, _t(t_lim), _t(iinj), opts_t),
                        j_step)
    j_del = jax.vmap(lambda s, a, g, i: jbdf.deliver_event(
        jm, s, a, g, i, opts_j))(jst, wa, wg, iinj)
    _assert_state_equal(tbdf.deliver_event(tm, tst, _t(wa), _t(wg),
                                           _t(iinj), opts_t), j_del)
    t_ev = np.asarray(j_step.t) - 0.3 * np.asarray(j_step.h)
    tstep = interop.bdf_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, j_step), "cpu")
    _close(tbdf.interpolate(tstep, _t(t_ev)),
           jax.vmap(jbdf.interpolate)(j_step, t_ev), rtol=1e-10)
