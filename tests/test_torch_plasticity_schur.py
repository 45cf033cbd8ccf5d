"""Parity of the port's plastic cell (``with_plasticity=True``, the
correlated (ca, rho) pair of paper §2.2) and of the Schur Newton
preconditioner (``precond="schur"``) against the JAX package, on the CPU.

* Cell level: ``rhs``, ``jac_terms``, ``newton_setup``, ``newton_solve``,
  ``solve_newton_mat`` and ``apply_event`` against ``jax.vmap`` of the JAX
  methods within rtol 1e-12, atol 1e-14, on states that include the
  ``exprel`` branch points V = -40 and -55 mV.  The derivatives JAX takes
  by ``jax.jvp`` / ``jax.jacfwd`` are written out in the port
  (``mechanisms.gate_rate_slopes``, ``plasticity_jacobian``) and held to
  JAX's forward mode within the same tolerance.
* Inside the port: the Schur split (setup + solve) equals the fused solve
  within rtol 1e-10, atol 1e-12, and solves I - gamma * J (the dense
  Jacobian) to 1e-8 on the burst state, as ``tests/test_solver.py`` holds
  the reference.
* The fixed-step plastic branch: one step within rtol 1e-12, 400 steps
  within 1e-9 (XLA's exp and FMAs, ROADMAP §3).
* The integrator and the 2c runner: every counter equal to live JAX up to
  3 ms, spike counts and events over 10 ms (the step sequences drift after
  3 ms, ROADMAP §3), and the JAX tests' own checks over 40-50 ms.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)

from repro.core import bdf as jbdf  # noqa: E402
from repro.core import exec_bsp as jbsp  # noqa: E402
from repro.core import exec_fap as jfap  # noqa: E402
from repro.core import fixed_step as jfs  # noqa: E402
from repro.core import mechanisms as jmech  # noqa: E402
from repro.core import morphology as jmorph  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.core.cell import CellModel as JCell  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import bdf as tbdf  # noqa: E402
from repro_torch.core import exec_bsp as tbsp  # noqa: E402
from repro_torch.core import exec_fap as tfap  # noqa: E402
from repro_torch.core import fixed_step as tfs  # noqa: E402
from repro_torch.core import mechanisms as tmech  # noqa: E402
from repro_torch.core import morphology as tmorph  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core.cell import CellModel as TCell  # noqa: E402

from test_torch_cell_bdf import _assert_state_equal, _close, _t  # noqa: E402

MORPHS = ["soma", "ball_and_stick", "branched"]
GAMMAS = (0.001, 0.02, 0.3)
T_FULL = 3.0      # ms, full-parity horizon
T_LONG = 10.0     # ms, spike counts only
T_TOL = 1e-6      # ms, spike times
# states after 3 ms of BDF steps: the counters agree, but a last-bit
# difference of XLA's exp can tip a step-size choice (ROADMAP §3), and the
# runs end on a spike's upstroke (~100 mV/ms): a tenth of atol 1e-3
Y_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    return {(name, plastic): (
        JCell(jmorph.by_name(name), with_plasticity=plastic),
        TCell(tmorph.by_name(name), with_plasticity=plastic, device="cpu"))
        for name in MORPHS for plastic in (False, True)}


def _states(C, N, seed, plastic):
    """Random states [N, n_state]; neurons 0 and 1 sit on exprel's branch
    points (V = -40 and -55 mV in every compartment)."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-80.0, 40.0, (N, C))
    v[0], v[1] = -40.0, -55.0
    parts = [v, rng.uniform(0.0, 1.0, (N, 3 * C)),
             rng.uniform(0.0, 2e-3, (N, 2))]
    if plastic:
        parts.append(np.stack([rng.uniform(0.0, 2.5, N),
                               rng.uniform(0.0, 1.0, N)], axis=1))
    return np.concatenate(parts, axis=1)


def _close_rows(port, ref):
    """Solutions of the Newton system: within RTOL of each entry plus RTOL
    of the row's largest entry.  Under ``"schur"`` the voltage diagonal
    subtracts gamma * Jvx * Jxv / den from cap / gamma + g_tot, and a gate
    correction gamma * Jxv * xv / den cancels against b / den: the last
    bits in which XLA's exp and ``detmath.exp`` differ come out of them
    about 1e-13 of the row's scale (``newton_setup``'s rows and
    ``newton_solve`` on the same rows agree entry by entry)."""
    ref = np.asarray(ref)
    scale = np.abs(ref).max(axis=1, keepdims=True)
    err = np.abs(port.detach().numpy() - ref)
    assert np.all(err <= 1e-12 * (np.abs(ref) + scale)), float(
        (err / (np.abs(ref) + scale)).max())


# ------------------------------------------------------------ mechanisms --
def test_written_out_derivatives_vs_jax_forward_mode():
    v = np.concatenate([np.linspace(-90.0, 50.0, 301),
                        [-40.0, -55.0, -40.0 + 1e-8, -55.0 - 1e-8,
                         -40.0 + 2e-8, -55.0 + 2e-8]])
    _, want = jax.jvp(jmech.gate_rates, (jnp.asarray(v),),
                      (jnp.ones_like(v),))
    got = tmech.gate_rate_slopes(_t(v))
    for g, w in zip(got, want):
        _close(g[:303], w[:303])
        # within 2e-8 mV of a branch point x is about 1e-9 and the quotient
        # rule cancels two terms of about 1/x: both packages keep only
        # 1e-16 / 1e-9 of the slope's digits there
        _close(g[303:], w[303:], rtol=1e-6, atol=0)
    # the branch ``1 - x/2`` of exprel has slope -1/2 at x = 0
    assert float(got.a_m[301]) == 1.0 * 0.05
    assert float(got.a_n[302]) == 0.1 * 0.05
    rng = np.random.default_rng(4)
    ca, rho = rng.uniform(0.0, 3.0, 200), rng.uniform(-0.1, 1.1, 200)
    jac = jax.vmap(jax.jacfwd(lambda e: jnp.stack(
        jmech.plasticity_derivs(e[0], e[1]))))(np.stack([ca, rho], 1))
    got = tmech.plasticity_jacobian(_t(ca), _t(rho))
    for k, g in enumerate(got):
        _close(g, jac[:, k // 2, k % 2])


# ------------------------------------------------------------------ cell --
@pytest.mark.parametrize("mode", ["neuron", "schur"])
@pytest.mark.parametrize("plastic", [False, True])
@pytest.mark.parametrize("name", MORPHS)
def test_cell_vs_jax(models, name, plastic, mode):
    jm, tm = models[(name, plastic)]
    assert tm.n_state == jm.n_state == 4 * jm.C + 2 + 2 * plastic
    assert tm.n_factors(mode) == jm.n_factors(mode)
    N = 9
    Y = _states(jm.C, N, seed=len(name) + plastic, plastic=plastic)
    rng = np.random.default_rng(2)
    iinj = rng.uniform(0.0, 0.4, N)
    b = rng.normal(size=(N, jm.n_state))
    _close(tm.init_state(), jm.init_state())
    _close(tm.rhs(0.0, _t(Y), _t(iinj)),
           jax.vmap(lambda y, i: jm.rhs(0.0, y, i))(Y, iinj))
    for got, want in zip(tm.jac_terms(_t(Y)), jax.vmap(jm.jac_terms)(Y)):
        _close(got.expand(want.shape), want)
    for gamma in GAMMAS:
        g = np.full(N, gamma)
        jfac = jax.vmap(lambda y: jm.newton_setup(y, gamma, mode=mode))(Y)
        tfac = tm.newton_setup(_t(Y), _t(g), mode=mode)
        assert tfac.shape == (N, tm.n_factors(mode)) == tuple(jfac.shape)
        _close(tfac, jfac)
        jx = jax.vmap(lambda f, bb: jm.newton_solve(f, bb, mode=mode))(
            jfac, b)
        _close(tm.newton_solve(_t(np.array(jfac)), _t(b), mode=mode), jx)
        _close_rows(tm.newton_solve(tfac, _t(b), mode=mode), jx)
        _close_rows(tm.solve_newton_mat(_t(Y), _t(g), _t(b), mode=mode),
                    jax.vmap(lambda y, bb: jm.solve_newton_mat(
                        y, gamma, bb, mode=mode))(Y, b))
    # the calcium jump lands exactly where w_ampa > 0 (lanes 0, 3, 6 get
    # an inhibitory weight only)
    wa = np.where(np.arange(N) % 3 == 0, 0.0, rng.uniform(0, 1e-3, N))
    wg = rng.uniform(0, 1e-3, N)
    got = tm.apply_event(_t(Y), _t(wa), _t(wg))
    _close(got, jax.vmap(jm.apply_event)(Y, wa, wg), rtol=0, atol=0)
    if plastic:
        jumped = (got[:, tm.idx_ca] - _t(Y)[:, tm.idx_ca]).numpy()
        assert np.array_equal(jumped > 0, wa > 0)


@pytest.mark.parametrize("precond", ["neuron", "schur"])
@pytest.mark.parametrize("name", ["soma", "ball_and_stick"])
def test_plastic_step_or_deliver_from_jax_state(models, name, precond):
    """One step_or_deliver call from a plastic JAX state with history:
    delivering lanes with and without an AMPA weight, stepping lanes that
    carry an AMPA weight (which must receive no calcium); floats within
    rtol 1e-10, integers exact."""
    jm, tm = models[(name, True)]
    opts_j = jbdf.BDFOptions(precond=precond)
    opts_t = tbdf.BDFOptions(precond=precond)
    N = 9
    rng = np.random.default_rng(N + len(name))
    fn = jax.jit(jax.vmap(lambda s, tl, a, g, d, i: jbdf.step_or_deliver(
        jm, s, tl, a, g, d, i, opts_j)))
    Y0 = np.tile(np.asarray(jm.init_state()), (N, 1))
    Y0[:, 0] += rng.uniform(-5.0, 25.0, N)
    Y0[:, jm.idx_ca] = rng.uniform(0.0, 2.0, N)
    iinj = rng.uniform(0.05, 0.3, N)
    jst = jax.vmap(lambda y, i: jbdf.reinit(jm, 0.0, y, i, opts_j))(Y0, iinj)
    none, zero = np.zeros(N, bool), np.zeros(N)
    for _ in range(6):
        jst = fn(jst, np.full(N, 50.0), zero, zero, none, iinj)
    assert int(np.asarray(jst.q).max()) > 1
    assert jst.factors.shape == (N, tm.n_factors(precond))
    deliver = np.arange(N) % 2 == 0
    wa = np.where(np.arange(N) % 4 == 0, 0.0, rng.uniform(1e-4, 2e-3, N))
    wg = rng.uniform(0, 1e-3, N)
    t_lim = np.asarray(jst.t) + rng.uniform(0.05, 1.0, N)
    tst = interop.bdf_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jst), "cpu")
    got = tbdf.step_or_deliver(tm, tst, _t(t_lim), _t(wa), _t(wg),
                               _t(deliver), _t(iinj), opts_t)
    _assert_state_equal(got, fn(jst, t_lim, wa, wg, deliver, iinj))
    ca0 = tst.zn[:, 0, tm.idx_ca].numpy()
    ca = got.zn[:, 0, tm.idx_ca].numpy()
    jump = deliver & (wa > 0)
    assert jump.any() and (deliver & (wa == 0)).any()
    assert np.array_equal(ca[jump], ca0[jump] + tmech.CA_JUMP)
    assert np.array_equal(ca[deliver & ~jump], ca0[deliver & ~jump])
    assert np.all(ca[~deliver] < ca0[~deliver])     # decay only


# -------------------------------------------------- schur, port alone --
@pytest.mark.parametrize("plastic", [False, True])
@pytest.mark.parametrize("name", ["soma", "branched"])
def test_schur_split_matches_fused(models, name, plastic):
    tm = models[(name, plastic)][1]
    rng = np.random.default_rng(tm.n_state)
    N = 5
    Y = tm.init_state()[None].repeat(N, 1) \
        + 0.01 * _t(rng.standard_normal((N, tm.n_state)))
    b = _t(rng.standard_normal((N, tm.n_state)))
    for gamma in GAMMAS:
        g = torch.full((N,), gamma, dtype=torch.float64)
        for mode in ("neuron", "schur"):
            split = tm.newton_solve(tm.newton_setup(Y, g, mode=mode), b,
                                    mode=mode)
            _close(split, tm.solve_newton_mat(Y, g, b, mode=mode).numpy(),
                   rtol=1e-10, atol=1e-12)


def _soma_trace(tm, iinj, t_end, opts):
    one = torch.full((1,), iinj, dtype=torch.float64)
    st = tbdf.reinit(tm, 0.0, tm.init_state()[None], one, opts)
    return tbdf.advance_to(tm, st, t_end, one, opts)


@pytest.mark.parametrize("where", ["rest", "burst"])
def test_schur_solves_the_dense_system(models, where):
    """At rest (gamma 0.05) and on the stiff burst state (20 ms at 0.15
    nA, gamma 0.02) the Schur split solves (I - gamma J) x = b with J the
    dense Jacobian (``torch.func.jacfwd`` of ``rhs``) to 1e-8."""
    tm = models[("soma", False)][1]
    if where == "rest":
        y, gamma = tm.init_state(), 0.05
    else:
        st = _soma_trace(tm, 0.15, 20.0, tbdf.BDFOptions(atol=1e-3))
        assert not bool(st.failed[0])
        y, gamma = st.zn[0, 0], 0.02
    b = _t(np.random.default_rng(0).standard_normal(tm.n_state))
    g = torch.full((1,), gamma, dtype=torch.float64)
    M = torch.eye(tm.n_state, dtype=torch.float64) \
        - gamma * tm.dense_jacobian(0.0, y)
    for x in (tm.newton_solve(tm.newton_setup(y[None], g, mode="schur"),
                              b[None], mode="schur")[0],
              tm.solve_newton_mat(y[None], g, b[None], mode="schur")[0]):
        assert float((M @ x - b).abs().max()) < 1e-8


# ------------------------------------------------------------ fixed step --
@pytest.mark.parametrize("method", ["cnexp", "euler", "derivimplicit"])
def test_plastic_fixed_step_vs_jax(models, method):
    """One step of 200 random plastic states within rtol 1e-12; 400 steps
    (10 ms, V_soma recorded every 4) through spikes within 1e-9."""
    jm, tm = models[("ball_and_stick", True)]
    rng = np.random.default_rng(len(method))
    Y = _states(jm.C, 200, len(method), True)
    Y[:, 4 * jm.C:4 * jm.C + 2] *= 5.0
    iinj = rng.random(200) * 0.3
    want = jax.jit(jax.vmap(jfs.make_stepper(jm, method, 0.025)))(Y, iinj)
    got = tfs.make_stepper(tm, method, 0.025, device="cpu")(_t(Y), _t(iinj))
    _close(got, want, rtol=1e-12, atol=1e-13)
    N = 4
    iinj = np.linspace(0.05, 0.5, N)
    Y0 = np.tile(np.asarray(jm.init_state()), (N, 1))
    Y0[:, jm.idx_ca] = np.linspace(0.5, 3.0, N)
    jy, jtr = jax.jit(jax.vmap(lambda y, i: jfs.run_fixed(
        jm, y, 10.0, i, method=method, record_every=4)[::2]))(Y0, iinj)
    ty, n_steps, ttr = tfs.run_fixed(tm, _t(Y0), 10.0, _t(iinj),
                                     method=method, record_every=4,
                                     device="cpu")
    assert n_steps == 400
    _close(ty, jy, rtol=0, atol=1e-9)
    _close(ttr.T, jtr, rtol=0, atol=1e-9)
    rho = ty[:, -1]
    assert bool(((rho >= 0.0) & (rho <= 1.0)).all())


# -------------------------------------------------------- single neuron --
ADVANCE_CASES = [("soma", True, "neuron"), ("soma", False, "schur"),
                 ("soma", True, "schur"), ("branched", True, "schur")]


@pytest.mark.parametrize("name,plastic,precond", ADVANCE_CASES)
def test_advance_to_vs_jax(models, name, plastic, precond):
    """An event (1 uS AMPA) then ``advance_to`` 3 ms at 0.3 nA: every
    counter equal to live JAX and the state within a tenth of the
    integrator's atol (``Y_TOL``)."""
    jm, tm = models[(name, plastic)]
    oj = jbdf.BDFOptions(atol=1e-3, precond=precond)
    ot = tbdf.BDFOptions(atol=1e-3, precond=precond)
    jst = jbdf.reinit(jm, 0.0, jm.init_state(), 0.3, oj)
    jst = jbdf.deliver_event(jm, jst, 1e-3, 0.0, 0.3, oj)
    jst = jax.jit(lambda s: jbdf.advance_to(jm, s, T_FULL, 0.3, oj))(jst)
    one = torch.full((1,), 0.3, dtype=torch.float64)
    tst = tbdf.reinit(tm, 0.0, tm.init_state()[None], one, ot)
    tst = tbdf.deliver_event(tm, tst, torch.full_like(one, 1e-3),
                             torch.zeros_like(one), one, ot)
    tst = tbdf.advance_to(tm, tst, T_FULL, one, ot)
    for k in ("nst", "nfe", "nni", "netf", "nncf", "nreset", "nsetups",
              "q", "failed"):
        assert int(getattr(tst, k)[0]) == int(getattr(jst, k)), k
    assert float(tst.t[0]) == float(jst.t) == T_FULL
    _close(tst.zn[0, 0], jst.zn[0], rtol=0, atol=Y_TOL)
    if plastic:
        assert float(tst.zn[0, 0, tm.idx_ca]) > 0.0      # the jump, decaying


def test_plasticity_complex_model_fully_implicit(models):
    """``tests/test_bdf.py``'s check on the port: the correlated cubic pair
    integrates stably through an event for 50 ms, rho within [0, 1]."""
    tm = models[("soma", True)][1]
    opts = tbdf.BDFOptions(atol=1e-4)
    zero = torch.zeros((1,), dtype=torch.float64)
    st = tbdf.reinit(tm, 0.0, tm.init_state()[None], zero, opts)
    st = tbdf.deliver_event(tm, st, torch.full_like(zero, 1e-3), zero, zero,
                            opts)
    st = tbdf.advance_to(tm, st, 50.0, zero, opts)
    assert not bool(st.failed[0])
    y = st.zn[0, 0]
    assert bool(torch.isfinite(y).all())
    assert 0.0 <= float(y[tm.idx_ca + 1]) <= 1.0


def test_schur_preconditioner_matches_and_tightens(models):
    """``tests/test_bdf.py``'s check on the port: 40 ms at 0.15 nA, the
    Schur run ends within 0.5 mV of the default's with no more Newton
    iterations and convergence failures."""
    tm = models[("soma", False)][1]
    outs = {mode: _soma_trace(tm, 0.15, 40.0,
                              tbdf.BDFOptions(atol=1e-3, precond=mode))
            for mode in ("neuron", "schur")}
    for st in outs.values():
        assert not bool(st.failed[0])
    s, d = outs["schur"], outs["neuron"]
    assert abs(float(s.zn[0, 0, 0]) - float(d.zn[0, 0, 0])) < 0.5
    assert int(s.nni[0]) <= int(d.nni[0])
    assert int(s.nncf[0]) <= int(d.nncf[0])


# ---------------------------------------------------------------- runners --
def _iinj(N, base, seed):
    return base * (1.0 + 0.2 * np.random.default_rng(seed).random(N))


@pytest.fixture(scope="module", params=[(T_FULL, "reuse"),
                                        (T_FULL, "iteration"),
                                        (T_LONG, "reuse")],
                ids=["3ms", "3ms-iteration", "10ms"])
def fap_pair(request):
    """The 2c runner on the plastic soma under ``precond="schur"`` at
    N = 12: live JAX and the port."""
    t_end, policy = request.param
    N = 12
    iinj = _iinj(N, 0.16, N)
    kw = dict(horizon_impl="fused")
    jr, jrounds = jfap.make_fap_vardt_runner(
        JCell(jmorph.soma_only(), with_plasticity=True),
        jnet.make_network(N, k_in=4, seed=3), iinj, t_end,
        opts=jbdf.BDFOptions(precond="schur", jac_policy=policy), **kw)()
    tr, trounds = tfap.make_fap_vardt_runner(
        TCell(tmorph.soma_only(), with_plasticity=True, device="cpu"),
        tnet.make_network(N, k_in=4, seed=3), iinj, t_end,
        opts=tbdf.BDFOptions(precond="schur", jac_policy=policy),
        device="cpu", **kw)()
    return t_end, policy, jr, int(jrounds), tr, trounds


def test_plastic_schur_2c_vs_live_jax(fap_pair):
    t_end, policy, jr, jrounds, tr, trounds = fap_pair
    jcount = np.asarray(jr.rec.count)
    assert jcount.sum() > 0
    assert np.array_equal(tr.rec.count.numpy(), jcount)
    for k in ("n_events", "n_resets", "dropped", "failed"):
        assert int(getattr(tr, k)) == int(getattr(jr, k)), k
    assert int(tr.dropped) == 0 and not bool(tr.failed)
    rho = tr.y_final[:, -1]
    assert bool(((rho >= 0.0) & (rho <= 1.0)).all())
    if t_end == T_FULL:
        assert trounds == jrounds
        assert int(tr.n_steps) == int(jr.n_steps)
        for k, v in jr.solver.items():
            assert int(tr.solver[k]) == int(v), k
        if policy == "iteration":
            assert int(tr.solver["nsetups"]) == int(tr.solver["nni"])
        jt, tt = np.asarray(jr.rec.times), tr.rec.times.numpy()
        fin = np.isfinite(jt)
        assert np.array_equal(np.isfinite(tt), fin)
        np.testing.assert_allclose(tt[fin], jt[fin], rtol=0, atol=T_TOL)
        _close(tr.y_final, jr.y_final, rtol=0, atol=Y_TOL)


@pytest.mark.parametrize("method", ["cnexp", "derivimplicit"])
def test_plastic_bsp_fixed_vs_live_jax(method):
    """1a and 2a on the plastic ball-and-stick cell at N = 12, 6 ms: spike
    counts, events and steps equal to live JAX, states within 1e-9."""
    N = 12
    iinj = _iinj(N, 0.3, 1)
    jr = jbsp.run_bsp_fixed(
        JCell(jmorph.ball_and_stick(), with_plasticity=True),
        jnet.make_network(N, k_in=4, seed=3), iinj, 6.0, method=method)
    tr = tbsp.run_bsp_fixed(
        TCell(tmorph.ball_and_stick(), with_plasticity=True, device="cpu"),
        tnet.make_network(N, k_in=4, seed=3), iinj, 6.0, method=method,
        device="cpu")
    assert np.asarray(jr.rec.count).sum() > 0
    assert np.array_equal(tr.rec.count.numpy(), np.asarray(jr.rec.count))
    for k in ("n_steps", "n_events", "dropped"):
        assert int(getattr(tr, k)) == int(getattr(jr, k)), k
    _close(tr.y_final, jr.y_final, rtol=0, atol=1e-9)


@pytest.mark.parametrize("runner", ["1c", "2b-compact", "2b-schur"])
def test_plastic_cell_runs_in_every_runner(runner):
    """1c FAP-fixed equals 1a BSP-fixed on the plastic cell; 2b BSP-vardt
    under ``precond="schur"`` and compact batching equals its dense twin.
    Every run delivers events, drops none and keeps rho within [0, 1]."""
    N = 12
    model = TCell(tmorph.soma_only(), with_plasticity=True, device="cpu")
    net = tnet.make_network(N, k_in=4, seed=3)
    iinj = _iinj(N, 0.3, 2)
    if runner == "1c":
        a = tbsp.run_bsp_fixed(model, net, iinj, 6.0, device="cpu")
        b, _ = tfap.make_fap_fixed_runner(model, net, iinj, 6.0,
                                          device="cpu")()
        np.testing.assert_allclose(b.rec.times.numpy(), a.rec.times.numpy(),
                                   rtol=0, atol=1e-9)
    else:
        opts = tbdf.BDFOptions(precond="schur" if runner == "2b-schur"
                               else "neuron")
        a = tbsp.run_bsp_vardt(model, net, iinj, 4.0, opts=opts,
                               device="cpu")
        b = tbsp.run_bsp_vardt(model, net, iinj, 4.0, opts=opts,
                               batch="compact", batch_cap=5, device="cpu")
        assert torch.equal(a.rec.times, b.rec.times)
        assert torch.equal(a.y_final, b.y_final)
    for r in (a, b):
        assert int(r.n_events) > 0 and int(r.dropped) == 0
        assert not bool(r.failed)
        assert torch.equal(r.rec.count, a.rec.count)
        rho = r.y_final[:, -1]
        assert bool(((rho >= 0.0) & (rho <= 1.0)).all())
