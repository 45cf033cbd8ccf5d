"""Parity of the PyTorch port's static inputs, mechanisms, kernels' plain
versions and event queues against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
side runs as its own tests run it: the Pallas wrappers in interpret mode,
the rest through jnp.  The Hines kernels are held to the JAX ``ref``
oracles: the JAX package's Hines Pallas wrappers do not run on jax 0.9
(``pl.load`` is gone; ROADMAP §3).  The CUDA kernels themselves are held
to their plain versions by ``tests/test_torch_cuda.py``, which skips
without a card, and by ``chip_smoke.py`` on the card.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)

from repro.core import events as jev  # noqa: E402
from repro.core import mechanisms as jmech  # noqa: E402
from repro.core import morphology as jmorph  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.core.hines import hines_assemble as j_assemble  # noqa: E402
from repro.kernels.event_wheel import ops as jew_ops  # noqa: E402
from repro.kernels.event_wheel import ref as jew_ref  # noqa: E402
from repro.kernels.hh_rhs.ops import hh_rhs_batched  # noqa: E402
from repro.kernels.hh_rhs.ref import hh_rhs_ref as j_hh_rhs_ref  # noqa: E402
from repro.kernels.hines import ref as jh_ref  # noqa: E402

from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import mechanisms as tmech  # noqa: E402
from repro_torch.core import morphology as tmorph  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.kernels.event_wheel import ops as tew_ops  # noqa: E402
from repro_torch.kernels.hh_rhs import ops as thh_ops  # noqa: E402
from repro_torch.kernels.hh_rhs import ref as thh_ref  # noqa: E402
from repro_torch.kernels.hines import ops as th_ops  # noqa: E402
from repro_torch.kernels.hines import ref as th_ref  # noqa: E402

RTOL, ATOL = 1e-12, 1e-14


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------------ network -----
@pytest.mark.parametrize("topology", ["uniform", "block", "ring", "grid2d",
                                      "smallworld"])
def test_make_network_array_identical(topology):
    a = jnet.make_network(64, k_in=6, seed=5, topology=topology)
    b = tnet.make_network(64, k_in=6, seed=5, topology=topology)
    assert a.n == b.n and a.min_delay == b.min_delay
    for f in ("pre", "post", "delay", "w_ampa", "w_gaba"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.block is None) == (b.block is None)
    if a.block is not None:
        assert np.array_equal(a.block, b.block)


@pytest.mark.parametrize("name", ["soma", "ball_and_stick", "branched"])
def test_morphology_identical(name):
    a, b = jmorph.by_name(name), tmorph.by_name(name)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert jnet.regime_current("fast", 0.1) == tnet.regime_current("fast", 0.1)


# --------------------------------------------------------- mechanisms -----
def test_mechanisms_elementwise():
    rng = np.random.default_rng(0)
    v = rng.uniform(-100.0, 60.0, 4000)
    # exact singular points of the rates and |x| around the 1e-9 branch
    v = np.concatenate([v, [-40.0, -55.0], -40.0 + 10.0 * np.array(
        [1e-12, -1e-12, 5e-10, -5e-10, 1e-9, -1e-9, 2e-9, -2e-9, 1e-7])])
    x = np.concatenate([rng.uniform(-30, 30, 200),
                        [0.0, 1e-12, -1e-12, 9.99e-10, -9.99e-10, 1e-9,
                         -1e-9, 1.01e-9, -1.01e-9, 1e-8]])
    _close(tmech.exprel(_t(x)), jmech.exprel(jnp.asarray(x)))
    for fn in ("alpha_m", "beta_m", "alpha_h", "beta_h", "alpha_n", "beta_n"):
        _close(getattr(tmech, fn)(_t(v)), getattr(jmech, fn)(jnp.asarray(v)))
    m, h, n = rng.uniform(0, 1, (3, v.size))
    for a, b in zip(tmech.gate_derivs(_t(v), _t(m), _t(h), _t(n)),
                    jmech.gate_derivs(v, m, h, n)):
        _close(a, b)
    area = rng.uniform(10, 1300, v.size)
    _close(tmech.ionic_current(_t(area), _t(v), _t(m), _t(h), _t(n)),
           jmech.ionic_current(area, v, m, h, n))
    for (a, b), (c, d) in zip(tmech.gate_inf_tau(_t(v)), jmech.gate_inf_tau(v)):
        _close(a, c)
        _close(b, d)
    ca, rho = rng.uniform(0, 3, (2, 300))
    for a, b in zip(tmech.plasticity_derivs(_t(ca), _t(rho)),
                    jmech.plasticity_derivs(ca, rho)):
        _close(a, b)


# ------------------------------------------------------- hines K1/K2 ------
HINES_CASES = [("soma", jmorph.soma_only(), 7),
               ("bs", jmorph.ball_and_stick(5), 33),
               ("br2", jmorph.branched_tree(2, 2), 70)]


def _hines_inputs(m, N, seed):
    rng = np.random.default_rng(seed)
    de = rng.uniform(0.5, 1.5, (N, m.n_comp))
    d = np.asarray(jax.vmap(lambda x: j_assemble(
        jnp.asarray(m.parent), jnp.asarray(m.g_axial), x))(de)).T.copy()
    b = rng.normal(size=(m.n_comp, N))
    return d, b


@pytest.mark.parametrize("name,m,N", HINES_CASES)
def test_hines_factor_and_solve_plain_vs_jax(name, m, N):
    d, b = _hines_inputs(m, N, len(name) + N)
    parent, gax = jnp.asarray(m.parent), jnp.asarray(m.g_axial)
    tpar, tgax = _t(m.parent), _t(m.g_axial)
    de_t = th_ops.hines_factor(tpar, tgax, _t(d))
    de_j = jh_ref.hines_factor_ref(parent, gax, jnp.asarray(d))
    _close(de_t, de_j)
    x_t = th_ops.hines_solve_factored(tpar, tgax, de_t, _t(b))
    _close(x_t, jh_ref.hines_solve_factored_ref(parent, gax, de_j,
                                                jnp.asarray(b)))
    _close(x_t, jh_ref.hines_solve_ref(parent, gax, jnp.asarray(d),
                                       jnp.asarray(b)))
    # inside the port: factor + factored solve == fused solve, bitwise
    assert torch.equal(x_t, th_ref.hines_solve_ref(tpar, tgax, _t(d), _t(b)))


def test_hines_ops_accept_transposed_views():
    m = jmorph.branched_tree(2, 2)
    d, b = _hines_inputs(m, 40, 1)
    tpar, tgax = _t(m.parent), _t(m.g_axial)
    de = th_ops.hines_factor(tpar, tgax, _t(d))
    de_v = th_ops.hines_factor(tpar, tgax, _t(d.T.copy()).T)
    assert torch.equal(de, de_v)
    x = th_ops.hines_solve_factored(tpar, tgax, de, _t(b))
    x_v = th_ops.hines_solve_factored(tpar, tgax, de_v, _t(b.T.copy()).T)
    assert torch.equal(x, x_v)


# ---------------------------------------------------------- hh_rhs K4 -----
@pytest.mark.parametrize("N,C", [(1, 1), (37, 11), (64, 13)])
def test_hh_rhs_plain_vs_jax(N, C):
    rng = np.random.default_rng(N * 100 + C)
    area = rng.uniform(50, 1300, C)
    v = rng.uniform(-90, 50, (N, C))
    m, h, n = rng.uniform(0, 1, (3, N, C))
    outs_t = thh_ops.hh_rhs(_t(area), _t(v), _t(m), _t(h), _t(n))
    outs_k = hh_rhs_batched(jnp.asarray(area), jnp.asarray(v), jnp.asarray(m),
                            jnp.asarray(h), jnp.asarray(n), block_n=128)
    outs_r = j_hh_rhs_ref(jnp.asarray(area), jnp.asarray(v), jnp.asarray(m),
                          jnp.asarray(h), jnp.asarray(n))
    for a, b, c in zip(outs_t, outs_k, outs_r):
        _close(a, b)
        _close(a, c)
    # strided views of one packed state (how the cell model calls it)
    Y = _t(np.concatenate([v, m, h, n], axis=1))
    outs_v = thh_ref.hh_rhs_ref(_t(area), Y[:, :C], Y[:, C:2 * C],
                                Y[:, 2 * C:3 * C], Y[:, 3 * C:])
    for a, b in zip(outs_t, outs_v):
        assert torch.equal(a, b)


# ------------------------------------------------------- horizon K5 -------
@pytest.mark.parametrize("k_select", [0, 5])
def test_fused_horizon_select_bitwise(k_select):
    net = jnet.make_network(300, k_in=16, seed=4)
    rng = np.random.default_rng(9)
    t_clock = rng.uniform(0.0, 3.0, net.n)
    t_clock[:7] = 20.0                     # some clocks at t_end
    pre_j, dly_j = jew_ops.by_post_layout(net)
    hor_j, run_j = jew_ops.fused_horizon_select(
        jnp.asarray(t_clock), pre_j, dly_j, t_end=20.0, horizon_cap=2.0,
        k_select=k_select)
    pre_t, dly_t = tew_ops.by_post_layout(tnet.make_network(300, k_in=16,
                                                            seed=4), "cpu")
    assert pre_t.dtype == torch.int32 and pre_t.is_contiguous()
    assert np.array_equal(pre_t.numpy(), np.asarray(pre_j))
    assert np.array_equal(dly_t.numpy(), np.asarray(dly_j))
    hor_t, run_t = tew_ops.fused_horizon_select(
        _t(t_clock), pre_t, dly_t, t_end=20.0, horizon_cap=2.0,
        k_select=k_select)
    assert np.array_equal(hor_t.numpy(), np.asarray(hor_j))
    assert np.array_equal(run_t.numpy(), np.asarray(run_j))
    # and the score itself against the JAX oracle
    cand = np.asarray(jnp.asarray(t_clock)[pre_j] + dly_j)
    h_r, s_r = jew_ref.horizon_score_ref(jnp.asarray(cand),
                                         jnp.asarray(t_clock), t_end=20.0,
                                         horizon_cap=2.0)
    h_t, s_t = tew_ops.horizon_score(_t(t_clock), pre_t, dly_t, t_end=20.0,
                                     horizon_cap=2.0)
    assert np.array_equal(h_t.numpy(), np.asarray(h_r))
    assert np.array_equal(s_t.numpy(), np.asarray(s_r))


SPECIAL_CLOCKS = {"none": None, "t_end": 20.0, "inf": np.inf,
                  "-inf": -np.inf, "nan": np.nan}


@pytest.mark.parametrize("special", list(SPECIAL_CLOCKS))
@pytest.mark.parametrize("K", [1, 5, 16])
def test_horizon_plain_matches_jax_at_edge_clocks(K, special):
    """K5's plain version against the JAX package's
    ``fused_horizon_select`` (the Pallas kernel in interpret mode) and
    ``ref.horizon_score_ref``, at K = 1, 5 and 16 in-edges: clocks at
    t_end, +-inf or NaN on a tenth of the neurons and neuron 0, horizon
    caps that put a clock within eps of its horizon on both sides, and
    in-edges of ~0 delay whose candidates lie within eps of a clock.
    NaNs compare equal to NaNs."""
    N = 300
    rng = np.random.default_rng(K * 11 + len(special))
    pre = rng.integers(0, N, (K, N)).astype(np.int32)
    dly = rng.uniform(0.1, 3.0, (K, N))
    near = rng.random(N) < 0.2
    dly[:, near] = rng.uniform(1e-13, 3e-12, (K, int(near.sum())))
    tc = rng.uniform(0.0, 20.0, N)
    if SPECIAL_CLOCKS[special] is not None:
        tc[rng.random(N) < 0.1] = SPECIAL_CLOCKS[special]
        tc[0] = SPECIAL_CLOCKS[special]
    tc_j, pre_j, dly_j = jnp.asarray(tc), jnp.asarray(pre), jnp.asarray(dly)
    cand = tc_j[pre_j] + dly_j
    for cap in (2.0, 0.5e-12, 1e-12, 2e-12):
        kw = dict(t_end=20.0, horizon_cap=cap)
        hor_j, run_j = jew_ops.fused_horizon_select(tc_j, pre_j, dly_j, **kw)
        hor_t, run_t = tew_ops.fused_horizon_select(_t(tc), _t(pre), _t(dly),
                                                    **kw)
        np.testing.assert_array_equal(hor_t.numpy(), np.asarray(hor_j))
        np.testing.assert_array_equal(run_t.numpy(), np.asarray(run_j))
        h_r, s_r = jew_ref.horizon_score_ref(cand, tc_j, **kw)
        h_t, s_t = tew_ops.horizon_score(_t(tc), _t(pre), _t(dly), **kw)
        np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_r))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_r))
        if special == "none" and cap < 1e-12:     # within eps: not runnable
            assert not bool(run_t.any())


def test_select_threshold_matches_jax():
    rng = np.random.default_rng(3)
    score = rng.uniform(0, 5, 500)
    score[rng.random(500) < 0.3] = np.inf
    for k in (1, 17, 400, 600):
        a = tew_ops.select_threshold(_t(score), k)
        b = jew_ops.select_threshold(jnp.asarray(score), k)
        assert float(a) == float(b)


# ------------------------------------------------------------- events -----
def _queue_case(seed, n=20, cap=6, E=90):
    rng = np.random.default_rng(seed)
    t0 = np.where(rng.random((n, cap)) < 0.4, rng.uniform(0, 5, (n, cap)),
                  np.inf)
    wa0, wg0 = rng.uniform(0, 1e-3, (2, n, cap))
    tgt = rng.integers(0, n, E).astype(np.int32)
    t_ev = rng.uniform(0, 9, E)
    wa, wg = rng.uniform(0, 1e-3, (2, E))
    valid = rng.random(E) < 0.7
    return n, t0, wa0, wg0, tgt, t_ev, wa, wg, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("which", ["insert", "insert_rows"])
def test_queue_insert_exact(seed, which):
    n, t0, wa0, wg0, tgt, t_ev, wa, wg, valid = _queue_case(seed)
    jq = jev.EventQueue(jnp.asarray(t0), jnp.asarray(wa0), jnp.asarray(wg0),
                        jnp.zeros((), jnp.int32))
    tq = tev.EventQueue(_t(t0), _t(wa0), _t(wg0),
                        torch.zeros((), dtype=torch.int32))
    args = (tgt, t_ev, wa, wg, valid)
    a = getattr(jev, which)(jq, *map(jnp.asarray, args))
    b = getattr(tev, which)(tq, *map(_t, args))
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), y.numpy())
    assert int(b.dropped) > 0            # the case exercises overflow
    # delivery and next_time
    t_dl = np.random.default_rng(seed).uniform(0, 9, n)
    for x, y in zip(jev.deliver_until(a, jnp.asarray(t_dl)),
                    tev.deliver_until(b, _t(t_dl))):
        if isinstance(x, tuple):
            for u, w in zip(x, y):
                assert np.array_equal(np.asarray(u), w.numpy())
        else:
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=RTOL,
                                       atol=0)
    assert np.array_equal(np.asarray(jev.next_time(a)),
                          tev.next_time(b).numpy())


def test_record_spikes_exact():
    rng = np.random.default_rng(4)
    n, cap = 10, 3
    jr = jev.make_spike_record(n, cap)
    tr = tev.make_spike_record(n, cap, "cpu")
    for _ in range(6):
        valid = rng.random(n) < 0.6
        ts = rng.uniform(0, 10, n)
        ids = np.arange(n, dtype=np.int32)
        jr = jev.record_spikes(jr, jnp.asarray(ids), jnp.asarray(ts),
                               jnp.asarray(valid))
        tr = tev.record_spikes(tr, _t(ids), _t(ts), _t(valid))
    for x, y in zip(jr, tr):
        assert np.array_equal(np.asarray(x), y.numpy())
    assert int(tr.overflow) > 0


# --------------------------------------------------- deterministic math ---
def test_detmath_within_two_ulp():
    """The device-independent exp/expm1/log/pow/sqrt of the neuron core."""
    from repro_torch.core import detmath as dm
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.uniform(-40, 40, 20000),
                        rng.uniform(-1e-3, 1e-3, 2000), [0.0, -1e-9, 0.5]])
    pos = np.concatenate([10.0 ** rng.uniform(-300, 300, 20000),
                          rng.uniform(0, 10, 2000)])
    base = rng.uniform(0.0, 60.0, 5000)     # the controller's 6*dsm etc.
    expo = rng.uniform(0.1, 1.0, base.size)
    for got, ref in ((dm.exp(_t(x)), np.exp(x)), (dm.expm1(_t(x)), np.expm1(x)),
                     (dm.log(_t(pos)), np.log(pos)),
                     (dm.sqrt(_t(pos)), np.sqrt(pos))):
        ulp = np.abs(got.numpy() - ref) / np.spacing(np.abs(ref))
        assert ulp[ref != 0].max() <= 2.0
    np.testing.assert_allclose(dm.pow(_t(base), _t(expo)).numpy(),
                               np.power(base, expo), rtol=1e-14, atol=0)
    assert float(dm.sqrt(_t(np.zeros(1)))[0]) == 0.0
    s = rng.normal(size=(7, 54))
    np.testing.assert_allclose(dm.fixed_mean(_t(s)).numpy(), s.mean(axis=1),
                               rtol=1e-14, atol=1e-16)
