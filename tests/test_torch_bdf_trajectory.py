"""Parity of the port's longer BDF trajectories, its dense-Jacobian oracle
and ``repro_torch.interop``'s conversions against the JAX package, on the
CPU."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)

from repro.core import bdf as jbdf  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import morphology as jmorph  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.core.cell import CellModel as JCell  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import bdf as tbdf  # noqa: E402
from repro_torch.core import morphology as tmorph  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core.cell import CellModel as TCell  # noqa: E402

from test_torch_cell_bdf import _assert_state_equal, _close, _states, _t  # noqa: E402,E501


@pytest.fixture(scope="module")
def models():
    return {name: (JCell(jmorph.by_name(name)),
                   TCell(tmorph.by_name(name), device="cpu"))
            for name in ("soma", "ball_and_stick")}


def test_interop_roundtrip_single_neuron(models):
    jm, tm = models["soma"]
    st = jbdf.reinit(jm, 0.0, jm.init_state(), 0.1, jbdf.BDFOptions())
    tst = interop.bdf_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, st), "cpu")
    assert tst.t.shape == (1,) and tst.zn.shape == (1, jbdf.LMAX, jm.n_state)
    back = interop.bdf_state_to_numpy(tst)
    again = jbdf.BDFState(**{k: jnp.asarray(v[0]) for k, v in back.items()})
    for a, b in zip(jax.tree_util.tree_leaves(st),
                    jax.tree_util.tree_leaves(again)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    p = interop.cell_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    for a, b in zip(p, tm.params):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["soma", "ball_and_stick"])
def test_dense_jacobian_oracle_vs_jax(models, name):
    jm, tm = models[name]
    y = _states(jm.C, 1, seed=7)[0]
    _close(tm.dense_jacobian(0.0, _t(y), 0.1),
           jm.dense_jacobian(0.0, jnp.asarray(y), 0.1), rtol=1e-10)


def test_advance_to_vs_jax(models):
    """Single-neuron trajectories to 1 ms: every counter exact; floats
    within 1e-8 relative, 1e-12 absolute (last bits accumulate over ~40
    steps, and the corrections ``acor`` are small differences)."""
    jm, tm = models["ball_and_stick"]
    opts_j, opts_t = jbdf.BDFOptions(), tbdf.BDFOptions()
    N = 4
    iinj = np.linspace(0.1, 0.4, N)
    Y0 = np.tile(np.asarray(jm.init_state()), (N, 1))
    jst = jax.vmap(lambda y, i: jbdf.reinit(jm, 0.0, y, i, opts_j))(Y0, iinj)
    j_out = jax.jit(jax.vmap(lambda s, i: jbdf.advance_to(
        jm, s, 1.0, i, opts_j)))(jst, iinj)
    tst = tbdf.reinit(tm, 0.0, _t(Y0), _t(iinj), opts_t)
    _assert_state_equal(tbdf.advance_to(tm, tst, 1.0, _t(iinj), opts_t),
                        j_out, rtol=1e-8, atol=1e-12)


def test_interop_roundtrips():
    jn = jnet.make_network(24, k_in=3, seed=2, topology="block")
    tn = interop.network_from_numpy(jn)
    ref = tnet.make_network(24, k_in=3, seed=2, topology="block")
    for a, b in zip(tn, ref):
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
    rng = np.random.default_rng(0)
    q = jev.EventQueue(jnp.asarray(rng.random((5, 4))),
                       jnp.asarray(rng.random((5, 4))),
                       jnp.asarray(rng.random((5, 4))),
                       jnp.asarray(3, jnp.int32))
    r = jev.SpikeRecord(jnp.asarray(rng.random((5, 2))),
                        jnp.asarray(rng.integers(0, 2, 5), jnp.int32),
                        jnp.asarray(1, jnp.int32))
    for obj, fwd, back, cls in (
            (q, interop.event_queue_from_numpy, interop.event_queue_to_numpy,
             jev.EventQueue),
            (r, interop.spike_record_from_numpy,
             interop.spike_record_to_numpy, jev.SpikeRecord)):
        again = cls(**back(fwd(jax.tree_util.tree_map(np.asarray, obj),
                               "cpu")))
        for a, b in zip(obj, again):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            assert np.array_equal(np.asarray(a), np.asarray(b))
    jm = JCell(jmorph.branched_tree(2, 2))
    p = interop.cell_params_to_numpy(interop.cell_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu"))
    for a, b in zip(jm.params, p.values()):
        assert np.array_equal(np.asarray(a), b)
