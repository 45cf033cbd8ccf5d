"""The port's 2c main path on a detailed cell against a live JAX run, on
the CPU.

``branched_tree(depth=8, seg_per_branch=2)`` is the paper's L5_TTPC2-like
arborisation at a reconstructed cell's size: C = 1021 compartments, depth
16, a state row of 4 C + 2 = 4086.  Four neurons on
``make_network(4, k_in=2, seed=3)``, driven at 8 nA (each spikes once by
0.5 ms; below about 2 nA none does in that time), run with
``horizon_impl="fused"`` to 0.5 ms: per-neuron spike counts, n_events,
n_resets, n_steps and every solver counter equal, spike times within 1e-6
ms, nothing dropped or failed -- the full-parity horizon of
``tests/test_torch_exec_fap.py``.  On the card the same cell takes the
Hines kernels' warp frame (``chip_smoke.py`` phase 33); here their plain
versions run, batched over the tree's depths.  One torch thread: the
C = 1021 rows are small enough that more threads only add overhead.
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

from repro_torch.core import exec_fap as tfap  # noqa: E402
from repro_torch.core import morphology as tmorph  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core.cell import CellModel as TCell  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

N, K_IN, SEED = 4, 2, 3
DEPTH, SEG = 8, 2
I_AMP = 8.0         # nA
T_END = 0.5         # ms
T_TOL = 1e-6        # ms, spike times


@pytest.fixture(scope="module")
def runs():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        iinj = I_AMP * (1.0 + 0.2 * np.random.default_rng(N).random(N))
        jr, _ = jfap.make_fap_vardt_runner(
            JCell(jmorph.branched_tree(depth=DEPTH, seg_per_branch=SEG)),
            jnet.make_network(N, k_in=K_IN, seed=SEED), iinj, T_END,
            horizon_impl="fused")()
        model = TCell(tmorph.branched_tree(depth=DEPTH, seg_per_branch=SEG),
                      device="cpu")
        before = build.launches()
        tr, rounds = tfap.make_fap_vardt_runner(
            model, tnet.make_network(N, k_in=K_IN, seed=SEED), iinj, T_END,
            horizon_impl="fused", device="cpu")()
        launched = build.launches() != before
    finally:
        torch.set_num_threads(threads)
    return jr, tr, rounds, model, launched


def test_detailed_cell_is_detailed(runs):
    _, tr, rounds, model, launched = runs
    assert model.C == 1021 and model.n_state == 4 * 1021 + 2
    assert tuple(tr.y_final.shape) == (N, model.n_state)
    assert rounds > 0 and not launched


def test_detailed_cell_spikes_and_counters_match_live_jax(runs):
    jr, tr, _, _, _ = runs
    jcount = np.asarray(jr.rec.count)
    assert jcount.sum() > 0
    assert np.array_equal(tr.rec.count.numpy(), jcount)
    assert int(tr.n_events) == int(jr.n_events)
    assert int(tr.n_resets) == int(jr.n_resets)
    assert int(tr.dropped) == int(jr.dropped) == 0
    assert bool(tr.failed) == bool(jr.failed) is False
    assert int(tr.n_steps) == int(jr.n_steps)
    for k, v in jr.solver.items():
        assert int(tr.solver[k]) == int(v), k
    jt, tt = np.asarray(jr.rec.times), tr.rec.times.numpy()
    fin = np.isfinite(jt)
    assert np.array_equal(np.isfinite(tt), fin)
    np.testing.assert_allclose(tt[fin], jt[fin], rtol=0, atol=T_TOL)


def test_detailed_cell_final_state_matches_live_jax(runs):
    """The final states within 1e-6 of each voltage's scale: XLA's exp and
    FMA contraction differ from the port's in the last bit, and the
    integrator carries that over the run's steps."""
    jr, tr, _, model, _ = runs
    jy, ty = np.asarray(jr.y_final), tr.y_final.numpy()
    assert np.isfinite(ty).all()
    np.testing.assert_allclose(ty, jy, rtol=1e-6, atol=1e-6)
