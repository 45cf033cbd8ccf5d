"""The port's examples (``python -m repro_torch.examples.<name>``) run end
to end on the CPU at a small size, and the lab experiment's own copy of
the regime mix gives the JAX package's currents exactly."""
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.examples import lab_experiment, quickstart, serve_decode

ROOT = Path(__file__).resolve().parents[1]


def test_quickstart_runs_on_cpu(capsys):
    st = quickstart.main(["--device", "cpu", "--t", "10"])
    out = capsys.readouterr().out
    assert "13 compartments, 56 ODE states" in out
    assert "correlated plasticity pair" in out
    assert "fixed dt=25us     :    400 steps" in out
    assert "order reset to q=1" in out
    assert not bool(st.failed[0]) and int(st.nst[0]) < 400
    rho = float(st.zn[0, 0, -1])
    assert 0.0 <= rho <= 1.0


def test_lab_experiment_runs_on_cpu(capsys):
    r2a, r2c, reg = lab_experiment.main(["--device", "cpu", "--n", "16",
                                         "--t", "6"])
    out = capsys.readouterr().out
    assert "2a  BSP fixed implicit" in out and "EG-full" in out
    assert int(r2a.n_steps) == 16 * 240
    for r in (r2a, r2c, reg):
        assert int(r.dropped) == 0 and not bool(r.failed)
    assert int(reg.n_resets) <= int(r2c.n_resets)


def test_serve_decode_serves_reduced_qwen3_moe_on_cpu(capsys):
    """``examples/serve_decode.py``'s run: 8 requests of reduced
    qwen3-moe-30b-a3b through 4 slots, 16 new tokens each."""
    assert serve_decode.main(["--device", "cpu"]) == 0
    assert "served 8 requests, 128 tokens" in capsys.readouterr().out


def test_regime_currents_equal_the_benchmarks_copy():
    pytest.importorskip("jax")
    sys.path.insert(0, str(ROOT))
    from benchmarks.common import calibration, regime_iinj
    cal = calibration("soma")
    assert {k: cal[k] for k in lab_experiment.SOMA_CAL} == \
        lab_experiment.SOMA_CAL
    for i, name in enumerate(lab_experiment.PCTS):
        assert np.array_equal(lab_experiment.regime_iinj(9, name, seed=i),
                              regime_iinj(9, name, seed=i))
