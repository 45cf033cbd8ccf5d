"""The port's checkpoints and fault-tolerance objects
(``repro_torch.checkpoint``), the cases of ``tests/test_checkpoint.py``:
roundtrip, atomicity, integrity (bytes and crc32), the tree-structure
check, stray entries, ``gc_incomplete``, pruning, ``RestartManager``
after a ``SimulatedFailure`` and the bounded memory of
``StragglerMonitor``; plus the leaf kinds a restore hands back, and the
verdicts of ``StragglerMonitor``, ``ExponentialBackoff`` and ``FaultPlan``
held to live JAX objects on the same inputs.
"""
import json
import math
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (ExponentialBackoff, FaultPlan,
                                    RestartManager, SimulatedFailure,
                                    StragglerMonitor, gc_incomplete,
                                    latest_step, latest_tenant_step,
                                    list_tenants, prune_checkpoints,
                                    restore_checkpoint,
                                    restore_tenant_checkpoint,
                                    save_checkpoint, save_tenant_checkpoint)


class Pair(NamedTuple):
    x: object
    y: object


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g, dtype=torch.float64),
            "b": {"c": torch.arange(5, dtype=torch.int32)},
            "p": Pair(torch.tensor(True), 7)}


def _leaves_equal(a, b):
    import torch.utils._pytree as pt
    la, ta = pt.tree_flatten(a)
    lb, tb = pt.tree_flatten(b)
    assert str(ta) == str(tb)
    for x, y in zip(la, lb):
        assert type(x) is type(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x, y)
        else:
            assert x == y


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 3, t, extras={"note": "x"})
    assert latest_step(str(tmp_path)) == 3
    t2, extras = restore_checkpoint(str(tmp_path), 3, t)
    _leaves_equal(t, t2)
    assert extras == {"note": "x"}


def test_restore_takes_the_like_leaf_kind(tmp_path):
    """A leaf comes back as its like leaf's kind: a 0-d tensor stays 0-d
    in the like's dtype, a Python int an int, a float a float, a numpy
    array an array of the like's dtype."""
    t = {"s": torch.tensor(5, dtype=torch.int64), "i": 3, "f": 0.25,
         "b": False, "n": np.arange(3, dtype=np.int16)}
    save_checkpoint(str(tmp_path), 1, t)
    like = {"s": torch.zeros((), dtype=torch.int32), "i": 0, "f": 0.0,
            "b": True, "n": np.zeros(3, np.int64)}
    got, _ = restore_checkpoint(str(tmp_path), 1, like)
    assert got["s"].shape == () and got["s"].dtype == torch.int32
    assert int(got["s"]) == 5
    assert type(got["i"]) is int and got["i"] == 3
    assert type(got["f"]) is float and got["f"] == 0.25
    assert type(got["b"]) is bool and got["b"] is False
    assert got["n"].dtype == np.int64 and got["n"].tolist() == [0, 1, 2]


def test_atomicity_incomplete_ignored(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    os.makedirs(tmp_path / "step_00000002.tmp")    # a crashed save
    os.makedirs(tmp_path / "step_00000003")        # no manifest
    assert latest_step(str(tmp_path)) == 1


def test_integrity_bytes(tmp_path):
    t = _tree()
    path = save_checkpoint(str(tmp_path), 1, t)
    mpath = os.path.join(path, "manifest.json")
    m = json.load(open(mpath))
    m["entries"][0]["bytes"] += 1
    json.dump(m, open(mpath, "w"))
    with pytest.raises(IOError):
        restore_checkpoint(str(tmp_path), 1, t)


def test_crc32_corruption_detected(tmp_path):
    """A size-preserving change to a leaf file fails the restore."""
    t = _tree()
    path = save_checkpoint(str(tmp_path), 1, t)
    m = json.load(open(os.path.join(path, "manifest.json")))
    fname = os.path.join(path, m["entries"][0]["file"])
    arr = np.load(fname)
    arr.flat[0] += 1.0
    np.save(fname, arr)
    with pytest.raises(IOError, match="crc32"):
        restore_checkpoint(str(tmp_path), 1, t)


def test_treedef_mismatch_detected(tmp_path):
    """The same leaf count in another structure is refused."""
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    other = {"a": t["a"], "z": {"q": t["b"]["c"]}, "p": Pair(t["p"].x, 0)}
    with pytest.raises(ValueError, match="structure"):
        restore_checkpoint(str(tmp_path), 1, other)
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path), 1, {"a": t["a"]})


def test_shape_change_refused(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    like = dict(t, a=torch.zeros((2, 8), dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), 1, like)


def test_prune(tmp_path):
    t = _tree()
    for s in [1, 2, 3, 4, 5]:
        save_checkpoint(str(tmp_path), s, t)
    prune_checkpoints(str(tmp_path), keep=2)
    assert latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path)) == ["step_00000004",
                                            "step_00000005"]


def test_stray_entries_tolerated(tmp_path):
    t = _tree()
    for s in [1, 2, 3]:
        save_checkpoint(str(tmp_path), s, t)
    os.makedirs(tmp_path / "step_old")
    (tmp_path / "notes.txt").write_text("scratch")
    os.makedirs(tmp_path / "step_00000002.tmp")
    assert latest_step(str(tmp_path)) == 3
    prune_checkpoints(str(tmp_path), keep=1)
    assert latest_step(str(tmp_path)) == 3
    assert (tmp_path / "step_old").exists()
    assert (tmp_path / "notes.txt").exists()
    assert not (tmp_path / "step_00000002.tmp").exists()
    assert not (tmp_path / "step_00000002").exists()


def test_gc_incomplete(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    os.makedirs(tmp_path / "step_00000005.tmp")
    assert gc_incomplete(str(tmp_path)) == ["step_00000005.tmp"]
    assert latest_step(str(tmp_path)) == 1
    assert gc_incomplete(str(tmp_path / "missing")) == []


def test_tenant_directories(tmp_path):
    t = _tree()
    for rid, step in ((3, 5), (3, 10), (7, 5)):
        save_tenant_checkpoint(str(tmp_path), rid, step, t,
                               extras={"rid": rid})
    os.makedirs(tmp_path / "tenant_000009")          # nothing complete
    assert list_tenants(str(tmp_path)) == [3, 7]
    assert latest_tenant_step(str(tmp_path), 3) == 10
    got, extras = restore_tenant_checkpoint(str(tmp_path), 7, 5, t)
    assert extras == {"rid": 7, "tenant": 7}
    _leaves_equal(t, got)


def _toy_training(ckpt_dir, n_steps, inject_at=None):
    """A deterministic training loop on a tensor state: each step adds
    its index to ``w`` and counts."""
    mgr = RestartManager(ckpt_dir, save_every=5)

    def init_fn():
        return {"w": torch.zeros(3, dtype=torch.float64), "k": 0}

    state, extras, start = mgr.resume_or_init(init_fn)

    def step_fn(state, step):
        w = state["w"] + step * torch.tensor([1.0, 0.5, 0.25],
                                             dtype=torch.float64)
        return {"w": w, "k": state["k"] + 1}, {"loss": 1.0 / (step + 1)}

    return mgr.run(state, start, n_steps, step_fn,
                   data_state_fn=lambda: {"cursor": 0},
                   inject_failure_at=inject_at, log_every=0,
                   log_fn=lambda *a: None)


def test_restart_after_simulated_failure(tmp_path):
    with pytest.raises(SimulatedFailure):
        _toy_training(str(tmp_path), 20, inject_at=12)
    assert latest_step(str(tmp_path)) == 10          # last periodic save
    state, history = _toy_training(str(tmp_path), 20)
    assert history[0]["step"] == 10 and history[-1]["step"] == 19
    assert latest_step(str(tmp_path)) == 20
    ref, _ = _toy_training(str(tmp_path / "fresh"), 20)
    assert torch.equal(state["w"], ref["w"]) and state["k"] == ref["k"] == 20
    assert type(state["k"]) is int


def test_nan_quarantine(tmp_path):
    mgr = RestartManager(str(tmp_path), save_every=2, max_nan_retries=3)
    state0 = {"x": torch.zeros(3)}
    save_checkpoint(str(tmp_path), 0, state0)

    def step_fn(state, step):
        loss = float("nan") if step == 3 else 1.0 / (step + 1)
        return state, {"loss": torch.tensor(loss)}

    _, history = mgr.run(state0, 0, 6, step_fn, log_every=0,
                         log_fn=lambda *a: None)
    steps = [h["step"] for h in history]
    assert 3 not in steps and 5 in steps


def test_straggler_monitor_bounded_memory():
    mon = StragglerMonitor(window=16)
    for _ in range(10_000):
        mon.record(0.01)
    assert len(mon.times) == 16 and mon.recorded == 10_000
    assert mon.record(1.0)
    s = mon.stats()
    assert s["flagged"] == 1 and s["recorded"] == 10_001
    assert s["window_max_s"] == 1.0
    assert abs(s["window_median_s"] - 0.01) < 1e-12


def test_exponential_backoff_policy():
    bo = ExponentialBackoff(base=2, factor=2.0, cap=16, max_retries=4)
    assert [bo.delay(a) for a in range(1, 5)] == [2, 4, 8, 16]
    assert bo.budget() == 30
    assert ExponentialBackoff(cap=5).delay(10) == 5
    with pytest.raises(ValueError):
        bo.delay(0)


# --- against live JAX ------------------------------------------------------

def _series(seed):
    """Step times with quiet stretches, spikes and a regime change."""
    rng = np.random.default_rng(seed)
    t = 0.01 * (1.0 + 0.1 * rng.random(120))
    t[rng.integers(0, 120, 9)] *= 40.0
    t[80:] *= 3.0
    return [float(x) for x in t]


@pytest.mark.parametrize("window,threshold,seed", [(32, 2.5, 0), (8, 1.5, 1),
                                                   (16, 4.0, 2)])
def test_straggler_verdicts_match_jax(window, threshold, seed):
    jft = pytest.importorskip("repro.checkpoint.fault_tolerance")
    mine = StragglerMonitor(window=window, threshold=threshold)
    ref = jft.StragglerMonitor(window=window, threshold=threshold)
    for dt in _series(seed):
        assert mine.record(dt) == ref.record(dt)
        for frac, min_steps in ((0.25, 8), (0.1, 4), (0.5, 16)):
            assert mine.sustained(frac, min_steps) == \
                ref.sustained(frac, min_steps)
        assert mine.stats() == ref.stats()


@pytest.mark.parametrize("base,factor,cap,retries", [(2, 2.0, 32, 3),
                                                     (1, 3.0, 20, 6),
                                                     (5, 1.5, 7, 4)])
def test_backoff_matches_jax(base, factor, cap, retries):
    jft = pytest.importorskip("repro.checkpoint.fault_tolerance")
    mine = ExponentialBackoff(base, factor, cap, retries)
    ref = jft.ExponentialBackoff(base, factor, cap, retries)
    assert [mine.delay(a) for a in range(1, 12)] == \
        [ref.delay(a) for a in range(1, 12)]
    assert mine.budget() == ref.budget()


def test_fault_plan_matches_jax():
    jft = pytest.importorskip("repro.checkpoint.fault_tolerance")
    import dataclasses
    names = [f.name for f in dataclasses.fields(FaultPlan)]
    assert names == [f.name for f in dataclasses.fields(jft.FaultPlan)]
    mine, ref = FaultPlan(), jft.FaultPlan()
    for k in names:
        a, b = getattr(mine, k), getattr(ref, k)
        assert (a == b) or (isinstance(a, float) and math.isnan(a)
                            and math.isnan(b)), k
    kw = dict(fail_at_round=4, poison_at_round=2, poison_lane=3,
              poison_value=float("inf"), poison_tenant=1)
    assert dataclasses.asdict(FaultPlan(**kw)) == \
        dataclasses.asdict(jft.FaultPlan(**kw))
    e = SimulatedFailure(7)
    assert str(e) == str(jft.SimulatedFailure(7)) and e.step == 7
