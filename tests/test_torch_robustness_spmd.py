"""Preemption tolerance of the port's SPMD runner (``run_fap_spmd``) on four
gloo ranks on the CPU (``distributed.group.launch``), the cases of
``tests/test_robustness_spmd.py`` (soma, N = 16, k_in 4, seed 3, 6 ms):

* a run checkpointed every 5 rounds, killed at ~60 % of its rounds by a
  ``SimulatedFailure`` and resumed is bitwise the uninterrupted run
  (spike trains, steps, final states, parcel peaks), on a uniform and a
  block net, with the dense queue and the wheel, and for the global round
  (``optimized=False``);
* a resume on two ranks of a four-rank checkpoint (the incremental
  horizon, whose carry depends on the layout) reseeds that carry, reports
  ``elastic_reseeded`` and is bitwise the four-rank run; a four-rank
  resume restores it and does not reseed;
* a poisoned lane is detected, rolled back and reported in ``health``,
  and the run is bitwise the clean one;
* parcel drops (a parcel cap of 1) reach ``health["dropped_events"]``;
* a resume under another placement is refused.
"""
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.distributed import group as grp

N, K_IN, SEED, T_END = 16, 4, 3, 6.0
EVERY = 5
SPARSE = dict(transport="sparse", parcel_cap=8)
CONFIGS = {
    "uniform/dense": (False, dict(SPARSE)),
    "uniform/wheel": (False, dict(SPARSE, queue="wheel")),
    "block/dense": (True, dict(SPARSE)),
    "block/wheel": (True, dict(SPARSE, queue="wheel")),
    # the per-rank cap covers a shard on 2 and on 4 ranks, so the run does
    # not depend on the number of ranks
    "elastic": (False, dict(SPARSE, batch="compact", batch_cap=8,
                            horizon="incremental")),
    # the paper-faithful global round (its parcel cap goes unused)
    "global": (False, dict(SPARSE, transport="allgather", optimized=False)),
}


def _inputs(block, hot=False):
    from repro_torch.core import network
    from repro_torch.core.topology import TopologyConfig
    topo = TopologyConfig("block", n_blocks=4, p_in=0.95) if block \
        else "uniform"
    net = network.make_network(N, k_in=K_IN, seed=SEED, topology=topo)
    iinj = (0.20 if hot else 0.16) + \
        0.004 * np.random.default_rng(1).standard_normal(N)
    return net, iinj


def _knobs(kw):
    from repro_torch.distributed.exchange import ExchangeSpec
    kw = dict(kw)
    kw["exchange"] = ExchangeSpec(parcel_cap=kw.pop("parcel_cap"))
    if kw.get("queue") == "wheel":
        from repro_torch.sched import WheelSpec
        kw["wheel"] = WheelSpec.auto(_inputs(False)[0])
    return kw


def _summary(res, rounds):
    return {"times": res.rec.times, "count": res.rec.count,
            "y": res.y_final, "n_steps": int(res.n_steps),
            "dropped": int(res.dropped), "failed": bool(res.failed),
            "rounds": rounds, "peak": res.comm["parcel_peak"],
            "health": res.health}


def _ranks(group, root):
    """Every four-rank run of the module: baselines, kills, resumes, the
    poisoned run and the overflow run."""
    from repro_torch.checkpoint import FaultPlan, SimulatedFailure
    from repro_torch.core import morphology
    from repro_torch.core.cell import CellModel
    from repro_torch.distributed.fap_spmd import run_fap_spmd
    model = CellModel(morphology.soma_only(), device="cpu")

    def run(block, kw, **more):
        net, iinj = _inputs(block, more.pop("hot", False))
        return run_fap_spmd(model, net, iinj, T_END, group, max_rounds=80,
                            **_knobs(kw), **more)

    out = {}
    for tag, (block, kw) in CONFIGS.items():
        base, r0 = run(block, kw)
        d = f"{root}/{tag.replace('/', '_')}"
        kill = max(2, int(r0 * 0.6))
        try:
            run(block, kw, checkpoint_every=EVERY, ckpt_dir=d,
                fault=FaultPlan(fail_at_round=kill))
            killed = None
        except SimulatedFailure as e:
            killed = e.step
        res, r1 = run(block, kw, ckpt_dir=d, resume=True)
        out[tag] = {"base": _summary(base, r0), "resumed": _summary(res, r1),
                    "killed": killed, "kill": kill, "dir": d}
    base, _ = run(False, SPARSE)
    res, rounds = run(False, SPARSE, checkpoint_every=EVERY,
                      ckpt_dir=f"{root}/poison",
                      fault=FaultPlan(poison_at_round=12, poison_lane=5))
    out["poison"] = _summary(res, rounds)
    res, rounds = run(False, dict(transport="sparse", parcel_cap=1),
                      hot=True)
    out["overflow"] = _summary(res, rounds)
    try:
        run(False, SPARSE, ckpt_dir=out["uniform/dense"]["dir"],
            resume=True, placement="greedy")
        out["placement_refused"] = False
    except ValueError as e:
        out["placement_refused"] = "placement" in str(e)
    return out


def _resume_elastic(group, d):
    """The elastic config resumed from the four-rank checkpoints."""
    from repro_torch.core import morphology
    from repro_torch.core.cell import CellModel
    from repro_torch.distributed.fap_spmd import run_fap_spmd
    model = CellModel(morphology.soma_only(), device="cpu")
    net, iinj = _inputs(False)
    res, rounds = run_fap_spmd(model, net, iinj, T_END, group, max_rounds=80,
                               ckpt_dir=d, resume=True,
                               **_knobs(CONFIGS["elastic"][1]))
    return _summary(res, rounds)


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as root:
        out = grp.launch(4, _ranks, root, backend="gloo", device="cpu")
        out["elastic/2"] = grp.launch(2, _resume_elastic,
                                      out["elastic"]["dir"], backend="gloo",
                                      device="cpu")
    return out


def _identical(a, b):
    return (torch.equal(a["times"], b["times"])
            and torch.equal(a["count"], b["count"])
            and torch.equal(a["y"], b["y"]) and a["n_steps"] == b["n_steps"]
            and a["rounds"] == b["rounds"] and a["peak"] == b["peak"])


@pytest.mark.parametrize("tag", list(CONFIGS))
def test_kill_resume_bitwise(runs, tag):
    r = runs[tag]
    base, res = r["base"], r["resumed"]
    assert int(base["count"].sum()) > 0
    assert r["killed"] == r["kill"]
    assert _identical(base, res)
    assert res["dropped"] == 0 and not res["failed"]
    assert res["health"]["resumed_from"] == (r["kill"] // EVERY) * EVERY > 0
    assert not res["health"]["elastic_reseeded"]


@pytest.mark.parametrize("tag", list(CONFIGS))
def test_watchdog_ran_every_round(runs, tag):
    h = runs[tag]["resumed"]["health"]
    assert h["checks"] == runs[tag]["resumed"]["rounds"] - h["resumed_from"]
    assert h["straggler"]["recorded"] == h["checks"]


def test_elastic_resume_on_two_ranks(runs):
    r = runs["elastic/2"]
    assert r["health"]["elastic_reseeded"]
    assert r["health"]["resumed_from"] > 0
    assert r["dropped"] == 0 and not r["failed"]
    assert _identical(runs["elastic"]["base"], r)


def test_poisoned_lane_rolled_back(runs):
    p = runs["poison"]
    assert p["health"]["nonfinite_rounds"] == 1
    assert p["health"]["rollbacks"] == 1
    assert not p["health"]["rollback_exhausted"] and not p["failed"]
    assert _identical(runs["uniform/dense"]["base"], p)


def test_parcel_drops_escalate_to_health(runs):
    o = runs["overflow"]
    assert o["dropped"] > 0
    assert o["health"]["dropped_events"] == o["dropped"]


def test_resume_under_another_placement_refused(runs):
    assert runs["placement_refused"]
