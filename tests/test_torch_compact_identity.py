"""The port's active-set path against its own dense path, on the CPU
(no JAX): ``batch="compact"`` with ``fanout="compact"`` equals the dense
round event for event on all five topologies x both queues (the N, K and
T_END of ``tests/test_active_set.py``), the sort-free knob stack
(compact x wheel x fused x threshold, auto caps) equals its dense twin,
and a binding cap rolls work to later rounds without dropping anything.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch import sched as tsched
from repro_torch.core import exec_common as xc
from repro_torch.core import exec_fap as tfap
from repro_torch.core import morphology as tmorph
from repro_torch.core import network as tnet
from repro_torch.core.cell import CellModel as TCell
from repro_torch.core.topology import TOPOLOGIES
from repro_torch.core.topology import TopologyConfig as TTopo

N, K, T_END = 16, 4, 8.0       # square N: grid2d needs one
TOPO_KW = {"uniform": None, "block": dict(n_blocks=4, p_in=0.9),
           "ring": dict(sigma=3.0), "grid2d": dict(n_blocks=4, sigma=2.0),
           "smallworld": dict(p_rewire=0.1)}
IINJ = 0.16 + 0.004 * np.random.default_rng(1).standard_normal(N)


@functools.lru_cache(maxsize=None)
def _tnet(topo="uniform"):
    kw = TOPO_KW[topo]
    return tnet.make_network(N, k_in=K, seed=3,
                             topology=topo if kw is None else TTopo(topo, **kw))


@functools.lru_cache(maxsize=None)
def _tmodel():
    return TCell(tmorph.soma_only(), device="cpu")


def _trun(net, t_end=T_END, iinj=IINJ, **kw):
    return tfap.make_fap_vardt_runner(_tmodel(), net, iinj, t_end,
                                      device="cpu", **kw)()


@functools.lru_cache(maxsize=None)
def _dense(topo, queue):
    return _trun(_tnet(topo), queue=queue,
                 wheel=tsched.WheelSpec.auto(_tnet(topo)))


def _exact_same(a, b):
    assert torch.equal(a.rec.times, b.rec.times)
    assert torch.equal(a.rec.count, b.rec.count)
    assert torch.equal(a.y_final, b.y_final)
    assert int(a.n_events) == int(b.n_events)
    assert int(a.n_steps) == int(b.n_steps)
    assert int(a.dropped) == int(b.dropped) == 0
    assert not bool(a.failed) and not bool(b.failed)


def _trains(res):
    ts, c = res.rec.times.numpy(), res.rec.count.numpy()
    return [np.sort(ts[i][: c[i]]) for i in range(len(c))]


@pytest.mark.parametrize("topo", sorted(TOPO_KW))
@pytest.mark.parametrize("queue", ["dense", "wheel"])
def test_compact_equals_dense_in_port(topo, queue):
    assert set(TOPO_KW) == set(TOPOLOGIES)
    r_d, rounds_d = _dense(topo, queue)
    run = tfap.make_fap_vardt_runner(
        _tmodel(), _tnet(topo), IINJ, T_END, queue=queue,
        wheel=tsched.WheelSpec.auto(_tnet(topo)), batch="compact",
        fanout="compact", device="cpu")
    assert run.incremental and run.batch_cap == run.spike_cap == N
    r_c, rounds_c = run()
    assert int(r_d.rec.count.sum()) > 0
    _exact_same(r_d, r_c)
    assert rounds_d == rounds_c
    assert int(r_c.sched.lanes) == N * rounds_c


def test_compact_overflow_rolls_not_drops():
    """A batch cap far below the frontier: each round advances only the
    earliest lanes, the rest roll; nothing drops and the physics stays
    within the scheduler-restriction tolerance of JAX's test."""
    r_d, rounds_d = _dense("uniform", "dense")
    r_c, rounds_c = _trun(_tnet(), batch="compact", batch_cap=4)
    assert int(r_c.dropped) == 0 and int(r_c.rec.overflow) == 0
    assert not bool(r_c.failed)
    assert rounds_c > rounds_d
    td, tc = _trains(r_d), _trains(r_c)
    assert sum(len(a) != len(b) for a, b in zip(td, tc)) <= 1
    for a, b in zip(td, tc):
        if len(a) == len(b) and len(a):
            assert np.abs(a - b).max() < 0.25
    m = xc.sched_metrics(r_c.sched)
    assert m["occupancy"] > 0.9
    assert int(r_c.sched.lanes) == 4 * rounds_c
    assert int(r_c.sched.stepped) <= int(r_c.sched.lanes)


def test_compact_stack_equals_dense_twin():
    """compact x wheel x fused horizon x threshold k_select, both caps
    "auto": the tentpole's knob stack equals its dense twin."""
    net = _tnet()
    kw = dict(queue="wheel", wheel=tsched.WheelSpec.auto(net),
              horizon_impl="fused", select="threshold", k_select=12)
    r_d, _ = _trun(net, **kw)
    run = tfap.make_fap_vardt_runner(
        _tmodel(), net, IINJ, T_END, batch="compact", batch_cap="auto",
        fanout="compact", spike_cap="auto", probe_t=2.0, device="cpu", **kw)
    assert not run.incremental
    r_c, _ = run()
    _exact_same(r_d, r_c)
