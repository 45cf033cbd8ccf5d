"""Shared pieces of the execution models (dense path): spike detection,
synaptic fan-out, the dependency horizon, batched state initialisation and
device-side network arrays.  Counterpart of ``repro.core.exec_common``."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.cell import CellModel
from repro_torch.core.network import Network

SPIKE_THR = -20.0     # mV upward crossing at the soma


class DeviceNet(NamedTuple):
    pre: torch.Tensor      # i64[E]
    post: torch.Tensor     # i64[E]
    delay: torch.Tensor    # f64[E]
    w_ampa: torch.Tensor   # f64[E]
    w_gaba: torch.Tensor   # f64[E]


def to_device(net: Network, device) -> DeviceNet:
    f64 = dict(dtype=torch.float64, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    return DeviceNet(torch.as_tensor(net.pre, **i64),
                     torch.as_tensor(net.post, **i64),
                     torch.as_tensor(net.delay, **f64),
                     torch.as_tensor(net.w_ampa, **f64),
                     torch.as_tensor(net.w_gaba, **f64))


def batch_init(model: CellModel, n: int, v0: float = -65.0):
    y = model.init_state(v0)
    return y[None, :].repeat(n, 1)


def detect_spikes(v_prev, v_new, t_prev, t_new):
    """Upward threshold crossing; spike time by linear interpolation.
    Returns (spiked bool[N], t_spike[N])."""
    crossed = (v_prev <= SPIKE_THR) & (v_new > SPIKE_THR)
    frac = (SPIKE_THR - v_prev) / torch.where(v_new == v_prev, 1.0,
                                              v_new - v_prev)
    t_spike = t_prev + frac * (t_new - t_prev)
    return crossed, torch.where(crossed, t_spike, 0.0)


def fanout_edges(dnet: DeviceNet, spiked, t_spike):
    """Edge-parallel synaptic fan-out of one spike per neuron.
    Returns candidate events (target, t_ev, w_ampa, w_gaba, valid), length E."""
    valid = spiked[dnet.pre]
    t_ev = t_spike[dnet.pre] + dnet.delay
    return dnet.post, t_ev, dnet.w_ampa, dnet.w_gaba, valid


def horizon_times(dnet: DeviceNet, n: int, t_clock, t_end, *,
                  horizon_cap=None):
    """FAP dependency horizon: t_max[i] = min over in-edges (t[pre]+delay),
    a scatter-min over the static edge list.  Neurons without in-edges get
    t_end."""
    cand = t_clock[dnet.pre] + dnet.delay
    hor = torch.full((n,), t_end, dtype=t_clock.dtype, device=t_clock.device)
    hor = hor.scatter_reduce(0, dnet.post, cand, "amin", include_self=True)
    hor = torch.clamp(hor, max=t_end)
    if horizon_cap is not None:
        hor = torch.minimum(hor, t_clock + horizon_cap)
    return hor


def runnable_mask(t_clock, horizon, eps: float = 1e-12):
    """A neuron is runnable when strictly behind its dependency horizon."""
    return t_clock < horizon - eps


class SchedStats(NamedTuple):
    """Per-run active-set telemetry accumulated over scheduler rounds:
    runnable frontier offered, lanes that advanced, lanes dispatched and
    rounds (see ``repro.core.exec_common.SchedStats``)."""
    runnable: torch.Tensor      # i64[]
    stepped: torch.Tensor       # i64[]
    lanes: torch.Tensor         # i64[]
    rounds: torch.Tensor        # i32[]

    @staticmethod
    def zeros(device) -> "SchedStats":
        z64 = torch.zeros((), dtype=torch.int64, device=device)
        return SchedStats(z64, z64, z64,
                          torch.zeros((), dtype=torch.int32, device=device))


def sched_metrics(stats: SchedStats) -> dict:
    """Host-side summary of ``SchedStats`` (floats, safe for zero rounds)."""
    lanes = max(1, int(stats.lanes))
    return {
        "rounds": int(stats.rounds),
        "runnable_per_round": float(stats.runnable) / max(1, int(stats.rounds)),
        "occupancy": float(stats.stepped) / lanes,
        "wasted_lane_frac": 1.0 - float(stats.stepped) / lanes,
    }


def solver_stats(sts) -> dict:
    """Summed per-lane BDF counters for ``RunResult.solver``."""
    return {"nst": sts.nst.sum(), "nni": sts.nni.sum(),
            "nfe": sts.nfe.sum(), "nsetups": sts.nsetups.sum(),
            "netf": sts.netf.sum(), "nncf": sts.nncf.sum(),
            "nreset": sts.nreset.sum()}


def make_spike_insert(net, dnet: DeviceNet, qops, qinsert,
                      fanout: str = "dense", spike_cap: int = 256):
    """The fan-out + insert stage: ``fn(eq, spiked[N], t_spike[N]) -> eq``.
    Only ``fanout="dense"`` (all E edges + the net's best insert) is
    ported."""
    if fanout == "compact":
        raise NotImplementedError(
            "fanout='compact' (kernel K7) comes in a later slice of the port "
            "(ROADMAP queue 1, item 7)")
    if fanout != "dense":
        raise ValueError(f"unknown fanout mode {fanout!r}")

    def dense_ins(eq, spiked, t_sp):
        tgt, t_ev, wa, wg, valid = fanout_edges(dnet, spiked, t_sp)
        return qinsert(eq, tgt, t_ev, wa, wg, valid)

    return dense_ins
