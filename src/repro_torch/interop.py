"""Carry state across from the JAX package, as numpy arrays.

Converts the JAX package's ``Network``, ``CellParams``, ``BDFState``
(of either cell, under either preconditioner: the flat factor rows keep
their width, ``n_factors("schur")`` included), ``EventQueue``,
``WheelQueue``, ``SpikeRecord``, the speculative runner's ``SpecStats``,
the incremental horizon of the compact runner's carry, a whole
round-boundary ``SimCarry`` and the tenant-batched round carry of the
service -- handed over as NamedTuples (or any object with those fields)
of numpy arrays -- into the port's tensors, and
the port's back into dicts of numpy arrays that rebuild the JAX
NamedTuples with ``Cls(**d)``.  ``lm_params_from_numpy`` carries an LM's
parameter tree across.  Nothing here imports the JAX package: the
caller does the ``np.asarray`` on its side.

The JAX ``BDFState`` of a vmapped network already carries the leading
neuron axis the port uses; a single neuron's state (scalar ``t``) gains a
lane axis of one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bdf import BDFState
from repro_torch.core.cell import CellParams
from repro_torch.core.events import EventQueue, SpikeRecord
from repro_torch.core.exec_common import SchedStats, SimCarry
from repro_torch.core.exec_speculative import SpecStats
from repro_torch.core.network import Network
from repro_torch.sched.wheel import WheelQueue

_INT = (np.int8, np.int16, np.int32, np.int64, np.uint8)


def _fields(obj, names):
    if hasattr(obj, "_asdict"):
        d = obj._asdict()
        return {k: d[k] for k in names}
    if isinstance(obj, dict):
        return {k: obj[k] for k in names}
    return {k: getattr(obj, k) for k in names}


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.as_tensor(a.copy(), dtype=torch.bool, device=device)
    if a.dtype.type in _INT:
        return torch.as_tensor(a.astype(np.int32), device=device)
    return torch.as_tensor(a.astype(np.float64), device=device)


def _numpy(t):
    return t.detach().cpu().numpy()


def network_from_numpy(net) -> Network:
    """A JAX ``repro.core.network.Network`` -> the port's ``Network``."""
    f = _fields(net, Network._fields)
    block = f["block"]
    return Network(n=int(f["n"]), pre=np.asarray(f["pre"], np.int32),
                   post=np.asarray(f["post"], np.int32),
                   delay=np.asarray(f["delay"], np.float64),
                   w_ampa=np.asarray(f["w_ampa"], np.float64),
                   w_gaba=np.asarray(f["w_gaba"], np.float64),
                   min_delay=float(f["min_delay"]),
                   block=None if block is None else np.asarray(block, np.int32))


def cell_params_from_numpy(p, device) -> CellParams:
    f = _fields(p, CellParams._fields)
    return CellParams(**{k: _tensor(v, device) for k, v in f.items()})


def cell_params_to_numpy(p) -> dict:
    return {k: _numpy(v) for k, v in p._asdict().items()}


def bdf_state_from_numpy(st, device) -> BDFState:
    """A (vmapped) JAX ``BDFState`` of numpy arrays -> the port's state;
    ``factors`` keeps its row width (``model.n_factors(precond)``)."""
    f = {k: _tensor(v, device) for k, v in _fields(st, BDFState._fields).items()}
    if f["t"].dim() == 0:                  # one neuron: add the lane axis
        f = {k: v[None] for k, v in f.items()}
    return BDFState(**f)


def bdf_state_to_numpy(st: BDFState) -> dict:
    return {k: _numpy(v) for k, v in st._asdict().items()}


def event_queue_from_numpy(eq, device) -> EventQueue:
    f = _fields(eq, EventQueue._fields)
    return EventQueue(**{k: _tensor(v, device) for k, v in f.items()})


def event_queue_to_numpy(eq: EventQueue) -> dict:
    return {k: _numpy(v) for k, v in eq._asdict().items()}


def wheel_queue_from_numpy(eq, device) -> WheelQueue:
    f = _fields(eq, WheelQueue._fields)
    return WheelQueue(**{k: _tensor(v, device) for k, v in f.items()})


def wheel_queue_to_numpy(eq: WheelQueue) -> dict:
    return {k: _numpy(v) for k, v in eq._asdict().items()}


def horizon_from_numpy(horizon, device) -> torch.Tensor:
    """The incremental horizon f64[N] the compact runner carries (round
    carry slot 3 when ``run.incremental``)."""
    return _tensor(np.asarray(horizon, np.float64), device)


def horizon_to_numpy(horizon) -> np.ndarray:
    return _numpy(horizon)


def spike_record_from_numpy(rec, device) -> SpikeRecord:
    f = _fields(rec, SpikeRecord._fields)
    return SpikeRecord(**{k: _tensor(v, device) for k, v in f.items()})


def spike_record_to_numpy(rec: SpikeRecord) -> dict:
    return {k: _numpy(v) for k, v in rec._asdict().items()}


def spec_stats_from_numpy(stats, device) -> SpecStats:
    f = _fields(stats, SpecStats._fields)
    return SpecStats(**{k: _tensor(v, device) for k, v in f.items()})


def spec_stats_to_numpy(stats: SpecStats) -> dict:
    return {k: _numpy(v) for k, v in stats._asdict().items()}


def sched_stats_from_numpy(stats, device) -> SchedStats:
    """``SchedStats`` (runnable, stepped, lanes i64; rounds i32)."""
    f = _fields(stats, SchedStats._fields)
    return SchedStats(*[torch.as_tensor(np.asarray(f[k]).astype(dt),
                                        device=device)
                        for k, dt in zip(SchedStats._fields,
                                         (np.int64,) * 3 + (np.int32,))])


def sched_stats_to_numpy(stats: SchedStats) -> dict:
    return {k: _numpy(v) for k, v in stats._asdict().items()}


def _queue_from_numpy(eq, device):
    """A dense or wheel queue (chosen by the class name), or the SPMD
    round's raw (t, w_ampa, w_gaba) planes."""
    if type(eq).__name__ == "WheelQueue":
        return wheel_queue_from_numpy(eq, device)
    if hasattr(eq, "_fields") or isinstance(eq, dict):
        return event_queue_from_numpy(eq, device)
    return tuple(_tensor(x, device) for x in eq)


def _queue_to_numpy(eq):
    if hasattr(eq, "_asdict"):
        return {k: _numpy(v) for k, v in eq._asdict().items()}
    return tuple(_numpy(x) for x in eq)


def _counters_from_numpy(counters, device) -> dict:
    out = {}
    for k, v in counters.items():
        if k == "stats":
            out[k] = sched_stats_from_numpy(v, device)
        elif k == "rounds":
            out[k] = int(np.asarray(v))
        else:
            out[k] = _tensor(v, device)
    return out


def sim_carry_from_numpy(sc, device) -> SimCarry:
    """A JAX ``repro.core.exec_common.SimCarry`` (numpy leaves) -> the
    port's: the batched ``BDFState``, the queue (``WheelQueue`` when its
    class is named so, else ``EventQueue``; the SPMD planes stay a
    tuple), the spike record, the ``hcarry`` arrays and the counters
    (``stats`` a ``SchedStats``, ``rounds`` a Python int, as the port's
    runners carry it)."""
    f = _fields(sc, SimCarry._fields)
    return SimCarry(bdf_state_from_numpy(f["sts"], device),
                    _queue_from_numpy(f["eq"], device),
                    spike_record_from_numpy(f["rec"], device),
                    tuple(_tensor(x, device) for x in f["hcarry"]),
                    _counters_from_numpy(f["counters"], device))


def sim_carry_to_numpy(sc) -> dict:
    """The port's ``SimCarry`` -> a dict of the same fields, each a dict
    (or tuple) of numpy arrays; ``counters["stats"]`` a dict too."""
    counters = {k: (sched_stats_to_numpy(v) if k == "stats" else
                    np.asarray(v) if k == "rounds" else _numpy(v))
                for k, v in sc.counters.items()}
    return {"sts": bdf_state_to_numpy(sc.sts), "eq": _queue_to_numpy(sc.eq),
            "rec": spike_record_to_numpy(sc.rec),
            "hcarry": tuple(_numpy(x) for x in sc.hcarry),
            "counters": counters}


def tenant_carry_from_numpy(carry, device) -> tuple:
    """The service's batched round carry of JAX (``stack_lanes`` of
    ``init_carry`` carries, every leaf with a leading [T] axis: (sts, eq,
    rec, n_ev, n_rs, stats, rounds), numpy leaves) -> the port's, the
    input of ``run.tenant_round`` (``rounds`` an i64[T] tensor, as the
    port's ``serve.stack_lanes`` makes it)."""
    sts, eq, rec, n_ev, n_rs, stats, rounds = carry
    return (bdf_state_from_numpy(sts, device), _queue_from_numpy(eq, device),
            spike_record_from_numpy(rec, device), _tensor(n_ev, device),
            _tensor(n_rs, device), sched_stats_from_numpy(stats, device),
            torch.as_tensor(np.asarray(rounds, np.int64), device=device))


def tenant_carry_to_numpy(carry) -> tuple:
    """The port's batched round carry -> a tuple of the same slots, as
    dicts of numpy arrays and arrays."""
    sts, eq, rec, n_ev, n_rs, stats, rounds = carry
    return (bdf_state_to_numpy(sts), _queue_to_numpy(eq),
            spike_record_to_numpy(rec), _numpy(n_ev), _numpy(n_rs),
            sched_stats_to_numpy(stats), _numpy(rounds))


def lm_params_from_numpy(cfg, params, device) -> dict:
    """The JAX package's dense/vlm parameter tree (numpy arrays: ``emb``,
    ``ln_f``, optional ``patch_proj``, and ``layers`` stacked ``[L, ...]``)
    -> the port's parameters: the same ``[in, out]`` layout, one dict per
    layer, in ``cfg``'s parameter dtype."""
    dt = cfg.pdtype()

    def tensor(a):
        return torch.as_tensor(np.array(a, np.float32), device=device).to(dt)

    layers = {k: np.asarray(v) for k, v in params["layers"].items()}
    out = {"emb": tensor(params["emb"]), "ln_f": tensor(params["ln_f"]),
           "layers": [{k: tensor(v[i]) for k, v in layers.items()}
                      for i in range(cfg.n_layers)]}
    if "patch_proj" in params:
        out["patch_proj"] = tensor(params["patch_proj"])
    return out
