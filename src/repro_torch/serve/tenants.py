"""Lane <-> request bookkeeping of the multi-tenant simulation service.
Counterpart of ``repro.serve.tenants``.

``repro_torch.serve`` runs T independent experiments through one round
(``run.tenant_round``): every carry leaf gains a leading [T] lane axis and
each lane holds one tenant's network (the same topology, its own
stimulus).  The helpers here restructure between the batched carry and
one tenant's carry without ever mixing lanes:

  * ``stack_lanes`` / ``lane_slice`` / ``write_lane`` -- ``write_lane``
    changes exactly one index of every leaf, and ``lane_slice`` returns a
    copy, so a quarantine snapshot never aliases the live batch;
  * ``TenantRequest`` / ``TenantResult`` -- a submitted experiment and its
    single terminal outcome (completed, evicted or rejected);
  * ``LaneState`` -- the host-side record of one occupied lane.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree


# --- batched-carry plumbing -------------------------------------------------

def stack_lanes(carries):
    """Stack per-tenant carries along a new leading lane axis.  Python
    scalars (the round counter) become a tensor beside the carry's
    tensors."""
    dev = next(x.device for x in pytree.tree_leaves(carries[0])
               if isinstance(x, torch.Tensor))

    def stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        return torch.as_tensor(xs, device=dev)

    return pytree.tree_map(stack, carries[0], *carries[1:])


def lane_slice(batched, k: int):
    """One tenant's carry: a copy of index ``k`` of every leaf's lane
    axis (safe to hold as a snapshot while the batch moves on)."""
    return pytree.tree_map(lambda x: x[k].clone(), batched)


def write_lane(batched, k: int, lane_tree):
    """The batch with lane ``k`` of every leaf set to ``lane_tree``'s
    values; every other lane keeps its values bitwise.  The batch's own
    tensors are not written: the result holds copies."""
    def put(b, v):
        out = b.clone()
        out[k] = v
        return out

    return pytree.tree_map(put, batched, lane_tree)


# --- wire types -------------------------------------------------------------

@dataclass(frozen=True)
class TenantRequest:
    """One experiment submitted to the service.

    rid:             caller-chosen unique request id.
    iinj:            the tenant's injected current (nA, a scalar).
    qos:             QoS class, higher = more important: admission pops
                     the highest class first, shedding evicts the lowest;
                     ``SimService.qos_caps`` maps a class to its per-round
                     frontier cap (``k_qos`` of ``run.tenant_round``).
    t_target:        simulated-time goal (ms); None = the service's
                     ``t_end``.  Done when the lane's earliest clock
                     reaches it.
    deadline_rounds: max service rounds after admission (0 = none).
    deadline_s:      wall-clock deadline after admission (0 = none).
    max_retries:     per-tenant quarantine-retry budget (None = the
                     service backoff policy's).
    """
    rid: int
    iinj: float = 0.0
    qos: int = 1
    t_target: Optional[float] = None
    deadline_rounds: int = 0
    deadline_s: float = 0.0
    max_retries: Optional[int] = None


@dataclass
class TenantResult:
    """The single terminal outcome of a request (completed / evicted /
    rejected; ``reason`` says why for the others)."""
    rid: int
    status: str                      # "completed" | "evicted" | "rejected"
    reason: str = ""
    times: Optional[np.ndarray] = None    # f64[N, S] spike times (+inf pad)
    count: Optional[np.ndarray] = None    # i32[N] per-neuron spike counts
    overflow: int = 0
    rounds: int = 0                  # service rounds the tenant ran
    retries: int = 0                 # quarantine-retry attempts consumed
    wait_rounds: int = 0             # admission latency (queue wait)
    health: dict = field(default_factory=dict)


@dataclass
class LaneState:
    """Host-side record of one occupied lane (the service state machine)."""
    lane: int
    req: TenantRequest
    submit_round: int
    admit_round: int
    admit_time: float
    rounds_run: int = 0              # service rounds actually stepped
    retries: int = 0                 # quarantine-retry attempts consumed
    nonfinite_rounds: int = 0
    backoff_until: int = -1          # service round the quarantine lifts
    quarantined: bool = False
    snapshot: Any = None             # last clean lane-slice carry
    snapshot_round: int = 0          # rounds_run the snapshot was taken at

    def health(self) -> dict:
        return {"rounds": self.rounds_run, "retries": self.retries,
                "nonfinite_rounds": self.nonfinite_rounds,
                "quarantined": self.quarantined,
                "wait_rounds": self.admit_round - self.submit_round}
