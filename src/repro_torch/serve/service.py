"""Multi-tenant simulation serving: continuous admission, per-tenant
quarantine and retry, deadlines, QoS and overload shedding.  Counterpart
of ``repro.serve.service``.

``SimService`` drives T lanes of one FAP round (``run.tenant_round``: the
tenants' networks side by side as T*N lanes, per-tenant stimulus, lane
mask and QoS frontier cap; under a runner's active-set knobs each tenant
also its own compact batch, fan-out and incremental horizon) and a
host-side state machine at round boundaries:

  admission   -- a bounded queue admits experiments into free lanes,
                 highest QoS class first, FIFO within a class; a full
                 queue sheds the lowest-QoS request with an explicit
                 rejection.
  isolation   -- ``exec_common.health_check_tenants`` judges each tenant
                 on its own neurons every round; a non-finite tenant is
                 quarantined (masked out), rolled back to its own last
                 clean snapshot and retried under ``ExponentialBackoff``,
                 a bounded number of times, while the others advance.  A
                 solver failure on a finite state is deterministic, so
                 that tenant is evicted instead.
  deadlines   -- service-round and wall-clock deadlines evict overrunning
                 tenants.
  shedding    -- when the ``StragglerMonitor`` flags a sustained round-time
                 regression, one lowest-QoS queued request a round is
                 rejected ("shed:overload").

Every request ends in exactly one of completed, evicted or rejected
(``ServeResult.assert_accounting``).  A tenant's lanes never mix with
another's and an inactive tenant's round leaves its state as it was, so
its spike train is bitwise the same solo, in a full batch or through a
quarantine and retry.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import ExponentialBackoff, save_tenant_checkpoint
from repro_torch.checkpoint.fault_tolerance import (FaultPlan,
                                                    SimulatedFailure,
                                                    StragglerMonitor)
from repro_torch.core import exec_common as xc
from repro_torch.core.exec_fap import make_fap_vardt_runner
from repro_torch.serve.tenants import (LaneState, TenantRequest, TenantResult,
                                       lane_slice, stack_lanes, write_lane)


@dataclass
class ServeResult:
    """The accounting of one service run."""
    submitted: int = 0
    admitted: int = 0
    completed: int = 0
    evicted: int = 0
    rejected: int = 0
    retried: int = 0            # quarantine-retry attempts consumed
    quarantines: int = 0        # quarantine events (rollback + backoff)
    shed: int = 0               # rejections for a full queue or overload
    rounds: int = 0             # service rounds driven
    results: dict = field(default_factory=dict)   # rid -> TenantResult
    health: dict = field(default_factory=dict)

    def assert_accounting(self):
        """Every submitted request has exactly one terminal state and the
        counters partition ``submitted``."""
        assert self.completed + self.evicted + self.rejected == \
            self.submitted, self
        assert len(self.results) == self.submitted, self
        by = {"completed": 0, "evicted": 0, "rejected": 0}
        for r in self.results.values():
            assert r.status in by, r
            by[r.status] += 1
        assert by["completed"] == self.completed, (by, self)
        assert by["evicted"] == self.evicted, (by, self)
        assert by["rejected"] == self.rejected, (by, self)
        assert self.shed <= self.rejected, self
        return self


class SimService:
    """Tenant-isolated simulation service over one FAP runner.

    lanes:        number of tenants a round carries.
    queue_cap:    bound of the admission queue; overflow sheds lowest QoS.
    backoff:      ``ExponentialBackoff`` quarantine-retry policy (delays in
                  service rounds; ``max_retries`` bounds attempts).
    qos_caps:     {qos_class: k_qos} per-round frontier caps (0 or absent
                  = unlimited).
    straggler:    a configured ``StragglerMonitor``; its ``sustained()``
                  verdict triggers overload shedding and its ``stats()``
                  ride ``ServeResult.health["straggler"]``.
    shed_sustained_frac: share of the monitor window that must flag.
    ckpt_dir / checkpoint_every: every ``checkpoint_every`` clean rounds a
                  tenant's carry slice is committed to its own checkpoint
                  directory (``checkpoint.save_tenant_checkpoint``).
    snapshot_every: clean rounds between the in-memory rollback snapshots.
    fault:        ``FaultPlan``: with ``poison_tenant`` set, once that
                  request has run ``poison_at_round`` rounds, neuron
                  ``poison_lane`` of its own network is poisoned (once);
                  ``fail_at_round`` (service rounds) simulates a
                  preemption of the whole service.
    runner:       a ``make_fap_vardt_runner`` product to share between
                  services, with any of its knobs (the compact batch and
                  fan-out, the wheel, either horizon); else one is built
                  from ``model``, ``net``, ``t_end`` and
                  ``runner_kwargs``.
    """

    def __init__(self, model=None, net=None, t_end: float = 10.0, *,
                 lanes: int = 4, queue_cap: int = 8,
                 backoff: ExponentialBackoff = ExponentialBackoff(),
                 qos_caps: Optional[dict] = None,
                 straggler: Optional[StragglerMonitor] = None,
                 shed_sustained_frac: float = 0.25,
                 ckpt_dir: Optional[str] = None, checkpoint_every: int = 0,
                 snapshot_every: int = 1,
                 fault: Optional[FaultPlan] = None,
                 runner=None, runner_kwargs: Optional[dict] = None,
                 log_fn=None):
        if runner is None:
            if model is None or net is None:
                raise ValueError("need model+net or a prebuilt runner=")
            runner = make_fap_vardt_runner(model, net, 0.0, t_end,
                                           **(runner_kwargs or {}))
        self.runner = runner
        self.t_end = float(t_end)
        self.L = int(lanes)
        self.queue_cap = int(queue_cap)
        self.backoff = backoff
        self.qos_caps = dict(qos_caps or {})
        self.monitor = straggler if straggler is not None \
            else StragglerMonitor()
        self.shed_sustained_frac = float(shed_sustained_frac)
        self.ckpt_dir = ckpt_dir
        self.checkpoint_every = int(checkpoint_every)
        self.snapshot_every = max(1, int(snapshot_every))
        self.fault = fault
        self._poison_pending = (fault is not None
                                and fault.poison_tenant is not None)
        self.log = log_fn or (lambda *_: None)

        base = runner.init_carry(0.0)
        self._carry = stack_lanes([base] * self.L)
        self._dev = self._carry[0].t.device

        self.lanes: list = [None] * self.L     # Optional[LaneState]
        self.queue: deque = deque()            # (TenantRequest, submit round)
        self.round = 0
        self.res = ServeResult()
        self._wait_rounds: list = []           # admission latencies
        self._snapshots_saved = 0

    # --- admission / shedding ---------------------------------------------

    def submit(self, req: TenantRequest) -> bool:
        """Enqueue a request; a full queue sheds the lowest-QoS request
        (the incoming one or a queued one) with an explicit rejection.
        Returns True when ``req`` is queued."""
        if req.rid in self.res.results or \
                any(r.rid == req.rid for r, _ in self.queue) or \
                any(ls is not None and ls.req.rid == req.rid
                    for ls in self.lanes):
            raise ValueError(f"duplicate request id {req.rid}")
        self.res.submitted += 1
        if len(self.queue) >= self.queue_cap:
            # shed lowest QoS; ties shed the incoming request (FIFO wins)
            victim_i = min(range(len(self.queue)),
                           key=lambda i: self.queue[i][0].qos)
            victim, _ = self.queue[victim_i]
            if victim.qos < req.qos:
                del self.queue[victim_i]
                self._reject(victim, "shed:queue_full", shed=True)
                self.queue.append((req, self.round))
                return True
            self._reject(req, "shed:queue_full", shed=True)
            return False
        self.queue.append((req, self.round))
        return True

    def _reject(self, req: TenantRequest, reason: str, shed: bool = False):
        self.res.rejected += 1
        if shed:
            self.res.shed += 1
        self.res.results[req.rid] = TenantResult(req.rid, "rejected", reason)
        self.log(f"[serve] rejected rid={req.rid} ({reason})")

    def _shed_overload(self):
        """Sustained round-time regression: shed one lowest-QoS queued
        request (running tenants are never killed)."""
        if not self.queue or \
                not self.monitor.sustained(self.shed_sustained_frac):
            return
        i = min(range(len(self.queue)), key=lambda i: self.queue[i][0].qos)
        req, _ = self.queue[i]
        del self.queue[i]
        self._reject(req, "shed:overload", shed=True)

    def _admit(self):
        free = [k for k in range(self.L) if self.lanes[k] is None]
        for k in free:
            if not self.queue:
                break
            # highest QoS class first, FIFO (submit order) within a class
            i = min(range(len(self.queue)),
                    key=lambda i: (-self.queue[i][0].qos, i))
            req, submit_round = self.queue[i]
            del self.queue[i]
            fresh = self.runner.init_carry(req.iinj)
            self._carry = write_lane(self._carry, k, fresh)
            ls = LaneState(lane=k, req=req, submit_round=submit_round,
                           admit_round=self.round, admit_time=time.monotonic(),
                           snapshot=lane_slice(self._carry, k))
            self.lanes[k] = ls
            self.res.admitted += 1
            self._wait_rounds.append(self.round - submit_round)
            self.log(f"[serve] admitted rid={req.rid} -> lane {k} "
                     f"(waited {self.round - submit_round} rounds)")

    # --- per-lane lifecycle -----------------------------------------------

    def _finish(self, ls: LaneState, status: str, reason: str = "",
                harvest: bool = False):
        """Terminalize a lane: harvest its spike record (completed) or
        drop it (evicted) and free the lane; the rid gets its one
        ``TenantResult`` either way."""
        res = TenantResult(ls.req.rid, status, reason,
                           rounds=ls.rounds_run, retries=ls.retries,
                           wait_rounds=ls.admit_round - ls.submit_round,
                           health=ls.health())
        if harvest:
            rec = lane_slice(self._carry[2], ls.lane)
            res.times = rec.times.cpu().numpy()
            res.count = rec.count.cpu().numpy()
            res.overflow = int(rec.overflow)
        self.res.results[ls.req.rid] = res
        if status == "completed":
            self.res.completed += 1
        else:
            self.res.evicted += 1
        self.lanes[ls.lane] = None
        self.log(f"[serve] {status} rid={ls.req.rid}"
                 f"{' (' + reason + ')' if reason else ''} "
                 f"after {ls.rounds_run} rounds, {ls.retries} retries")

    def _quarantine(self, ls: LaneState):
        """Roll the lane back to its own last clean snapshot and schedule
        a bounded-backoff retry; an exhausted budget evicts."""
        self.res.quarantines += 1
        ls.nonfinite_rounds += 1
        budget = ls.req.max_retries if ls.req.max_retries is not None \
            else self.backoff.max_retries
        self._carry = write_lane(self._carry, ls.lane, ls.snapshot)
        if ls.retries >= budget:
            self._finish(ls, "evicted", "retries_exhausted")
            return
        ls.retries += 1
        self.res.retried += 1
        delay = self.backoff.delay(ls.retries)
        ls.backoff_until = self.round + delay
        ls.quarantined = True
        self.log(f"[serve] quarantined rid={ls.req.rid} (retry "
                 f"{ls.retries}/{budget}, backoff {delay} rounds)")

    def _reactivate(self):
        for ls in self.lanes:
            if ls is not None and ls.quarantined \
                    and self.round >= ls.backoff_until:
                ls.quarantined = False
                self.log(f"[serve] retrying rid={ls.req.rid}")

    def _inject_fault(self):
        """Per-tenant poison: once the target tenant has run
        ``poison_at_round`` rounds, corrupt neuron ``poison_lane`` of its
        own lane (once; the retry after rollback is clean)."""
        if not self._poison_pending:
            return
        f = self.fault
        at = f.poison_at_round if f.poison_at_round is not None else 0
        for ls in self.lanes:
            if ls is not None and not ls.quarantined \
                    and ls.req.rid == f.poison_tenant \
                    and ls.rounds_run >= at:
                sts = self._carry[0]
                zn = sts.zn.clone()
                zn[ls.lane, f.poison_lane] = f.poison_value
                self._carry = (sts._replace(zn=zn),) + self._carry[1:]
                self._poison_pending = False
                self.log(f"[serve] poisoned rid={ls.req.rid} neuron "
                         f"{f.poison_lane} at tenant round {ls.rounds_run}")
                return

    # --- the service round -------------------------------------------------

    def _active(self):
        return [ls for ls in self.lanes
                if ls is not None and not ls.quarantined]

    def step(self) -> bool:
        """One service round; False when fully idle (nothing running,
        queued or waiting out a backoff)."""
        if self.fault is not None and self.fault.fail_at_round is not None \
                and self.round >= self.fault.fail_at_round:
            raise SimulatedFailure(self.round)
        self._reactivate()
        self._admit()
        self._inject_fault()
        active = self._active()
        if not active and not self.queue and \
                all(ls is None or not ls.quarantined for ls in self.lanes):
            return False

        if active:
            amask = np.zeros((self.L,), bool)
            iinj = np.zeros((self.L,), np.float64)
            kqos = np.zeros((self.L,), np.int64)
            for ls in active:
                amask[ls.lane] = True
                iinj[ls.lane] = ls.req.iinj
                kqos[ls.lane] = int(self.qos_caps.get(ls.req.qos, 0))
            t_prev = self._carry[0].t
            t0 = time.perf_counter()
            self._carry = self.runner.tenant_round(
                self._carry, torch.from_numpy(iinj).to(self._dev),
                torch.from_numpy(amask).to(self._dev),
                torch.from_numpy(kqos).to(self._dev))
            if self._dev.type == "cuda":
                torch.cuda.synchronize(self._dev)
            self.monitor.record(time.perf_counter() - t0)
            for ls in active:
                ls.rounds_run += 1

            # per-tenant verdicts, each on its own neurons, in one read
            v = xc.health_check_tenants(self._carry[0], t_prev)
            nonfinite, solver_failed, t_min = torch.stack([
                v["nonfinite_lanes"].to(torch.float64),
                v["solver_failed"].to(torch.float64),
                self._carry[0].t.amin(dim=1)]).cpu().numpy()
            for ls in list(active):
                if nonfinite[ls.lane]:
                    self._quarantine(ls)
                elif solver_failed[ls.lane]:
                    # deterministic failure on finite state: retry can't help
                    self._finish(ls, "evicted", "solver_failure")
                else:
                    self._postround_clean(ls, float(t_min[ls.lane]))

        self._shed_overload()
        self.round += 1
        self.res.rounds = self.round
        return True

    def _postround_clean(self, ls: LaneState, t_min: float):
        """Clean verdict: snapshot, then completion / deadline checks."""
        if ls.rounds_run - ls.snapshot_round >= self.snapshot_every:
            ls.snapshot = lane_slice(self._carry, ls.lane)
            ls.snapshot_round = ls.rounds_run
            if self.ckpt_dir and self.checkpoint_every and \
                    ls.rounds_run % self.checkpoint_every == 0:
                save_tenant_checkpoint(
                    self.ckpt_dir, ls.req.rid, ls.rounds_run,
                    self.runner.pack(ls.snapshot),
                    extras={"rid": ls.req.rid, "t_min": t_min})
                self._snapshots_saved += 1
        target = ls.req.t_target if ls.req.t_target is not None \
            else self.t_end
        if t_min >= target - 1e-9:
            self._finish(ls, "completed", harvest=True)
            return
        if ls.req.deadline_rounds and ls.rounds_run >= ls.req.deadline_rounds:
            self._finish(ls, "evicted", "deadline_rounds")
            return
        if ls.req.deadline_s and \
                time.monotonic() - ls.admit_time >= ls.req.deadline_s:
            self._finish(ls, "evicted", "deadline_wall")

    # --- the run loop ----------------------------------------------------

    def run(self, max_rounds: int = 100_000) -> ServeResult:
        """Drive rounds until idle (or the bound); then every survivor is
        terminalized explicitly: running tenants evicted and queued
        requests rejected, with reason "shutdown"."""
        while self.round < max_rounds and self.step():
            pass
        for ls in list(self.lanes):
            if ls is not None:
                self._finish(ls, "evicted", "shutdown")
        while self.queue:
            req, _ = self.queue.popleft()
            self._reject(req, "shutdown")
        self.res.health = self.health()
        return self.res.assert_accounting()

    def health(self) -> dict:
        w = self._wait_rounds
        return {
            "straggler": self.monitor.stats(),
            "backoff": {"max_retries": self.backoff.max_retries,
                        "budget_rounds": self.backoff.budget()},
            "quarantines": self.res.quarantines,
            "snapshots_saved": self._snapshots_saved,
            "admission_wait_rounds": {
                "mean": float(np.mean(w)) if w else 0.0,
                "max": int(max(w)) if w else 0},
            "queue_depth": len(self.queue),
            "shed": self.res.shed,
        }
