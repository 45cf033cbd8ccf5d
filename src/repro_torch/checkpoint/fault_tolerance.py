"""Fault tolerance for long training and simulation runs.  Counterpart of
``repro.checkpoint.fault_tolerance``: the same fields, defaults and
verdicts.

``RestartManager`` wraps a training loop: periodic checkpoints with
pruning, resume from the latest complete checkpoint, a non-finite-loss
quarantine (restore the last checkpoint and skip the poisoned data step)
and failure injection for tests.

``FaultPlan`` brings the same injection to simulation rounds: the vardt
loops (``exec_common.run_checkpointed`` behind the single-device
runners and ``run_fap_spmd``) read it at round boundaries -- kill at round
k (``SimulatedFailure``), poison one lane's BDF history with a non-finite
value (the watchdog must detect it and roll back), or a ``mutate`` hook.

``StragglerMonitor`` keeps per-step wall times in an O(window) deque and
flags outliers; its ``stats()`` ride ``RunResult.health``.
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.checkpoint.checkpoint import (latest_step, prune_checkpoints,
                                               restore_checkpoint,
                                               save_checkpoint)


@dataclass
class StragglerMonitor:
    """Flags a step slower than ``threshold`` x the median of the rolling
    ``window`` before it.  The checkpointed run loops take a configured
    monitor (``run_checkpointed(straggler=...)``) and the service exposes
    one, so the shedding verdict is tunable and observable."""
    window: int = 32
    threshold: float = 2.5
    times: Any = None          # deque(maxlen=window): O(window) memory
    flagged: int = 0
    recorded: int = 0          # total steps seen (the deque forgets)
    flags: Any = None          # deque(maxlen=window) of recent verdicts

    def __post_init__(self):
        if self.times is None:
            self.times = deque(maxlen=self.window)
        elif not isinstance(self.times, deque):
            self.times = deque(self.times, maxlen=self.window)
        if self.flags is None:
            self.flags = deque(maxlen=self.window)
        elif not isinstance(self.flags, deque):
            self.flags = deque(self.flags, maxlen=self.window)

    def record(self, dt: float) -> bool:
        """Record one step's seconds; True if it is a straggler."""
        self.times.append(dt)
        self.recorded += 1
        hist = list(self.times)
        if len(hist) < 8:
            self.flags.append(False)
            return False
        med = float(np.median(hist[:-1]))
        slow = dt > self.threshold * med
        self.flags.append(slow)
        if slow:
            self.flagged += 1
        return slow

    def sustained(self, frac: float = 0.25, min_steps: int = 8) -> bool:
        """At least ``frac`` of the last ``window`` steps flagged, with at
        least ``min_steps`` seen: the overload-shedding trigger."""
        hist = list(self.flags)
        if len(hist) < min_steps:
            return False
        return sum(hist) >= frac * len(hist)

    def stats(self) -> dict:
        """Host-side summary for ``RunResult.health`` (floats/ints only)."""
        hist = list(self.times)
        return {"recorded": self.recorded, "flagged": self.flagged,
                "window": self.window, "threshold": self.threshold,
                "sustained": self.sustained(),
                "window_median_s": float(np.median(hist)) if hist else 0.0,
                "window_max_s": float(max(hist)) if hist else 0.0}


@dataclass
class FaultPlan:
    """Deterministic fault injection at simulation-round boundaries.

    fail_at_round:   raise ``SimulatedFailure`` when the round counter
                     reaches this value (a simulated preemption; the
                     caller relaunches with ``resume=True``).
    poison_at_round: once, at this round boundary, overwrite lane
                     ``poison_lane``'s BDF history (``zn``) with
                     ``poison_value``: the watchdog must detect it, roll
                     back and retry (the retry is clean).
    mutate:          hook ``(round_idx, carry) -> carry`` applied every
                     round before stepping.
    poison_tenant:   the service's target (``repro_torch.serve``): the
                     request id whose network gets the poison once it has
                     run ``poison_at_round`` rounds; ``poison_lane`` is a
                     neuron of that tenant's network.  The single-run
                     runners ignore it.
    """
    fail_at_round: Optional[int] = None
    poison_at_round: Optional[int] = None
    poison_lane: int = 0
    poison_value: float = float("nan")
    mutate: Optional[Callable] = None
    poison_tenant: Optional[int] = None


@dataclass(frozen=True)
class ExponentialBackoff:
    """Bounded exponential retry schedule in scheduler rounds.  Retry
    ``a`` (1-based) waits ``min(cap, base * factor**(a-1))`` rounds; after
    ``max_retries`` failed attempts the caller evicts or escalates."""
    base: int = 2
    factor: float = 2.0
    cap: int = 32
    max_retries: int = 3

    def delay(self, attempt: int) -> int:
        """Rounds to wait before retry ``attempt`` (1-based), capped."""
        if attempt < 1:
            raise ValueError("attempt is 1-based")
        return int(min(self.cap, self.base * self.factor ** (attempt - 1)))

    def budget(self) -> int:
        """Total backoff rounds over the whole retry budget."""
        return sum(self.delay(a) for a in range(1, self.max_retries + 1))


@dataclass
class RestartManager:
    ckpt_dir: str
    save_every: int = 50
    keep: int = 3
    max_nan_retries: int = 3

    def resume_or_init(self, init_fn: Callable[[], Any]):
        """Returns (state_tree, extras, start_step)."""
        step = latest_step(self.ckpt_dir)
        if step is None:
            return init_fn(), {}, 0
        like = init_fn()
        state, extras = restore_checkpoint(self.ckpt_dir, step, like)
        return state, extras, step

    def run(self, state, start_step: int, n_steps: int,
            step_fn: Callable[[Any, int], tuple],
            data_state_fn: Callable[[], dict] = lambda: {},
            inject_failure_at: Optional[int] = None,
            log_every: int = 10, log_fn=print):
        """Drive ``state', metrics = step_fn(state, step)``; ``metrics``
        holds ``"loss"``.  Returns (state, history)."""
        monitor = StragglerMonitor()
        history = []
        nan_retries = 0
        step = start_step
        while step < n_steps:
            if inject_failure_at is not None and step == inject_failure_at:
                inject_failure_at = None
                raise SimulatedFailure(step)
            t0 = time.time()
            new_state, metrics = step_fn(state, step)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if not math.isfinite(loss):
                nan_retries += 1
                if nan_retries > self.max_nan_retries:
                    raise RuntimeError(f"non-finite loss at step {step}, "
                                       f"retries exhausted")
                last = latest_step(self.ckpt_dir)
                log_fn(f"[ft] non-finite loss at step {step}; restoring "
                       f"step {last} and skipping batch")
                if last is not None:
                    state, _ = restore_checkpoint(self.ckpt_dir, last, state)
                step += 1                      # skip the poisoned batch
                continue
            nan_retries = 0
            state = new_state
            if monitor.record(dt):
                log_fn(f"[ft] straggler step {step}: {dt:.3f}s "
                       f"(median ~{monitor.stats()['window_median_s']:.3f}s)")
            history.append({"step": step, "loss": loss, "time_s": dt})
            if log_every and step % log_every == 0:
                log_fn(f"step {step}: loss={loss:.4f} ({dt:.2f}s)")
            step += 1
            if self.save_every and step % self.save_every == 0:
                save_checkpoint(self.ckpt_dir, step, state,
                                extras=data_state_fn())
                prune_checkpoints(self.ckpt_dir, self.keep)
        save_checkpoint(self.ckpt_dir, step, state, extras=data_state_fn())
        prune_checkpoints(self.ckpt_dir, self.keep)
        return state, history


class SimulatedFailure(RuntimeError):
    """Raised by failure injection; tests catch it and resume."""

    def __init__(self, step):
        super().__init__(f"simulated preemption at step {step}")
        self.step = step
