"""Carefully-speculative FAP variable-timestep execution, batched.
Counterpart of ``repro.core.exec_speculative``.

The paper's §2.4 found naive speculation (step anywhere, backstep on late
events) infeasible at scale: reverting sent spikes cascades across compute
nodes.  Its §Discussion proposes "a carefully-speculative execution model
performing speculative stepping while avoiding the initiation of
cascades".  Per round:

  1. validation: a neuron whose speculated span an event has since landed
     in restores its snapshot (a local backstep) and drops its held spike;
     otherwise the speculation stands and the clock keeps its head start;
  2. the conservative phase, as in ``exec_fap``'s 2c round: every neuron
     behind its dependency horizon advances to it (the edge scatter-min
     ``exec_common.horizon_times``, as the JAX runner computes it), spikes
     fan out at once, and held spikes whose time the horizon has now
     passed are emitted;
  3. the snapshot of the validated state, then speculative stepping up to
     ``spec_window`` ms past the horizon for neurons with no known event
     due in that span -- any spike emitted there is held, so nothing
     leaves the neuron and nothing ever has to be retracted elsewhere.

The JAX runner is one ``lax.while_loop`` over rounds; here the rounds are a
host loop whose ``cond`` reads the validated clock (the snapshot's).  The
snapshot is the state tuple itself: every update of a ``BDFState`` builds
new tensors (``lane_where``, ``bdf.scatter_lanes``, the step's
``_replace``), so nothing later writes into it.  On a card a round runs
K1, K2 and K4 in its advances; ``fanout="compact"`` launches K7 and
``queue="wheel"`` K8.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import sched
from repro_torch.core import bdf
from repro_torch.core import events as ev
from repro_torch.core import exec_common as xc
from repro_torch.core.cell import CellModel
from repro_torch.core.exec_bsp import (EV_CAP, SPK_CAP, RunResult,
                                       make_vardt_advance)
from repro_torch.core.network import Network


class SpecStats(NamedTuple):
    hits: torch.Tensor          # i32[] validated speculations
    backsteps: torch.Tensor     # i32[] discarded speculations (local)
    wasted_steps: torch.Tensor  # i32[] BDF steps thrown away
    held_spikes: torch.Tensor   # i32[] spikes held, then emitted

    @staticmethod
    def zeros(device) -> "SpecStats":
        z = torch.zeros((), dtype=torch.int32, device=device)
        return SpecStats(z, z, z, z)


def _count(mask):
    return mask.sum().to(torch.int32)


def make_spec_runner(model: CellModel, net: Network, iinj, t_end: float,
                     opts: bdf.BDFOptions = bdf.BDFOptions(),
                     horizon_cap: float = 2.0, spec_window: float = 2.0,
                     step_budget: int = 12, ev_cap: int = EV_CAP,
                     max_rounds: int = 1_000_000, queue: str = "dense",
                     wheel: sched.WheelSpec = sched.WheelSpec(),
                     fanout: str = "dense", spike_cap: int = 0,
                     device="cuda"):
    """Carefully-speculative 2c (see the module docstring).

    horizon_cap:  the conservative horizon is at most t + horizon_cap.
    spec_window:  speculation runs to min(horizon + spec_window, t_end).
    queue:        "dense" (slot queue) or "wheel" (geometry ``wheel``; its
                  inserts rank with K8).
    fanout:       "dense" or "compact" (K7; spike_cap <= 0 means
                  min(N, 256)).
    iinj:         injected soma current (nA), a scalar or one per neuron.
    device:       "cuda" (default; raises without a card) or "cpu".

    Returns a nullary runner ``run() -> (RunResult, SpecStats, rounds)``
    that also exposes ``run.init_carry`` / ``run.round_body`` /
    ``run.cond`` and ``run.validate`` (step 1 of a round alone).
    ``RunResult.n_steps``, ``y_final`` and ``solver`` are the validated
    state's.
    """
    dev = model.runner_device(device)
    n = net.n
    dnet = xc.to_device(net, dev)
    qops = sched.get_queue_ops(queue, ev_cap=ev_cap, wheel=wheel)
    qinsert = sched.edge_insert(qops, net)
    spike_ins = xc.make_spike_insert(net, dnet, qops, qinsert, fanout,
                                     spike_cap)
    iinj_v = xc.per_neuron(iinj, n, dev)
    neuron_ids = torch.arange(n, dtype=torch.int64, device=dev)
    advance = make_vardt_advance(model, opts, 0.0, step_budget)

    def validate(carry):
        """Backstep every neuron that an event due before its speculated
        clock invalidates; count hits, backsteps and wasted steps."""
        (sts, snap, spec_on, held_sp, held_t, eq, rec, n_ev, n_rs, stats,
         rounds) = carry
        invalid = spec_on & (qops.next_time(eq) < sts.t - 1e-12)
        valid = spec_on & ~invalid
        wasted = torch.where(invalid, sts.nst - snap.nst, 0).sum()
        sts = bdf.lane_where(invalid, snap, sts)
        held_sp = held_sp & ~invalid               # drop unvalidated spikes
        stats = stats._replace(
            hits=stats.hits + _count(valid),
            backsteps=stats.backsteps + _count(invalid),
            wasted_steps=stats.wasted_steps + wasted.to(torch.int32))
        return (sts, snap, spec_on, held_sp, held_t, eq, rec, n_ev, n_rs,
                stats, rounds)

    def round_body(carry):
        (sts, snap, spec_on, held_sp, held_t, eq, rec, n_ev, n_rs, stats,
         rounds) = validate(carry)

        # ---- conservative phase (as exec_fap's 2c round) -------------------
        horizon = xc.horizon_times(dnet, n, sts.t, t_end,
                                   horizon_cap=horizon_cap)
        runnable = xc.runnable_mask(sts.t, horizon)
        sts, eq_t, spiked, t_sp, nd, nrs = advance(
            sts, eq.t, eq.w_ampa, eq.w_gaba, horizon, runnable, iinj_v)
        eq = eq._replace(t=eq_t)
        # emit the held spikes this round's horizon validates
        emit_held = held_sp & (held_t <= horizon + 1e-12)
        stats = stats._replace(
            held_spikes=stats.held_spikes + _count(emit_held))
        held_sp = held_sp & ~emit_held
        all_spiked = spiked | emit_held
        all_tsp = torch.where(emit_held, held_t, t_sp)
        rec = ev.record_spikes(rec, neuron_ids, all_tsp, all_spiked)
        if bool(all_spiked.any()):
            # a spike-free round inserts nothing: skipping is identical
            eq = spike_ins(eq, all_spiked, all_tsp)

        # ---- speculative phase (hold spikes; nothing leaves the neuron) ----
        snap = sts
        spec_limit = torch.clamp(horizon + spec_window, max=t_end)
        can_spec = (sts.t < spec_limit - 1e-12) \
            & (qops.next_time(eq) > spec_limit)     # no known event due
        # a neuron holding an un-emitted spike may not speculate further;
        # lanes advance independently, so only those that may are stepped
        sp_ok = can_spec & ~held_sp
        sts2, _, sp2, tsp2, _, _ = advance(
            sts, eq.t, eq.w_ampa, eq.w_gaba, spec_limit, sp_ok, iinj_v)
        sts = bdf.lane_where(sp_ok, sts2, sts)
        new_held = sp_ok & sp2
        held_sp = held_sp | new_held
        held_t = torch.where(new_held, tsp2, held_t)
        return (sts, snap, sp_ok, held_sp, held_t, eq, rec,
                n_ev + nd.sum().to(torch.int32),
                n_rs + nrs.sum().to(torch.int32), stats, rounds + 1)

    def cond(carry):
        # progress is measured on the validated clock (the snapshot's)
        sts, snap, rounds = carry[0], carry[1], carry[-1]
        return bool(snap.t.min() < t_end - 1e-9) and rounds < max_rounds \
            and not bool(sts.failed.any())

    def init_carry():
        Y = xc.batch_init(model, n)
        sts = bdf.reinit(model, 0.0, Y, iinj_v, opts)
        false = torch.zeros((n,), dtype=torch.bool, device=dev)
        z = torch.zeros((), dtype=torch.int32, device=dev)
        return (sts, sts, false, false,
                torch.zeros((n,), dtype=torch.float64, device=dev),
                qops.make(n, dev), ev.make_spike_record(n, SPK_CAP, dev),
                z, z, SpecStats.zeros(dev), 0)

    def run():
        carry = init_carry()
        while cond(carry):
            carry = round_body(carry)
        sts, snap, _, _, _, eq, rec, n_ev, n_rs, stats, rounds = carry
        res = RunResult(rec, snap.nst.sum(), n_ev, n_rs, eq.dropped,
                        sts.failed.any(), snap.zn[:, 0],
                        solver=xc.solver_stats(snap))
        return res, stats, rounds

    run.init_carry = init_carry
    run.round_body = round_body
    run.validate = validate
    run.cond = cond
    return run
