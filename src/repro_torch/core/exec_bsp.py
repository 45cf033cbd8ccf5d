"""Bulk Synchronous Parallel execution models (the paper's baselines,
Fig. 1 a/b), and the variable-timestep neuron advance shared with the FAP
runner.  Counterpart of ``repro.core.exec_bsp``.

``make_bsp_fixed_runner`` -- fixed-timestep lockstep execution with a
communication window equal to the minimum synaptic delay (0.1 ms):
methods 1a (cnexp), 1b (euler), 2a (derivimplicit).

``make_bsp_vardt_runner`` -- NEURON-style BSP variable-timestep (method
2b): each neuron runs its own CVODE/BDF integrator, but a barrier clamps
every integrator at the communication-window boundary, where spikes are
exchanged.  Steps never grow beyond the 0.1 ms window, even in quiet
regimes (paper §4.3).

The JAX runners scan over windows inside one jitted call; here the
windows, and a window's fixed steps, are host loops over batched tensors.
The compact chunk loop of 2b checks ``todo.any()`` on the host, one sync
per chunk.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import sched
from repro_torch.core import bdf
from repro_torch.core import events as ev
from repro_torch.core import exec_common as xc
from repro_torch.core.cell import CellModel
from repro_torch.core.detmath import fixed_sum
from repro_torch.core.fixed_step import make_stepper
from repro_torch.core.network import Network

EV_CAP = 64
SPK_CAP = 256


class RunResult(NamedTuple):
    rec: object                # events.SpikeRecord
    n_steps: torch.Tensor      # total steps (all neurons)
    n_events: torch.Tensor     # delivered events
    n_resets: torch.Tensor     # IVP resets (vardt only)
    dropped: torch.Tensor      # event-queue overflow (must be 0)
    failed: torch.Tensor       # integrator failures (must be 0)
    y_final: torch.Tensor      # [N, n_state] (vardt: zn[:, 0])
    sched: object = None       # xc.SchedStats active-set telemetry
    comm: object = None        # transport telemetry (multi-device runners)
    solver: object = None      # solver counters summed over lanes
    health: object = None      # robustness telemetry (checkpointed drivers)


def make_vardt_advance(model: CellModel, opts: bdf.BDFOptions,
                       eg_window: float = 0.0, step_budget: int = 12):
    """Per-neuron advance to a horizon with exact (or grouped) delivery.

    Returns fn(st, eq_t, eq_a, eq_g, horizon, active, iinj)
        -> (st, eq_t, spiked, t_spike, n_deliv, n_resets)
    over all N lanes.  Non-speculative: each BDF step is clamped (tstop) at
    min(horizon, next event time).  Each of the ``step_budget`` iterations
    runs ``bdf.step_or_deliver`` on the lanes still behind their horizon
    only (the JAX version computes every lane and discards the others), so
    finished lanes never keep the attempt and Newton loops going; the loop
    stops early once no lane runs.
    """

    def advance(st: bdf.BDFState, eq_t, eq_a, eq_g, horizon, active, iinj_n):
        N = st.t.shape[0]
        dev = st.t.device
        eq_t = eq_t.clone()
        spiked = torch.zeros((N,), dtype=torch.bool, device=dev)
        t_sp = torch.zeros((N,), dtype=st.t.dtype, device=dev)
        nd = torch.zeros((N,), dtype=torch.int32, device=dev)
        nrs = torch.zeros((N,), dtype=torch.int32, device=dev)
        for _ in range(step_budget):
            run = active & (st.t < horizon - 1e-12)
            ids = run.nonzero().squeeze(1)
            if ids.numel() == 0:
                break
            whole = ids.numel() == N
            sub = st if whole else bdf.gather_lanes(st, ids)
            et = eq_t if whole else eq_t[ids]
            ea = eq_a if whole else eq_a[ids]
            eg = eq_g if whole else eq_g[ids]
            hor = horizon if whole else horizon[ids]
            inj = iinj_n if whole else iinj_n[ids]

            due = et.amin(dim=1)
            deliver_now = due <= sub.t + 1e-12
            # --- grouped delivery weights at current time -----------------
            mask = et <= (due + eg_window + 1e-12)[:, None]
            wa = fixed_sum(torch.where(mask, ea, 0.0))
            wg = fixed_sum(torch.where(mask, eg, 0.0))
            # --- fused: event reset OR one BDF step clamped at the horizon
            # / next event -------------------------------------------------
            t_lim = torch.minimum(hor, due)
            v_prev = sub.zn[:, 0, model.idx_vsoma]
            t_prev = sub.t
            sub_n = bdf.step_or_deliver(model, sub, t_lim, wa, wg, deliver_now,
                                        inj, opts)
            sp, tsp = xc.detect_spikes(v_prev, sub_n.zn[:, 0, model.idx_vsoma],
                                       t_prev, sub_n.t)
            et_n = torch.where(deliver_now[:, None] & mask, torch.inf, et)
            new_spike = ~deliver_now & sp
            n_del = torch.where(deliver_now, mask.sum(dim=1), 0).to(torch.int32)
            if whole:
                st, eq_t = sub_n, et_n
                spiked = spiked | new_spike
                t_sp = torch.where(new_spike, tsp, t_sp)
                nd = nd + n_del
                nrs = nrs + deliver_now.to(torch.int32)
            else:
                st = bdf.scatter_lanes(st, ids, sub_n)
                eq_t = eq_t.index_copy(0, ids, et_n)
                spiked = spiked.index_copy(0, ids, spiked[ids] | new_spike)
                t_sp = t_sp.index_copy(
                    0, ids, torch.where(new_spike, tsp, t_sp[ids]))
                nd = nd.index_add(0, ids, n_del)
                nrs = nrs.index_add(0, ids, deliver_now.to(torch.int32))
        return st, eq_t, spiked, t_sp, nd, nrs

    return advance


def make_bsp_fixed_runner(model: CellModel, net: Network, iinj, t_end: float,
                          method: str = "cnexp", dt: float = 0.025,
                          window: float = 0.1, ev_cap: int = EV_CAP,
                          queue: str = "dense",
                          wheel: sched.WheelSpec = sched.WheelSpec(),
                          fanout: str = "dense", spike_cap: int = 0,
                          device="cuda"):
    """Fixed-step BSP (methods 1a/1b/2a): every neuron takes the same
    fixed steps; spikes are exchanged at the end of each window of
    ``round(window / dt)`` steps.

    queue:     "dense" (slot queue) or "wheel" (bucketed event wheel).
    fanout:    "dense" or "compact" (K7 gathers the spiking lanes'
               out-edges; spike_cap <= 0 means min(N, 256)).
    iinj:      injected soma current (nA), a scalar or one per neuron.
    device:    "cuda" (default; raises without a card) or "cpu".

    Returns a nullary runner ``run() -> RunResult``.
    """
    dev = model.runner_device(device)
    n = net.n
    dnet = xc.to_device(net, dev)
    qops = sched.get_queue_ops(queue, ev_cap=ev_cap, wheel=wheel)
    qinsert = sched.edge_insert(qops, net)
    spike_ins = xc.make_spike_insert(net, dnet, qops, qinsert, fanout,
                                     spike_cap)
    steps_w = max(1, int(round(window / dt)))
    n_windows = int(math.ceil(t_end / (steps_w * dt)))
    step = make_stepper(model, method, dt, device=dev)
    iinj_v = xc.per_neuron(iinj, n, dev)
    neuron_ids = torch.arange(n, dtype=torch.int64, device=dev)
    vs = model.idx_vsoma

    def window_body(carry, w_idx):
        Y, eq, rec, n_ev = carry
        t0 = w_idx * (steps_w * dt)
        spk, tsp = [], []
        for j in range(steps_w):
            t_j = t0 + j * dt
            # deliver all events due by this step boundary (fixed-step grid)
            eq, wa, wg, cnt = qops.deliver_until(
                eq, torch.full((n,), t_j + dt, dtype=torch.float64,
                               device=dev))
            Y = model.apply_event(Y, wa, wg)
            v_prev = Y[:, vs]
            Y = step(Y, iinj_v)
            spiked, t_sp = xc.detect_spikes(v_prev, Y[:, vs], t_j, t_j + dt)
            rec = ev.record_spikes(rec, neuron_ids, t_sp, spiked)
            n_ev = n_ev + cnt.sum().to(torch.int32)
            spk.append(spiked)
            tsp.append(t_sp)
        # collective exchange at the window barrier (<= 1 spike per 0.1 ms);
        # two spikes of one neuron in a window would add their times, as
        # the reference's sum over the window's steps does
        spk, tsp = torch.stack(spk, dim=1), torch.stack(tsp, dim=1)
        spiked_w = spk.any(dim=1)
        if bool(spiked_w.any()):
            # a spike-free window inserts nothing: skipping is identical
            eq = spike_ins(eq, spiked_w, fixed_sum(torch.where(spk, tsp, 0.0)))
        return Y, eq, rec, n_ev

    def run():
        carry = (xc.batch_init(model, n), qops.make(n, dev),
                 ev.make_spike_record(n, SPK_CAP, dev),
                 torch.zeros((), dtype=torch.int32, device=dev))
        for w in range(n_windows):
            carry = window_body(carry, w)
        Y, eq, rec, n_ev = carry
        z = torch.zeros((), dtype=torch.int32, device=dev)
        return RunResult(rec, torch.tensor(n * n_windows * steps_w, device=dev),
                         n_ev, z,
                         eq.dropped, torch.zeros((), dtype=torch.bool,
                                                 device=dev), Y)

    run.n_windows = n_windows
    run.steps_per_window = steps_w
    return run


def run_bsp_fixed(*args, **kw) -> RunResult:
    return make_bsp_fixed_runner(*args, **kw)()


def make_bsp_vardt_runner(model: CellModel, net: Network, iinj, t_end: float,
                          opts: bdf.BDFOptions = bdf.BDFOptions(),
                          eg_window: float = 0.0, window: float = 0.1,
                          step_budget: int = 8, ev_cap: int = EV_CAP,
                          queue: str = "dense",
                          wheel: sched.WheelSpec = sched.WheelSpec(),
                          batch: str = "dense", batch_cap: int = 0,
                          n_bisect: int = 48, fanout: str = "dense",
                          spike_cap: int = 0, device="cuda"):
    """Method 2b: CVODE under BSP -- a barrier at every communication window.

    batch: "dense" advances all N lanes per window; "compact" gathers the
    lanes still behind the barrier into ``batch_cap``-wide batches (K6),
    earliest clocks first, advances each and scatters it back, until no
    lane is left behind.  Every lane advances once per window with the
    same barrier horizon either way, so compact equals dense event for
    event at any cap.  batch_cap <= 0 means N.

    fanout: "dense" | "compact" (K7; spike_cap <= 0 means min(N, 256)).
    device: "cuda" (default; raises without a card) or "cpu".

    Returns a nullary runner ``run() -> RunResult``.
    """
    if batch not in ("dense", "compact"):
        raise ValueError(f"unknown batch mode {batch!r}")
    dev = model.runner_device(device)
    n = net.n
    cap = n if batch_cap <= 0 else min(int(batch_cap), n)
    dnet = xc.to_device(net, dev)
    qops = sched.get_queue_ops(queue, ev_cap=ev_cap, wheel=wheel)
    qinsert = sched.edge_insert(qops, net)
    spike_ins = xc.make_spike_insert(net, dnet, qops, qinsert, fanout,
                                     spike_cap)
    n_windows = int(math.ceil(t_end / window))
    iinj_v = xc.per_neuron(iinj, n, dev)
    advance = make_vardt_advance(model, opts, eg_window, step_budget)
    neuron_ids = torch.arange(n, dtype=torch.int64, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)

    def window_body(carry, w_idx):
        sts, eq, rec, n_ev, n_rs, stats = carry
        w_end = (w_idx + 1.0) * window
        horizon = torch.full((n,), w_end, dtype=torch.float64, device=dev)
        behind = sts.t < w_end - 1e-12
        n_behind = behind.sum()
        if batch == "compact":
            spiked = torch.zeros((n,), dtype=torch.bool, device=dev)
            t_sp = torch.zeros((n,), dtype=torch.float64, device=dev)
            nd = nrs = torch.zeros((), **i32)
            stepped = torch.zeros((), dtype=torch.int64, device=dev)
            disp, todo = 0, behind
            while bool(todo.any()):
                ids, _ = xc.compact_frontier(todo, sts.t, cap, n_bisect)
                lane_ok = ids < n
                idc = torch.clamp(ids, max=n - 1).long()
                sts_b = bdf.gather_lanes(sts, idc)
                eqt_b, eqa_b, eqg_b = sched.gather_rows(eq, idc)
                sts_b, eqt_b, spk_b, tsp_b, nd_b, nrs_b = advance(
                    sts_b, eqt_b, eqa_b, eqg_b, horizon[idc], lane_ok,
                    iinj_v[idc])
                sts = xc.scatter_lanes(sts, sts_b, ids)
                eq = sched.scatter_rows(eq, ids, eqt_b)
                spiked = xc.scatter_at(spiked, ids, spk_b)
                t_sp = xc.scatter_at(t_sp, ids, tsp_b)
                todo = xc.scatter_at(todo, ids, torch.zeros_like(lane_ok))
                nd = nd + nd_b.sum().to(torch.int32)
                nrs = nrs + nrs_b.sum().to(torch.int32)
                stepped = stepped + lane_ok.sum()
                disp += 1
            stats = xc.SchedStats(stats.runnable + n_behind,
                                  stats.stepped + stepped,
                                  stats.lanes + disp * cap,
                                  stats.rounds + disp)
        else:
            active = torch.ones((n,), dtype=torch.bool, device=dev)
            sts, eq_t, spiked, t_sp, nd, nrs = advance(
                sts, eq.t, eq.w_ampa, eq.w_gaba, horizon, active, iinj_v)
            eq = eq._replace(t=eq_t)
            nd, nrs = nd.sum().to(torch.int32), nrs.sum().to(torch.int32)
            stats = xc.SchedStats(stats.runnable + n_behind,
                                  stats.stepped + n_behind,
                                  stats.lanes + n, stats.rounds + 1)
        rec = ev.record_spikes(rec, neuron_ids, t_sp, spiked)
        if bool(spiked.any()):
            # a spike-free window inserts nothing: skipping is identical
            eq = spike_ins(eq, spiked, t_sp)
        return sts, eq, rec, n_ev + nd, n_rs + nrs, stats

    def init_carry():
        Y = xc.batch_init(model, n)
        sts = bdf.reinit(model, 0.0, Y, iinj_v, opts)
        z = torch.zeros((), **i32)
        return (sts, qops.make(n, dev), ev.make_spike_record(n, SPK_CAP, dev),
                z, z, xc.SchedStats.zeros(dev))

    def pack(c, w):
        sts, eq, rec, n_ev, n_rs, stats = c
        return xc.SimCarry(sts, eq, rec, (), {
            "n_ev": n_ev, "n_rs": n_rs, "stats": stats, "rounds": w})

    def step_fn(sc):
        c = window_body((sc.sts, sc.eq, sc.rec, sc.counters["n_ev"],
                         sc.counters["n_rs"], sc.counters["stats"]),
                        sc.counters["rounds"])
        return pack(c, sc.counters["rounds"] + 1)

    def run(checkpoint_every: int = 0, ckpt_dir=None, resume: bool = False,
            fault=None, watchdog=None, max_rollbacks: int = 2,
            ckpt_keep: int = 3) -> RunResult:
        """Run every window.  With no knob set, the host loop over
        ``window_body``; any robustness knob runs the same windows under
        ``exec_common.run_checkpointed``, the window index in
        ``counters["rounds"]`` (the knobs as in ``make_fap_vardt_runner``'s
        ``run``): killed-and-resumed and rolled-back runs are bitwise the
        plain run, and ``RunResult.health`` records what happened."""
        health = None
        if not (checkpoint_every or resume or watchdog or fault is not None):
            sc = pack(init_carry(), 0)
            while sc.counters["rounds"] < n_windows:
                sc = step_fn(sc)
        else:
            sc, health = xc.run_checkpointed(
                lambda: pack(init_carry(), 0), step_fn,
                lambda sc: sc.counters["rounds"] < n_windows,
                ckpt_dir=ckpt_dir, checkpoint_every=checkpoint_every,
                resume=resume, keep=ckpt_keep, fault=fault,
                health_of=((lambda sc, t_prev: xc.health_check(sc.sts,
                                                               t_prev))
                           if watchdog is None or watchdog else None),
                max_rollbacks=max_rollbacks)
            health["dropped_events"] = int(sc.eq.dropped)
        sts = sc.sts
        failed = sts.failed.any()
        if health is not None:
            failed = failed | health["rollback_exhausted"]
        return RunResult(sc.rec, sts.nst.sum(), sc.counters["n_ev"],
                         sc.counters["n_rs"], sc.eq.dropped, failed,
                         sts.zn[:, 0], sc.counters["stats"],
                         solver=xc.solver_stats(sts), health=health)

    return run


def run_bsp_vardt(*args, **kw) -> RunResult:
    return make_bsp_vardt_runner(*args, **kw)()
