"""Fully-Asynchronous Parallel variable-step execution (method 2c), batched.

Counterpart of ``repro.core.exec_fap.make_fap_vardt_runner``.  Each
scheduler round:

  1. horizon[i] = min over in-edges (t[pre] + delay), clamped at t_end and
     t + horizon_cap -- the fused horizon kernel (K5) with
     ``horizon_impl="fused"``, an edge scatter-min with ``"scatter"``;
  2. every neuron strictly behind its horizon advances (optionally only
     the K earliest), each by its own variable-order variable-step BDF,
     clamped at min(horizon, next event) -- never speculative;
  3. spikes fan out as events (t_spike + delay) into destination queues.

The JAX runner is one ``lax.while_loop`` over rounds; here the rounds are a
host loop that checks the same ``cond`` every round.  Once every clock has
reached ``t_end - 1e-9`` or a lane failed, the loop stops, exactly where
the ``while_loop`` stops.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch import sched
from repro_torch.core import bdf
from repro_torch.core import events as ev
from repro_torch.core import exec_common as xc
from repro_torch.core.cell import CellModel
from repro_torch.core.exec_bsp import EV_CAP, SPK_CAP, RunResult, make_vardt_advance
from repro_torch.core.network import Network
from repro_torch.kernels.event_wheel import ops as ew_ops


def _later(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} comes in a later slice of the port (ROADMAP queue 1, "
        f"item {item})")


def make_fap_vardt_runner(model: CellModel, net: Network, iinj, t_end: float,
                          opts: bdf.BDFOptions = bdf.BDFOptions(),
                          eg_window: float = 0.0, horizon_cap: float = 2.0,
                          k_select: int = 0, step_budget: int = 12,
                          ev_cap: int = EV_CAP, max_rounds: int = 1_000_000,
                          queue: str = "dense", select: str = "sort",
                          horizon_impl: str = "scatter", n_bisect: int = 48,
                          batch: str = "dense", batch_cap=0,
                          fanout: str = "dense", spike_cap: int = 0,
                          device="cuda"):
    """Variable-step FAP (method 2c, the paper's reference method).

    eg_window:    0 -> precise delivery (2c-); dt/2 or dt -> grouped variants.
    k_select:     0 -> all runnable neurons advance each round; K>0 keeps
                  the K earliest (``select="sort"``).
    horizon_impl: "scatter" (edge scatter-min) or "fused" (the horizon
                  kernel over the static by-post layout).
    iinj:         injected soma current (nA), a scalar or one per neuron.
    device:       "cuda" (default; raises without a card) or "cpu".

    Returns a nullary runner ``run() -> (RunResult, rounds)`` that also
    exposes ``run.init_carry`` / ``run.round_body`` / ``run.cond``.
    """
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model lives on {model.device}, runner on {dev}")
    if batch == "compact" or batch_cap not in (0, None):
        raise _later("batch='compact' (kernel K6)", 7)
    if batch != "dense":
        raise ValueError(f"unknown batch mode {batch!r}")
    if select == "threshold":
        raise _later("select='threshold'", 7)
    if select != "sort":
        raise ValueError(f"unknown select {select!r}")
    if horizon_impl not in ("scatter", "fused"):
        raise ValueError(f"unknown horizon_impl {horizon_impl!r}")
    if spike_cap not in (0, None):
        raise _later("spike_cap (compact fan-out, kernel K7)", 7)
    n = net.n
    dnet = xc.to_device(net, dev)
    iinj_v = torch.as_tensor(iinj, dtype=torch.float64, device=dev)
    iinj_v = iinj_v.expand(n).contiguous()
    neuron_ids = torch.arange(n, dtype=torch.int64, device=dev)
    advance = make_vardt_advance(model, opts, eg_window, step_budget)
    qops = sched.get_queue_ops(queue, ev_cap=ev_cap)
    qinsert = sched.edge_insert(qops, net)
    spike_ins = xc.make_spike_insert(net, dnet, qops, qinsert, fanout)
    if horizon_impl == "fused":
        pre_byk, delay_byk = ew_ops.by_post_layout(net, dev)

    def round_body(carry):
        sts, eq, rec, n_ev, n_rs, stats, rounds = carry
        t_clock = sts.t
        if horizon_impl == "fused":
            horizon, runnable = ew_ops.fused_horizon_select(
                t_clock, pre_byk, delay_byk, t_end=t_end,
                horizon_cap=horizon_cap, n_iters=n_bisect)
        else:
            horizon = xc.horizon_times(dnet, n, t_clock, t_end,
                                       horizon_cap=horizon_cap)
            runnable = xc.runnable_mask(t_clock, horizon)
        if k_select > 0:
            # earliest-neuron-steps-next: keep only the K earliest runnable
            score = torch.where(runnable, t_clock, torch.inf)
            kth = torch.sort(score).values[min(k_select, n) - 1]
            runnable = runnable & (score <= kth)
        n_runnable = runnable.sum()

        sts, eq_t, spiked, t_sp, nd, nrs = advance(
            sts, eq.t, eq.w_ampa, eq.w_gaba, horizon, runnable, iinj_v)
        eq = eq._replace(t=eq_t)
        rec = ev.record_spikes(rec, neuron_ids, t_sp, spiked)
        if bool(spiked.any()):
            # a spike-free round inserts nothing: skipping it is identical
            eq = spike_ins(eq, spiked, t_sp)
        stats = xc.SchedStats(stats.runnable + n_runnable,
                              stats.stepped + n_runnable,
                              stats.lanes + n,
                              stats.rounds + 1)
        return (sts, eq, rec, n_ev + nd.sum().to(torch.int32),
                n_rs + nrs.sum().to(torch.int32), stats, rounds + 1)

    def cond(carry):
        sts, rounds = carry[0], carry[-1]
        return bool(sts.t.min() < t_end - 1e-9) and int(rounds) < max_rounds \
            and not bool(sts.failed.any())

    def init_carry():
        Y = xc.batch_init(model, n)
        sts = bdf.reinit(model, 0.0, Y, iinj_v, opts)
        eq = qops.make(n, dev)
        rec = ev.make_spike_record(n, SPK_CAP, dev)
        z = torch.zeros((), dtype=torch.int32, device=dev)
        return sts, eq, rec, z, z, xc.SchedStats.zeros(dev), 0

    def run():
        carry = init_carry()
        while cond(carry):
            carry = round_body(carry)
        sts, eq, rec, n_ev, n_rs, stats, rounds = carry
        return RunResult(rec, sts.nst.sum(), n_ev, n_rs, eq.dropped,
                         sts.failed.any(), sts.zn[:, 0], stats,
                         solver=xc.solver_stats(sts)), rounds

    run.init_carry = init_carry
    run.round_body = round_body
    run.cond = cond
    return run


def run_fap_vardt(*args, **kw):
    res, _ = make_fap_vardt_runner(*args, **kw)()
    return res
