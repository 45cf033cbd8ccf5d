"""Fully-Asynchronous Parallel execution models, batched.  Counterpart of
``repro.core.exec_fap``.

``make_fap_fixed_runner`` -- method 1c: fixed-timestep FAP from the
authors' previous work: per-neuron clocks advance by whole fixed steps to
the pairwise dependency horizon; no global barrier.

``make_fap_vardt_runner`` -- method 2c (the paper's contribution):
non-speculative scheduled variable-timestep stepping.  Each round:

  1. horizon[i] = min over in-edges (t[pre] + delay), clamped at t_end and
     t + horizon_cap -- the fused horizon kernel (K5) with
     ``horizon_impl="fused"``, an edge scatter-min with ``"scatter"``;
  2. every neuron strictly behind its horizon advances (optionally only
     the K earliest), each by its own variable-order variable-step BDF,
     clamped at min(horizon, next event) -- never speculative;
  3. spikes fan out as events (t_spike + delay) into destination queues.

The active-set knobs (``batch="compact"``, ``fanout="compact"``,
``queue="wheel"``, ``select="threshold"``, the auto caps and the
incremental horizon) make a round's cost follow activity; on a card they
run the compaction (K6), compact-gather (K7) and segment-rank (K8)
kernels.

The JAX runners are one ``lax.while_loop`` over rounds; here the rounds are
a host loop that checks the same ``cond`` every round (one sync per
round), and stops exactly where the ``while_loop`` stops.  The inner loop
of 1c always runs ``round_cap_steps`` masked iterations, as the JAX
``fori_loop`` does, so it needs no sync of its own.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import sched
from repro_torch.core import bdf
from repro_torch.core import events as ev
from repro_torch.core import exec_common as xc
from repro_torch.core.cell import CellModel
from repro_torch.core.detmath import fma
from repro_torch.core.exec_bsp import (EV_CAP, SPK_CAP, RunResult,
                                       make_vardt_advance)
from repro_torch.core.fixed_step import make_stepper
from repro_torch.core.network import Network, tile_network
from repro_torch.kernels.event_wheel import ops as ew_ops


class _Lanes(NamedTuple):
    """What a round needs of the network its lanes hold: the device edge
    list, the spike insert, the by-post layout of the fused or the
    incremental horizon (None otherwise), the incremental horizon's
    out-neighbour table (None otherwise) and the lane ids."""
    dnet: xc.DeviceNet
    spike_ins: Callable
    pre_byk: Optional[torch.Tensor]
    delay_byk: Optional[torch.Tensor]
    out_post: Optional[torch.Tensor]
    ids: torch.Tensor


def _count(x, rows, dtype):
    """The sum of ``x`` over all lanes (``rows`` None), or per tenant: one
    sum per each of ``rows`` equal blocks of lanes."""
    s = x.sum() if rows is None else x.reshape(rows, -1).sum(dim=1)
    return s.to(dtype)


def _map_lanes(carry, fn, horizon: bool = False):
    """``carry`` with ``fn`` applied to each per-lane leaf (the BDF state,
    the queue's slot planes, the record's times and counts, and with
    ``horizon`` the incremental horizon that follows them); the queue's
    ``dropped``, the record's ``overflow`` and the counters stay."""
    sts, eq, rec = carry[:3]
    rest = tuple(carry[3:])
    if horizon:
        rest = (fn(rest[0]),) + rest[1:]
    return (type(sts)(*[fn(x) for x in sts]),
            eq._replace(t=fn(eq.t), w_ampa=fn(eq.w_ampa),
                        w_gaba=fn(eq.w_gaba)),
            rec._replace(times=fn(rec.times), count=fn(rec.count))) + rest


def fixed_steps_below(horizon, t_clock, dt: float, cap: int):
    """Whole fixed steps of size dt below the horizon, clipped to [0, cap]:
    ``floor((horizon - t_clock) / dt + 1e-9)``.  Inside ``jax.jit`` XLA
    multiplies by the reciprocal ``1 / dt`` and its CPU backend contracts
    the product and the ``+ 1e-9`` into one fused multiply-add; an ulp
    there moves the floor, so this computes the same fused value."""
    x = fma(horizon - t_clock, 1.0 / dt, 1e-9)
    return torch.clamp(torch.floor(x), 0, cap).to(torch.int32)


def make_fap_fixed_runner(model: CellModel, net: Network, iinj, t_end: float,
                          method: str = "cnexp", dt: float = 0.025,
                          round_cap_steps: int = 16, ev_cap: int = EV_CAP,
                          max_rounds: int = 2_000_000, queue: str = "dense",
                          wheel: sched.WheelSpec = sched.WheelSpec(),
                          fanout: str = "dense", spike_cap: int = 0,
                          device="cuda"):
    """Fixed-step FAP (method 1c).  Each round every neuron takes the whole
    fixed steps its dependency horizon allows, at most
    ``round_cap_steps``; the round's spikes then fan out.

    queue / fanout / spike_cap as in ``exec_bsp.make_bsp_fixed_runner``.
    device: "cuda" (default; raises without a card) or "cpu".

    Returns a nullary runner ``run() -> (RunResult, rounds)``.
    """
    dev = model.runner_device(device)
    n = net.n
    dnet = xc.to_device(net, dev)
    qops = sched.get_queue_ops(queue, ev_cap=ev_cap, wheel=wheel)
    qinsert = sched.edge_insert(qops, net)
    spike_ins = xc.make_spike_insert(net, dnet, qops, qinsert, fanout,
                                     spike_cap)
    step = make_stepper(model, method, dt, device=dev)
    iinj_v = xc.per_neuron(iinj, n, dev)
    neuron_ids = torch.arange(n, dtype=torch.int64, device=dev)
    n_total_steps = int(round(t_end / dt))
    vs = model.idx_vsoma

    def round_body(carry):
        Y, k, eq, rec, n_ev, n_st, rounds = carry
        t_clock = k.to(torch.float64) * dt
        horizon = xc.horizon_times(dnet, n, t_clock, t_end)
        n_adv = fixed_steps_below(horizon, t_clock, dt, round_cap_steps)
        spiked_r = torch.zeros((n,), dtype=torch.bool, device=dev)
        t_sp_r = torch.zeros((n,), dtype=torch.float64, device=dev)
        for j in range(round_cap_steps):
            act = j < n_adv
            t_j = k.to(torch.float64) * dt
            eq, wa, wg, cnt = qops.deliver_until(
                eq, torch.where(act, t_j + dt, -torch.inf))
            Y2 = model.apply_event(Y, wa, wg)
            v_prev = Y2[:, vs]
            Y2 = step(Y2, iinj_v)
            sp, tsp = xc.detect_spikes(v_prev, Y2[:, vs], t_j, t_j + dt)
            sp = sp & act
            Y = torch.where(act[:, None], Y2, Y)
            k = torch.where(act, k + 1, k)
            spiked_r = spiked_r | sp
            t_sp_r = torch.where(sp, tsp, t_sp_r)
            rec = ev.record_spikes(rec, neuron_ids, tsp, sp)
            n_ev = n_ev + cnt.sum().to(torch.int32)
            n_st = n_st + act.sum().to(torch.int32)
        if bool(spiked_r.any()):
            # a spike-free round inserts nothing: skipping is identical
            eq = spike_ins(eq, spiked_r, t_sp_r)
        return Y, k, eq, rec, n_ev, n_st, rounds + 1

    def cond(carry):
        k, rounds = carry[1], carry[-1]
        return int(k.min()) < n_total_steps and rounds < max_rounds

    def init_carry():
        z = torch.zeros((), dtype=torch.int32, device=dev)
        return (xc.batch_init(model, n),
                torch.zeros((n,), dtype=torch.int32, device=dev),
                qops.make(n, dev), ev.make_spike_record(n, SPK_CAP, dev),
                z, z, 0)

    def run():
        carry = init_carry()
        while cond(carry):
            carry = round_body(carry)
        Y, _, eq, rec, n_ev, n_st, rounds = carry
        z = torch.zeros((), dtype=torch.int32, device=dev)
        return RunResult(rec, n_st, n_ev, z, eq.dropped,
                         torch.zeros((), dtype=torch.bool, device=dev),
                         Y), rounds

    return run


def run_fap_fixed(*args, **kw) -> RunResult:
    res, _ = make_fap_fixed_runner(*args, **kw)()
    return res


def make_fap_vardt_runner(model: CellModel, net: Network, iinj, t_end: float,
                          opts: bdf.BDFOptions = bdf.BDFOptions(),
                          eg_window: float = 0.0, horizon_cap: float = 2.0,
                          k_select: int = 0, step_budget: int = 12,
                          ev_cap: int = EV_CAP, max_rounds: int = 1_000_000,
                          queue: str = "dense",
                          wheel: sched.WheelSpec = sched.WheelSpec(),
                          select: str = "sort", horizon_impl: str = "scatter",
                          n_bisect: int = 48, batch: str = "dense",
                          batch_cap=0, fanout: str = "dense", spike_cap=0,
                          probe_t: float = 5.0, device="cuda"):
    """Variable-step FAP (method 2c, the paper's reference method).

    eg_window:    0 -> precise delivery (2c-); dt/2 or dt -> grouped variants.
    k_select:     0 -> all runnable neurons advance each round; K>0 keeps
                  the K earliest.
    queue:        "dense" (slot queue) or "wheel" (bucketed event wheel,
                  geometry ``wheel``; its batch insert ranks with K8).
    select:       "sort" (kth of a sort) or "threshold" (bisection on
                  counts; inside ``fused_horizon_select`` under "fused").
    horizon_impl: "scatter" (edge scatter-min) or "fused" (the horizon
                  kernel K5 over the static by-post layout).
    batch:        "dense" advances over all N lanes; "compact" compacts the
                  runnable mask (K6) into a [batch_cap] gather-id batch,
                  advances only that batch and scatters it back.  When the
                  frontier overflows the cap the earliest clocks are kept
                  (the globally earliest lane always) and the rest roll to
                  later rounds.  batch_cap <= 0 means N; "auto" runs a
                  short dense probe (min(t_end, probe_t) ms) and picks the
                  cap from its frontier telemetry (``run.batch_cap``).
                  Under "compact" with the "scatter" horizon on a grouped
                  net the horizon is kept incrementally: only rows fed by
                  a moved clock are recomputed (bitwise equal to the full
                  scatter-min, min being exact); it rides the round carry.
    fanout:       "dense" fans every spike over all E edges; "compact"
                  gathers only the <= spike_cap spiking lanes' out-edges
                  (K7) and inserts that batch; more spikes fall back to the
                  dense branch.  spike_cap <= 0 means the batch cap under
                  batch="compact", else min(N, 256); "auto" sizes it from
                  the probe's spike rate (``run.spike_cap``).
    iinj:         injected soma current (nA), a scalar or one per neuron.
    device:       "cuda" (default; raises without a card) or "cpu".

    Returns a runner ``run(**robustness) -> (RunResult, rounds)`` (the
    knobs are in ``run``'s docstring) that also exposes
    ``run.init_carry`` / ``run.round_body`` / ``run.cond``, the
    ``SimCarry`` packing ``run.pack`` / ``run.unpack`` and the service's
    ``run.tenant_round``.
    """
    dev = model.runner_device(device)
    n = net.n
    if batch not in ("dense", "compact"):
        raise ValueError(f"unknown batch mode {batch!r}")
    if select not in ("sort", "threshold"):
        raise ValueError(f"unknown select {select!r}")
    if horizon_impl not in ("scatter", "fused"):
        raise ValueError(f"unknown horizon_impl {horizon_impl!r}")
    if batch_cap == "auto" or spike_cap == "auto":
        # one dense probe run serves both auto caps
        probe = make_fap_vardt_runner(
            model, net, iinj, min(t_end, probe_t), opts=opts,
            eg_window=eg_window, horizon_cap=horizon_cap,
            k_select=k_select, step_budget=step_budget, ev_cap=ev_cap,
            max_rounds=max_rounds, queue=queue, wheel=wheel, select=select,
            horizon_impl=horizon_impl, n_bisect=n_bisect, device=dev)
        pres, _ = probe()
        if batch_cap == "auto":
            batch_cap = xc.auto_batch_cap(pres.sched, n)
        if spike_cap == "auto":
            spike_cap = xc.auto_spike_cap(pres.rec, pres.sched, n)
    cap = n if batch_cap <= 0 else min(int(batch_cap), n)
    s_cap = spike_cap if spike_cap > 0 else \
        (cap if batch == "compact" else min(n, 256))
    dnet = xc.to_device(net, dev)
    iinj_v = xc.per_neuron(iinj, n, dev)
    neuron_ids = torch.arange(n, dtype=torch.int64, device=dev)
    advance = make_vardt_advance(model, opts, eg_window, step_budget)
    qops = sched.get_queue_ops(queue, ev_cap=ev_cap, wheel=wheel)
    qinsert = sched.edge_insert(qops, net)
    if horizon_impl == "fused":
        pre_byk, delay_byk = ew_ops.by_post_layout(net, dev)
    # incremental horizon: compact + scatter impl + grouped net
    incremental = (batch == "compact" and horizon_impl == "scatter"
                   and sched.grouped_k(net) is not None)
    edge_tbl = out_post = None
    if incremental or fanout == "compact":
        post_np, edge_np = xc.out_tables(net)     # one grouping pass serves
        edge_tbl = edge_np                        # horizon and fan-out
    if incremental:
        pre_byk, delay_byk = ew_ops.by_post_layout(net, dev)
        out_post = torch.as_tensor(post_np, dtype=torch.int64, device=dev)
    spike_ins = xc.make_spike_insert(net, dnet, qops, qinsert, fanout, s_cap,
                                     edge_table=edge_tbl)

    def _horizon_rows(ln, t_clock, p):
        """Horizon of the (sentinel-padded) post set ``p`` from the current
        clocks: the min/clamp chain of the full scatter-min."""
        pc = torch.clamp(p, max=t_clock.shape[0] - 1)
        cand = t_clock[ln.pre_byk[:, pc].long()] + ln.delay_byk[:, pc]
        hor_p = torch.clamp(cand.amin(dim=0), max=t_end)
        return torch.minimum(hor_p, t_clock[pc] + horizon_cap)

    def _insert_spikes(ln, eq, spiked_b, tsp_b, ids):
        nl = ln.ids.shape[0]
        spiked = xc.scatter_at(torch.zeros((nl,), dtype=torch.bool,
                                           device=dev), ids, spiked_b)
        t_sp = xc.scatter_at(torch.zeros((nl,), dtype=torch.float64,
                                         device=dev), ids, tsp_b)
        return ln.spike_ins(eq, spiked, t_sp)

    lanes0 = _Lanes(dnet, spike_ins,
                    pre_byk if horizon_impl == "fused" or incremental
                    else None,
                    delay_byk if horizon_impl == "fused" or incremental
                    else None, out_post, neuron_ids)

    def _round(carry, iinj_r, ln=lanes0, rows=None, active=None, k_qos=None):
        """One scheduler round over the lanes of ``ln``: the runner's own
        network, or (``tenant_round``) ``rows`` tenants' copies of it side
        by side, where every selection and count is taken per tenant,
        ``active`` bool[rows] masks whole tenants out and ``k_qos``
        i64[rows] restricts each tenant to its earliest k runnable lanes
        (<= 0: no restriction)."""
        R = rows or 1
        if incremental:
            sts, eq, rec, horizon, n_ev, n_rs, stats, rounds = carry
        else:
            sts, eq, rec, n_ev, n_rs, stats, rounds = carry
        t_clock = sts.t
        if incremental:
            runnable = xc.runnable_mask(t_clock, horizon)
        elif horizon_impl == "fused":
            horizon, runnable = ew_ops.fused_horizon_select(
                t_clock, ln.pre_byk, ln.delay_byk, t_end=t_end,
                horizon_cap=horizon_cap, n_iters=n_bisect,
                k_select=k_select if select == "threshold" else 0, rows=R)
        else:
            horizon = xc.horizon_times(ln.dnet, t_clock.shape[0], t_clock,
                                       t_end, horizon_cap=horizon_cap)
            runnable = xc.runnable_mask(t_clock, horizon)
        if k_select > 0 and select == "threshold" and \
                (incremental or horizon_impl == "scatter"):
            score = torch.where(runnable, t_clock, torch.inf).reshape(R, -1)
            tau = ew_ops.select_threshold(score, k_select, n_iters=n_bisect)
            runnable = runnable & (score <= tau[:, None]).reshape(-1)
        if k_select > 0 and select == "sort":
            # earliest-neuron-steps-next: keep only the K earliest runnable
            score = torch.where(runnable, t_clock, torch.inf).reshape(R, -1)
            kth = torch.sort(score, dim=1).values[:, min(k_select, n) - 1]
            runnable = runnable & (score <= kth[:, None]).reshape(-1)
        if active is not None:
            # an inactive tenant advances nothing
            runnable = runnable & active.repeat_interleave(n)
        if k_qos is not None:
            # each tenant's QoS cap: its k_qos earliest runnable lanes
            score = torch.where(runnable, t_clock, torch.inf).reshape(R, n)
            k_eff = torch.where(k_qos > 0, torch.clamp(k_qos, max=n), n)
            tau = ew_ops.select_threshold(score, k_eff, n_iters=n_bisect)
            runnable = runnable & (score <= tau[:, None]).reshape(-1)
        n_runnable = _count(runnable, rows, torch.int64)

        if batch == "compact":
            # compact -> step -> scatter: only the frontier pays the step;
            # with tenants each row compacts its own lanes into its own
            # [cap] batch (K6's rows form), offset to its block of lanes
            NL = R * n
            if rows is None:
                ids, _ = xc.compact_frontier(runnable, t_clock, cap,
                                             n_bisect)
            else:
                ids_t, _ = xc.compact_frontier(runnable.reshape(R, n),
                                               t_clock.reshape(R, n), cap,
                                               n_bisect)
                base = torch.arange(R, dtype=ids_t.dtype,
                                    device=dev)[:, None] * n
                ids = torch.where(ids_t < n, ids_t + base, NL).reshape(-1)
            lane_ok = ids < NL
            idc = torch.clamp(ids, max=NL - 1).long()
            sts_b = bdf.gather_lanes(sts, idc)
            t_b_prev = sts_b.t
            eqt_b, eqa_b, eqg_b = sched.gather_rows(eq, idc)
            sts_b, eqt_b, spiked_b, tsp_b, nd, nrs = advance(
                sts_b, eqt_b, eqa_b, eqg_b, horizon[idc], lane_ok,
                iinj_r[idc])
            sts = xc.scatter_lanes(sts, sts_b, ids)
            eq = sched.scatter_rows(eq, ids, eqt_b)
            rec = ev.record_spikes(rec, ids, tsp_b, spiked_b)
            if bool(spiked_b.any()):
                # a spike-free round inserts nothing: skipping is identical
                eq = _insert_spikes(ln, eq, spiked_b, tsp_b, ids)
            if incremental:
                # only rows fed by a moved clock can change: the batch's
                # out-neighbours, plus the batch lanes' own cap terms
                moved = lane_ok & (sts_b.t != t_b_prev)
                outp = torch.where(moved[:, None], ln.out_post[idc], NL)
                p = torch.cat([ids.long(), outp.reshape(-1)])
                # rows past the lanes go to a dump slot; a row listed twice
                # gets the same value from each writer
                hor = torch.cat([horizon, horizon.new_zeros(1)])
                hor[torch.clamp(p, max=NL)] = _horizon_rows(ln, sts.t, p)
                horizon = hor[:NL]
            stats = xc.SchedStats(stats.runnable + n_runnable,
                                  stats.stepped + _count(lane_ok, rows,
                                                         torch.int64),
                                  stats.lanes + cap,
                                  stats.rounds + 1)
        else:
            sts, eq_t, spiked, t_sp, nd, nrs = advance(
                sts, eq.t, eq.w_ampa, eq.w_gaba, horizon, runnable, iinj_r)
            eq = eq._replace(t=eq_t)
            rec = ev.record_spikes(rec, ln.ids, t_sp, spiked)
            if bool(spiked.any()):
                # a spike-free round inserts nothing: skipping is identical
                eq = ln.spike_ins(eq, spiked, t_sp)
            stats = xc.SchedStats(stats.runnable + n_runnable,
                                  stats.stepped + n_runnable,
                                  stats.lanes + n,
                                  stats.rounds + 1)
        out = (sts, eq, rec, n_ev + _count(nd, rows, torch.int32),
               n_rs + _count(nrs, rows, torch.int32), stats, rounds + 1)
        if incremental:
            out = out[:3] + (horizon,) + out[3:]
        return out


    def round_body(carry):
        return _round(carry, iinj_v)

    tiled = {}

    def _tenant_lanes(T):
        """The lanes of T tenants' networks side by side (built once per
        T): ``network.tile_network``'s edge tables, spike insert (the
        compact fan-out decided per tenant), by-post layout and
        out-neighbour table."""
        if T not in tiled:
            tnet = tile_network(net, T)
            tdnet = xc.to_device(tnet, dev)
            ins = xc.make_spike_insert(tnet, tdnet, qops,
                                       sched.edge_insert(qops, tnet), fanout,
                                       s_cap, edge_table=edge_tbl, rows=T)
            pb, db = ew_ops.by_post_layout(tnet, dev) \
                if horizon_impl == "fused" or incremental else (None, None)
            op = torch.as_tensor(xc.out_post_table(tnet), dtype=torch.int64,
                                 device=dev) if incremental else None
            tiled[T] = _Lanes(tdnet, ins, pb, db, op,
                              torch.arange(T * n, dtype=torch.int64,
                                           device=dev))
        return tiled[T]

    def tenant_round(carry, iinj, active, k_qos=0):
        """One round of T tenants at once, the unit ``repro_torch.serve``
        drives (JAX vmaps ``_round`` over the tenant axis).

        ``carry`` is a batched carry (``serve.stack_lanes`` of
        ``init_carry`` carries): every leaf has a leading [T] axis, the
        queue's ``dropped``, the record's ``overflow`` and the counters are
        [T].  ``iinj`` [T] (or [T, N]) the tenants' currents, ``active``
        bool[T] masks tenants out (their state is untouched; their
        ``rounds`` and ``stats`` still count, as under JAX's vmap),
        ``k_qos`` i64[T] caps each tenant's frontier to its earliest k
        lanes (<= 0: no cap).  The T networks run as T*N lanes of one round
        over ``network.tile_network``'s tables: each lane's step is the
        one it takes alone, and every selection, reduction and counter is
        taken per tenant, so a tenant's trajectory does not depend on its
        neighbours.  Under the active-set knobs each tenant has its own
        [batch_cap] batch (K6's rows form), its own compact fan-out or
        dense fallback (K7's rows form: a tenant with more than
        ``spike_cap`` spikes takes the dense insert of its own rows) and,
        under the scatter horizon, its own incremental horizon, a [T, N]
        leaf of the carry."""
        T = int(carry[0].t.shape[0])
        i_lanes = torch.as_tensor(iinj, dtype=torch.float64, device=dev) \
            .reshape(T, -1).expand(T, n).reshape(-1)
        act = torch.as_tensor(active, dtype=torch.bool, device=dev)
        kq = torch.as_tensor(k_qos, dtype=torch.int64, device=dev).expand(T)
        flat = _map_lanes(carry, lambda x: x.reshape((-1,) + x.shape[2:]),
                          incremental)
        out = _round(flat, i_lanes, _tenant_lanes(T), T, act.reshape(T), kq)
        return _map_lanes(out, lambda x: x.reshape((T, -1) + x.shape[1:]),
                          incremental)

    def cond(carry):
        sts, rounds = carry[0], carry[-1]
        return bool(sts.t.min() < t_end - 1e-9) and int(rounds) < max_rounds \
            and not bool(sts.failed.any())

    def init_carry(iinj=None):
        """Fresh round-0 carry; ``iinj`` overrides the construction-time
        current (a tenant's, in ``repro_torch.serve``)."""
        iv = iinj_v if iinj is None else xc.per_neuron(iinj, n, dev)
        Y = xc.batch_init(model, n)
        sts = bdf.reinit(model, 0.0, Y, iv, opts)
        eq = qops.make(n, dev)
        rec = ev.make_spike_record(n, SPK_CAP, dev)
        z = torch.zeros((), dtype=torch.int32, device=dev)
        carry = sts, eq, rec, z, z, xc.SchedStats.zeros(dev), 0
        if incremental:
            hor0 = xc.horizon_times(dnet, n, sts.t, t_end,
                                    horizon_cap=horizon_cap)
            carry = carry[:3] + (hor0,) + carry[3:]
        return carry

    # the round carry <-> SimCarry: hcarry holds the incremental horizon,
    # the counters ride a dict, so a checkpoint holds the whole round state
    def pack(c):
        if incremental:
            sts, eq, rec, horizon, n_ev, n_rs, stats, rounds = c
            h = (horizon,)
        else:
            sts, eq, rec, n_ev, n_rs, stats, rounds = c
            h = ()
        return xc.SimCarry(sts, eq, rec, h, {
            "n_ev": n_ev, "n_rs": n_rs, "stats": stats, "rounds": rounds})

    def unpack(sc):
        c = (sc.sts, sc.eq, sc.rec, sc.counters["n_ev"],
             sc.counters["n_rs"], sc.counters["stats"],
             sc.counters["rounds"])
        return c[:3] + tuple(sc.hcarry) + c[3:] if incremental else c

    def _result(sc, health=None):
        sts = sc.sts
        failed = sts.failed.any()
        if health is not None:
            failed = failed | health["rollback_exhausted"]
        return RunResult(sc.rec, sts.nst.sum(), sc.counters["n_ev"],
                         sc.counters["n_rs"], sc.eq.dropped, failed,
                         sts.zn[:, 0], sc.counters["stats"],
                         solver=xc.solver_stats(sts), health=health)

    def run(checkpoint_every: int = 0, ckpt_dir=None, resume: bool = False,
            fault=None, watchdog=None, max_rollbacks: int = 2,
            ckpt_keep: int = 3):
        """Run to t_end: (RunResult, rounds).

        With no knob set, the host loop over ``round_body``.  Any knob runs
        the same rounds under ``exec_common.run_checkpointed``:
        ``checkpoint_every=k`` snapshots the whole round state
        (``SimCarry``) into ``ckpt_dir`` every k rounds (the ``ckpt_keep``
        newest kept), ``resume=True`` restarts from the latest complete
        snapshot, ``fault`` (``checkpoint.FaultPlan``) kills or poisons at
        a round boundary, and the watchdog (on unless ``watchdog=False``)
        checks every round and rolls a non-finite state back to the last
        snapshot, at most ``max_rollbacks`` times (then ``failed``).  The
        rounds are the plain run's, so a killed-and-resumed or rolled-back
        run is bitwise equal to it; ``RunResult.health`` records what
        happened."""
        if not (checkpoint_every or resume or watchdog or fault is not None):
            carry = init_carry()
            while cond(carry):
                carry = round_body(carry)
            return _result(pack(carry)), carry[-1]
        health_of = None
        if watchdog is None or watchdog:
            def health_of(sc, t_prev):
                return xc.health_check(
                    sc.sts, t_prev,
                    horizon=sc.hcarry[0] if incremental else None,
                    horizon_cap=horizon_cap)

        sc, health = xc.run_checkpointed(
            lambda: pack(init_carry()),
            lambda sc: pack(round_body(unpack(sc))),
            lambda sc: cond(unpack(sc)),
            ckpt_dir=ckpt_dir, checkpoint_every=checkpoint_every,
            resume=resume, keep=ckpt_keep, fault=fault,
            health_of=health_of, max_rollbacks=max_rollbacks)
        health["dropped_events"] = int(sc.eq.dropped)
        return _result(sc, health), sc.counters["rounds"]

    run.init_carry = init_carry
    run.round_body = round_body
    run.tenant_round = tenant_round
    run.cond = cond
    run.pack = pack
    run.unpack = unpack
    run.incremental = incremental
    run.batch_cap = cap
    run.spike_cap = s_cap
    run.wheel = wheel if queue == "wheel" else None
    return run


def run_fap_vardt(*args, **kw):
    res, _ = make_fap_vardt_runner(*args, **kw)()
    return res
