"""Shared pieces of the execution models: spike detection, synaptic
fan-out (dense and compact), the dependency horizon, active-set compaction,
batched state initialisation and device-side network arrays.  Counterpart
of ``repro.core.exec_common``."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bdf
from repro_torch.core import events as ev
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


def per_neuron(x, n: int, device):
    """A scalar or per-neuron float64 input as a contiguous f64[n]."""
    return torch.as_tensor(x, dtype=torch.float64,
                           device=device).expand(n).contiguous()


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
                  t_table=None, horizon_cap=None):
    """FAP dependency horizon: t_max[i] = min over in-edges (t[pre]+delay),
    a scatter-min over the static edge list.  Neurons without in-edges get
    t_end.

    The shard-local SPMD round (``repro_torch.distributed.fap_spmd``)
    passes its local edge slice with the shard-relative post index in
    ``dnet.post`` and the notify clock table as ``t_table``: ``dnet.pre``
    then indexes the global table while ``t_clock`` (the cap term) stays
    shard-local.  ``t_table`` defaults to ``t_clock``."""
    tt = t_clock if t_table is None else t_table
    cand = tt[dnet.pre] + dnet.delay
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


def select_active(runnable, t_clock, cap: int, n_iters: int = 48):
    """Earliest-``cap`` restriction of the runnable frontier, sort-free
    (``select_threshold`` bisection on counts), along the last axis (each
    row of a [T, N] mask on its own).  With ``cap`` or fewer runnable the
    mask comes back unchanged; the globally earliest runnable neuron is
    always kept."""
    from repro_torch.kernels.event_wheel import ops as ew_ops
    score = torch.where(runnable, t_clock, torch.inf)
    tau = ew_ops.select_threshold(score, cap, n_iters=n_iters)
    return runnable & (score <= tau[..., None])


def out_tables(net):
    """Host-side by-pre grouping of the static edge list: per neuron i the
    postsynaptic targets (sentinel N) and edge-list positions (sentinel E)
    of its out-edges, padded to the max out-degree -- array-identical to
    ``repro.core.exec_common.out_tables``."""
    pre = np.asarray(net.pre)
    post = np.asarray(net.post)
    n, E = int(net.n), int(pre.shape[0])
    deg = np.bincount(pre, minlength=n)
    mo = int(deg.max()) if E else 1
    order = np.argsort(pre, kind="stable")
    starts = np.zeros(n + 1, np.int64)
    starts[1:] = np.cumsum(deg)
    rank_in_pre = np.arange(E) - starts[pre[order]]
    post_t = np.full((n, mo), n, np.int32)
    post_t[pre[order], rank_in_pre] = post[order]
    edge_t = np.full((n, mo), E, np.int32)
    edge_t[pre[order], rank_in_pre] = order
    return post_t, edge_t


def out_post_table(net) -> np.ndarray:
    """Row i: postsynaptic targets of neuron i's out-edges, sentinel N (the
    incremental horizon's moved-row lookup)."""
    return out_tables(net)[0]


def out_edge_table(net) -> np.ndarray:
    """Row i: edge-list positions of neuron i's out-edges, sentinel E (the
    compact fan-out's gather table)."""
    return out_tables(net)[1]


def make_spike_insert(net, dnet: DeviceNet, qops, qinsert,
                      fanout: str = "dense", spike_cap: int = 256,
                      edge_table=None, rows: int = 1):
    """The fan-out + insert stage: ``fn(eq, spiked[N], t_spike[N]) -> eq``
    (at most one spike per neuron per call).

    ``dense``   -- all E edges through the net's best insert.
    ``compact`` -- the compact-gather kernel (K7) emits the spiked
                   lanes' out-edge ids (``out_edge_table`` rows) and their
                   count; when at most ``spike_cap`` lanes spiked, the
                   fixed [spike_cap * MO] batch goes through the queue's
                   batch insert, and more spikes fall back to the dense
                   branch (the same events, never a drop).

    ``rows`` > 1: ``net`` is ``rows`` copies of one network side by side
    (``network.tile_network``: the tenants of ``exec_fap``'s
    ``tenant_round``) and ``edge_table`` is one copy's out-edge table.
    The compact fan-out then decides per copy, as JAX's ``vmap`` of the
    one-copy ``lax.cond`` does: K7's rows form compacts every copy's
    spikes against the one table, copies with 1..``spike_cap`` spikes
    insert their batches (edge ids offset into the tiled edge list) and
    copies with more take the dense insert of their own rows.  Each copy's
    rows get exactly the events and slots of its own one-copy call.
    """
    if fanout not in ("dense", "compact"):
        raise ValueError(f"unknown fanout mode {fanout!r}")

    def dense_ins(eq, spiked, t_sp):
        tgt, t_ev, wa, wg, valid = fanout_edges(dnet, spiked, t_sp)
        return qinsert(eq, tgt, t_ev, wa, wg, valid)

    if fanout == "dense":
        return dense_ins

    from repro_torch.kernels.event_wheel import ops as ew_ops
    n, E = int(net.n) // rows, int(dnet.pre.shape[0]) // rows
    cap = min(int(spike_cap), n) if spike_cap > 0 else min(n, 256)
    if rows > 1 and edge_table is None:
        raise ValueError("the rows form needs one copy's edge_table")
    edge_tbl = torch.as_tensor(
        out_edge_table(net) if edge_table is None else edge_table,
        dtype=torch.int32, device=dnet.pre.device).contiguous()

    def compact_ins(eq, ids, eids, t_sp):
        idc = torch.clamp(ids, max=n - 1).long()
        ok = (ids < n)[:, None] & (eids < E)                  # [cap, MO]
        eidc = torch.clamp(eids, max=E - 1).long()
        t_ev = t_sp[idc][:, None] + dnet.delay[eidc]
        return qops.insert_batch(eq, dnet.post[eidc].reshape(-1),
                                 t_ev.reshape(-1),
                                 dnet.w_ampa[eidc].reshape(-1),
                                 dnet.w_gaba[eidc].reshape(-1),
                                 ok.reshape(-1))

    def ins(eq, spiked, t_sp):
        ids, eids, cnt = ew_ops.compact_gather(spiked, edge_tbl, cap, fill=E)
        if int(cnt) > cap:
            return dense_ins(eq, spiked, t_sp)
        return compact_ins(eq, ids, eids, t_sp)

    if rows == 1:
        return ins
    dev = dnet.pre.device
    copy = torch.arange(rows, dtype=torch.int64, device=dev)

    def ins_rows(eq, spiked, t_sp):
        ids, eids, cnt = ew_ops.compact_gather_rows(spiked.reshape(rows, n),
                                                    edge_tbl, cap, fill=E)
        cnt_h = cnt.tolist()
        small = [0 < c <= cap for c in cnt_h]
        if any(small):
            # the copies' batches side by side: copy t's spiking lanes and
            # edges offset by t * n and t * E into the tiled lists
            pick = torch.tensor(small, device=dev)
            ok = (pick[:, None] & (ids < n))[:, :, None] & (eids < E)
            lane = torch.clamp(ids, max=n - 1).long() + (copy * n)[:, None]
            eidc = torch.clamp(eids, max=E - 1).long() + \
                (copy * E)[:, None, None]
            t_ev = t_sp[lane][:, :, None] + dnet.delay[eidc]
            eq = qops.insert_batch(eq, dnet.post[eidc].reshape(-1),
                                   t_ev.reshape(-1),
                                   dnet.w_ampa[eidc].reshape(-1),
                                   dnet.w_gaba[eidc].reshape(-1),
                                   ok.reshape(-1))
        big = [c > cap for c in cnt_h]
        if any(big):
            keep = torch.tensor(big, device=dev).repeat_interleave(n)
            eq = dense_ins(eq, spiked & keep, t_sp)
        return eq

    return ins_rows


def auto_batch_cap(stats: SchedStats, n: int, *, slack: float = 2.0,
                   floor: int = 32) -> int:
    """``batch_cap`` from a probe run's frontier telemetry: the mean
    runnable frontier per round times ``slack``, rounded up to a power of
    two, clipped to [floor, n]."""
    rounds = max(1, int(stats.rounds))
    mean_frontier = float(stats.runnable) / rounds
    want = max(float(floor), slack * mean_frontier)
    return min(n, 1 << max(0, int(np.ceil(np.log2(want)))))


def auto_spike_cap(rec, stats: SchedStats, n: int, *, slack: float = 4.0,
                   floor: int = 16) -> int:
    """``spike_cap`` from a probe run's spike-rate telemetry: mean spikes
    per round times ``slack``, rounded up to a power of two, clipped to
    [floor, n].  Undershooting only costs the dense fallback."""
    rounds = max(1, int(stats.rounds))
    mean_spikes = float(rec.count.sum()) / rounds
    want = max(float(floor), slack * mean_spikes)
    return min(n, 1 << max(0, int(np.ceil(np.log2(want)))))


def compact_frontier(runnable, t_clock, cap: int, n_iters: int = 48):
    """Select and compact the runnable frontier into a [cap] gather-id
    batch: (ids i32[cap] -- unique lane ids, sentinel N; count i32[] --
    selected lanes, may exceed cap: the overflow rolls to a later round).

    When the cap binds, the earliest-clock lanes are kept
    (``select_active``) and the globally earliest runnable lane is forced
    in, replacing the last filled slot if the index-ordered compaction
    left it out (bisection-resolution ties could crowd it out and starve
    the lane the progress argument depends on).  Tensor ops only, no host
    synchronisation.

    Rows form: ``runnable`` and ``t_clock`` [T, N] (the tenants of
    ``exec_fap``'s ``tenant_round``) give ids i32[T, cap] and counts
    i32[T], every selection taken within its row (K6's rows form), as
    JAX's ``vmap`` of the one-row function does."""
    from repro_torch.kernels.event_wheel import ops as ew_ops
    n = t_clock.shape[-1]
    sel = select_active(runnable, t_clock, cap, n_iters) if cap < n \
        else runnable
    compact = ew_ops.compact_ids if runnable.dim() == 1 \
        else ew_ops.compact_ids_rows
    ids, cnt = compact(sel, cap)
    if cap < n:
        score = torch.where(runnable, t_clock, torch.inf)
        earliest = torch.argmin(score, dim=-1, keepdim=True).to(ids.dtype)
        have = (ids == earliest).any(dim=-1) | ~runnable.any(dim=-1)
        last = torch.clamp(torch.minimum(cnt, torch.full_like(cnt, cap)) - 1,
                           min=0)
        forced = ids.scatter(-1, last.long()[..., None], earliest)
        ids = torch.where(have[..., None], ids, forced)
    return ids, cnt


def unique_pad_ids(ids, n: int):
    """Sentinel padding (>= n) remapped to distinct out-of-range ids
    n, n+1, ...: every write of a scatter then has its own row."""
    pad = n + torch.arange(ids.shape[0], dtype=ids.dtype, device=ids.device)
    return torch.where(ids < n, ids, pad)


def _pad_rows(x, rows: int):
    return torch.cat([x, x.new_zeros((rows,) + tuple(x.shape[1:]))])


def scatter_at(full, ids, vals):
    """``full`` with rows ``ids`` set to ``vals``; sentinel ids (>= N) are
    dropped, never clipped onto a live row.  The padding goes to its own
    rows past N (``unique_pad_ids``), which are sliced off."""
    n, cap = full.shape[0], ids.shape[0]
    out = _pad_rows(full, cap)
    out.index_copy_(0, unique_pad_ids(ids, n).long(), vals)
    return out[:n]


def scatter_lanes(full, batch, ids):
    """Scatter advanced lanes of a batched state back
    (``bdf.scatter_lanes`` on padded fields); sentinel ids are dropped.
    ``ids`` holds unique in-range lanes (the compaction guarantees it)."""
    n, cap = full.t.shape[0], ids.shape[0]
    padded = type(full)(*[_pad_rows(x, cap) for x in full])
    out = bdf.scatter_lanes(padded, unique_pad_ids(ids, n).long(), batch)
    return type(full)(*[x[:n] for x in out])


class SimCarry(NamedTuple):
    """The round-boundary state of a vardt run as one tuple (``repro.core
    .exec_common.SimCarry``): the batched ``bdf.BDFState``, the queue (the
    SPMD round's raw ``(t, w_ampa, w_gaba)`` planes), the spike record, the
    incremental-horizon carry (possibly empty) and the scalar counters."""
    sts: object
    eq: object
    rec: object
    hcarry: tuple
    counters: dict


def empty_health(watchdog: bool = True) -> dict:
    """The ``RunResult.health`` record a watchdog-driven run fills
    (``repro.core.exec_common.empty_health``): every rollback, regression,
    violation and drop is counted, and ``rollback_exhausted`` escalates to
    ``RunResult.failed``."""
    return {
        "watchdog": bool(watchdog),
        "checks": 0,                 # rounds the watchdog inspected
        "nonfinite_rounds": 0,       # rounds with a non-finite lane detected
        "clock_regressions": 0,      # lanes whose clock moved backwards
        "horizon_violations": 0,     # carried horizon past clock + cap
        "rollbacks": 0,              # quarantine-and-rollback events
        "rollback_exhausted": False,  # bounded retries spent -> failed
        "checkpoints_saved": 0,
        "resumed_from": None,        # round the run resumed at (or None)
        "elastic_reseeded": False,   # hcarry reseeded on mesh-shape change
        "dropped_events": 0,         # queue + parcel overflow (escalated)
        "straggler": None,           # StragglerMonitor.stats()
    }


def health_check(sts, t_prev, horizon=None, horizon_cap=None,
                 eps: float = 1e-9) -> dict:
    """Per-round finiteness and invariant check (int32 scalars, no host
    read): lanes whose BDF history ``zn``, clock ``t`` or step ``h`` is not
    finite; clocks that moved behind the previous round's; a carried
    horizon past its lane's clock plus ``horizon_cap``."""
    zn_ok = torch.isfinite(sts.zn).reshape(sts.zn.shape[0], -1).all(dim=1)
    lane_bad = ~zn_ok | ~torch.isfinite(sts.t) | ~torch.isfinite(sts.h)
    out = {
        "nonfinite_lanes": lane_bad.sum().to(torch.int32),
        "clock_regress": (sts.t < t_prev - eps).sum().to(torch.int32),
    }
    if horizon is not None and horizon_cap is not None:
        out["horizon_violations"] = \
            (horizon > sts.t + horizon_cap + eps).sum().to(torch.int32)
    return out


def health_check_tenants(sts, t_prev, eps: float = 1e-9) -> dict:
    """Per-tenant verdicts of ``health_check``'s invariants over a batched
    carry whose ``sts`` leaves carry a leading [T] tenant axis ([T, N,
    ...]); each tenant's verdict reduces over its own neurons only, so a
    poisoned tenant never taints a neighbour's.  Returns tensors [T]:
    ``nonfinite_lanes`` (i32, neurons whose zn/t/h went non-finite),
    ``clock_regress`` (i32, clocks that moved backwards) and
    ``solver_failed`` (bool, the BDF latched ``failed`` -- deterministic,
    so the service evicts rather than retries)."""
    T, n = sts.t.shape
    zn_ok = torch.isfinite(sts.zn).reshape(T, n, -1).all(dim=2)
    lane_bad = ~zn_ok | ~torch.isfinite(sts.t) | ~torch.isfinite(sts.h)
    return {
        "nonfinite_lanes": lane_bad.sum(dim=1).to(torch.int32),
        "clock_regress": (sts.t < t_prev - eps).sum(dim=1).to(torch.int32),
        "solver_failed": sts.failed.any(dim=1),
    }


def poison_lane(carry: SimCarry, lane: int, value=float("nan")) -> SimCarry:
    """Fault injection: a copy of ``carry`` with lane ``lane``'s BDF
    history set to ``value`` (non-finite by default) -- the failure the
    watchdog must catch."""
    zn = carry.sts.zn.clone()
    zn[lane] = value
    return carry._replace(sts=carry.sts._replace(zn=zn))


def save_sim_checkpoint(ckpt_dir: str, rnd: int, carry: SimCarry,
                        extras: dict = None, keep: int = 3) -> str:
    """Atomic round-boundary snapshot (``repro_torch.checkpoint``) and
    pruning to the ``keep`` newest; ``rnd`` is the scheduler round."""
    from repro_torch.checkpoint import checkpoint as ck
    path = ck.save_checkpoint(ckpt_dir, rnd, carry, extras=extras)
    ck.prune_checkpoints(ckpt_dir, keep=keep)
    return path


def restore_sim_checkpoint(ckpt_dir: str, rnd: int, like: SimCarry):
    """Restore a ``SimCarry`` snapshot into the structure of ``like``.

    Returns (carry, extras, skipped): ``skipped`` lists the leaf paths
    whose stored shape differs from ``like``'s; those leaves keep
    ``like``'s value.  Only the layout-dependent ``hcarry`` leaves may
    legitimately change shape (a resume on another number of ranks);
    callers reject any other skip and reseed the horizon carry.  Every
    restored leaf is integrity-checked (bytes and crc32), the stored tree
    structure must be ``like``'s, and each leaf comes back as its like
    leaf's kind (a Python int as an int)."""
    from repro_torch.checkpoint import checkpoint as ck
    path = ck.step_path(ckpt_dir, rnd)
    manifest = ck.read_manifest(path)
    leaves, treedef = ck.flatten(like)
    ck.check_structure(manifest, leaves, treedef)
    out, skipped = [], []
    for entry, leaf, pstr in zip(manifest["entries"], leaves,
                                 ck.leaf_paths(like)):
        arr = ck.load_leaf(path, entry)
        if tuple(arr.shape) != ck.leaf_shape(leaf):
            skipped.append(pstr)
            out.append(leaf)
            continue
        out.append(ck.like_leaf(arr, leaf))
    return (ck.pytree.tree_unflatten(out, treedef), manifest["extras"],
            skipped)


def _sync(carry: SimCarry) -> None:
    t = carry.sts.t
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def run_checkpointed(init_fn, step_fn, cond_fn, *, ckpt_dir=None,
                     checkpoint_every: int = 0, resume: bool = False,
                     keep: int = 3, fault=None, health_of=None,
                     max_rollbacks: int = 2, reseed=None, fingerprint=None,
                     extras_fn=None, log_fn=None, straggler=None,
                     save_fn=None, restore_fn=None, poison_fn=None):
    """Host-stepped round loop with round-boundary checkpoint/restore,
    fault injection and the health watchdog: the preemption-tolerance
    harness every vardt runner shares (``repro.core.exec_common
    .run_checkpointed``).

      init_fn() -> SimCarry                 fresh round-0 state
      step_fn(SimCarry) -> SimCarry         one scheduler round (bumps
                                            counters["rounds"])
      cond_fn(SimCarry) -> bool             continue predicate
      health_of(SimCarry, t_prev) -> dict   per-round watchdog counts
                                            (``health_check``; None = off)
      fault: ``checkpoint.FaultPlan``       round-boundary injection
      reseed(SimCarry) -> SimCarry          re-derive ``hcarry`` after a
                                            restore that skipped it or whose
                                            ``fingerprint`` differs
      fingerprint: JSON-able layout id      saved in the manifest extras
      save_fn / restore_fn / poison_fn      the SPMD runner's gathered save,
                                            sliced restore and rank-local
                                            poison (defaults:
                                            ``save_sim_checkpoint``,
                                            ``restore_sim_checkpoint``,
                                            ``poison_lane``)

    A non-finite state quarantines the round: restore the last checkpoint
    (round 0 via ``init_fn`` when none exists yet) and retry, at most
    ``max_rollbacks`` times; then ``rollback_exhausted`` is set (the caller
    folds it into ``RunResult.failed``).  A round is timed for the
    straggler monitor after the device has finished it
    (``torch.cuda.synchronize``), the watchdog's check apart.

    Returns (final SimCarry, health dict).
    """
    import time

    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.checkpoint.fault_tolerance import (SimulatedFailure,
                                                        StragglerMonitor)

    if (resume or checkpoint_every) and not ckpt_dir:
        raise ValueError("checkpoint_every/resume need ckpt_dir=")
    log = log_fn or (lambda *_: None)
    save_fn = save_fn or save_sim_checkpoint
    restore_fn = restore_fn or restore_sim_checkpoint
    poison_fn = poison_fn or poison_lane
    monitor = straggler if straggler is not None else StragglerMonitor()
    health = empty_health(watchdog=health_of is not None)

    def _restore(rnd, like):
        carry, extras, skipped = restore_fn(ckpt_dir, rnd, like)
        stale = fingerprint is not None and \
            extras.get("fingerprint") != fingerprint
        if skipped or stale:
            bad = [p for p in skipped if "hcarry" not in p]
            if bad or reseed is None:
                raise ValueError(f"checkpoint leaf shapes changed outside "
                                 f"the horizon carry: {skipped}")
            carry = reseed(carry)
            health["elastic_reseeded"] = True
        return carry

    carry = init_fn()
    if resume:
        last = ck.latest_step(ckpt_dir)
        if last is not None:
            carry = _restore(last, carry)
            health["resumed_from"] = last
            log(f"[sim-ft] resumed from round {last}")
    rollbacks = 0
    poison_pending = fault is not None and fault.poison_at_round is not None
    fail_pending = fault is not None and fault.fail_at_round is not None
    while cond_fn(carry):
        rnd = int(carry.counters["rounds"])
        if fail_pending and rnd >= fault.fail_at_round:
            raise SimulatedFailure(rnd)
        if poison_pending and rnd >= fault.poison_at_round:
            poison_pending = False
            carry = poison_fn(carry, fault.poison_lane, fault.poison_value)
            log(f"[sim-ft] poisoned lane {fault.poison_lane} at round {rnd}")
        if fault is not None and fault.mutate is not None:
            carry = fault.mutate(rnd, carry)
        t_prev = carry.sts.t
        t0 = time.perf_counter()
        new_carry = step_fn(carry)
        _sync(new_carry)
        dt = time.perf_counter() - t0
        if health_of is not None:
            chk = {k: int(v) for k, v in health_of(new_carry, t_prev).items()}
            health["checks"] += 1
            health["clock_regressions"] += chk.get("clock_regress", 0)
            health["horizon_violations"] += chk.get("horizon_violations", 0)
            if chk.get("nonfinite_lanes", 0):
                health["nonfinite_rounds"] += 1
                rollbacks += 1
                if rollbacks > max_rollbacks:
                    health["rollback_exhausted"] = True
                    log(f"[sim-ft] non-finite state at round {rnd}: "
                        f"retries exhausted")
                    carry = new_carry
                    break
                health["rollbacks"] += 1
                last = ck.latest_step(ckpt_dir) if ckpt_dir else None
                to = "init" if last is None else f"round {last}"
                log(f"[sim-ft] non-finite state at round {rnd}; rolling back "
                    f"to {to}")
                carry = init_fn() if last is None else _restore(last, carry)
                continue
        monitor.record(dt)
        carry = new_carry
        r2 = int(carry.counters["rounds"])
        if checkpoint_every and r2 % checkpoint_every == 0:
            ex = dict(extras_fn()) if extras_fn else {}
            if fingerprint is not None:
                ex["fingerprint"] = fingerprint
            save_fn(ckpt_dir, r2, carry, extras=ex or None, keep=keep)
            health["checkpoints_saved"] += 1
    health["straggler"] = monitor.stats()
    return carry, health


def spike_rates(rec: ev.SpikeRecord, t_lo: float, t_hi: float):
    """Per-neuron firing rate (Hz) in a window; times in ms."""
    m = (rec.times >= t_lo) & (rec.times < t_hi)
    window_s = torch.full((), (t_hi - t_lo) * 1e-3, dtype=torch.float64,
                          device=rec.times.device)
    return m.sum(dim=1).to(torch.float64) / window_s
