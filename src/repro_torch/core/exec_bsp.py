"""The variable-timestep neuron advance shared by the vardt execution models,
and their result record.  Counterpart of the vardt parts of
``repro.core.exec_bsp``; the BSP runners themselves come in a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bdf
from repro_torch.core import exec_common as xc
from repro_torch.core.cell import CellModel
from repro_torch.core.detmath import fixed_sum

EV_CAP = 64
SPK_CAP = 256


class RunResult(NamedTuple):
    rec: object                # events.SpikeRecord
    n_steps: torch.Tensor      # total accepted steps (all neurons)
    n_events: torch.Tensor     # delivered events
    n_resets: torch.Tensor     # IVP resets
    dropped: torch.Tensor      # event-queue overflow (must be 0)
    failed: torch.Tensor       # integrator failures (must be 0)
    y_final: torch.Tensor      # [N, n_state] (zn[:, 0])
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
