"""Quickstart: the paper in one file, on the port.

Simulates a single detailed (HH) neuron two ways and prints what the paper's
Fig. 5/6 show: the variable-order variable-timestep BDF integrator needs
far fewer steps than fixed-step backward Euler (method 2a) at matched
accuracy, and synaptic discontinuities (IVP resets) are what it pays for.
The port's copy of ``examples/quickstart.py``, on the same branched cell
with the correlated plasticity pair.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import bdf, morphology
from repro_torch.core.cell import CellModel
from repro_torch.core.fixed_step import run_fixed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--t", type=float, default=200.0, help="biological ms")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    model = CellModel(morphology.branched_tree(depth=2, seg_per_branch=2),
                      with_plasticity=True, device=dev)
    print(f"neuron: {model.C} compartments, {model.n_state} ODE states "
          f"(HH Na/K/leak + synapses + correlated plasticity pair) on {dev}")
    t_end, iinj = args.t, 0.05         # gentle subthreshold drive (quiet regime)

    # --- reference fixed-step (paper method 2a) --------------------------
    y_fix, n_fix, _ = run_fixed(model, model.init_state(), t_end, iinj,
                                method="derivimplicit", dt=0.025, device=dev)
    print(f"fixed dt=25us     : {n_fix:6d} steps")

    # --- the paper's solver: CVODE-style BDF(1..5) -----------------------
    opts = bdf.BDFOptions(atol=1e-3)
    one = torch.full((1,), iinj, dtype=torch.float64, device=dev)
    st = bdf.reinit(model, 0.0, model.init_state()[None], one, opts)
    st = bdf.advance_to(model, st, t_end, one, opts)
    nst = int(st.nst[0])
    print(f"vardt BDF atol=1e-3: {nst:6d} steps ({n_fix / nst:.0f}x fewer), "
          f"final order q={int(st.q[0])}, h={float(st.h[0]):.3f} ms, "
          f"newton iters={int(st.nni[0])}")
    dv = abs(float(st.zn[0, 0, 0]) - float(y_fix[0]))
    print(f"|V_soma difference| = {dv:.4f} mV")

    # --- a synaptic discontinuity = IVP reset ----------------------------
    st = bdf.deliver_event(model, st, torch.full_like(one, 5e-3),
                           torch.zeros_like(one), one, opts)
    print(f"after synaptic event: order reset to q={int(st.q[0])}, "
          f"h={float(st.h[0]):.5f} ms  <- the cost the paper's "
          "event-grouping variants amortise")
    st = bdf.advance_to(model, st, t_end + 50.0, one, opts)
    print(f"recovered: q={int(st.q[0])}, h={float(st.h[0]):.3f} ms, "
          f"failed={bool(st.failed[0])}")
    return st


if __name__ == "__main__":
    main()
