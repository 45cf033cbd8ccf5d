"""Threshold current of a branched cell, and each regime's first spike.

    python3 scripts/calibrate_cell.py [--depth 8] [--seg 2] [--device cuda]
                                      [--t-first 5]

Runs ``repro_torch.core.calibrate.threshold_current`` (a bisection over
200 ms cnexp traces at dt 0.025 ms, method 1a) on
``CellModel(branched_tree(depth, seg))``, then one batch of five neurons
driven at the paper's Fig. 10 regime currents (``network.regime_current``
of that threshold) for ``--t-first`` ms, and prints one JSON line: C, the
threshold, each regime's current and the time of its first somatic spike
(null if none by then), the seconds taken and the device.  The port rounds
alike on the card and the CPU, so either gives the same currents; at
C = 1021 the bisection took 262 s on an NVIDIA H100 80GB HBM3 (700 W),
launch-bound single-neuron steps.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.calibrate import threshold_current  # noqa: E402
from repro_torch.core.cell import CellModel  # noqa: E402
from repro_torch.core.exec_common import SPIKE_THR  # noqa: E402
from repro_torch.core.fixed_step import run_fixed  # noqa: E402
from repro_torch.core.morphology import branched_tree  # noqa: E402
from repro_torch.core.network import regime_current  # noqa: E402

REGIMES = ("quiet", "slow", "moderate", "fast", "burst")
DT = 0.025


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--seg", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--t-first", type=float, default=5.0)
    args = ap.parse_args(argv)
    model = CellModel(branched_tree(depth=args.depth,
                                    seg_per_branch=args.seg),
                      device=args.device)
    t0 = time.perf_counter()
    i_th = threshold_current(model, device=args.device)
    t_th = time.perf_counter() - t0
    cur = np.array([regime_current(r, i_th) for r in REGIMES])
    y0 = model.init_state()[None].repeat(len(REGIMES), 1)
    _, _, trace = run_fixed(model, y0, args.t_first,
                            torch.as_tensor(cur, device=model.device),
                            dt=DT, record_every=1, device=args.device)
    vs = trace.cpu().numpy()
    first = []
    for k in range(len(REGIMES)):
        up = np.nonzero((vs[1:, k] > SPIKE_THR) & (vs[:-1, k] <= SPIKE_THR))[0]
        first.append(None if up.size == 0 else float((up[0] + 2) * DT))
    dev = torch.cuda.get_device_name(0) if model.device.type == "cuda" \
        else "cpu"
    print(json.dumps({
        "C": model.C, "depth": args.depth, "seg_per_branch": args.seg,
        "i_threshold": i_th, "regime_currents": dict(zip(REGIMES,
                                                         cur.tolist())),
        "first_spike_ms": dict(zip(REGIMES, first)),
        "t_first_ms": args.t_first, "threshold_seconds": t_th,
        "device": dev}))


if __name__ == "__main__":
    main()
