"""K2 and K6 of the port, two source trees in turns on one NVIDIA card.

    python3 scripts/kernel_ab.py BASE_TREE [NEW_TREE] [--order ABBA]
                                 [--t-end MS]

Each tree (the root of a checkout; NEW_TREE defaults to this one) runs in
its own process with its own ``src/`` first on the path and builds its own
kernels; the measuring code is this checkout's (``chip_smoke.py``'s
helpers), so only the code under test differs.  Every run measures, at the
main path's shapes (``chip_smoke.py`` phases 2 and 5):

* K2 ``hines_solve_factored`` on the branched cell (C = 13), N = 16384,
  d_elim as the ``factors[:, :C].T`` slice of ``[N, n_factors]`` rows and b
  as transposed ``[N, C]`` rows; K6 ``compact_ids`` on a 50 % mask of
  N = 16384 lanes with cap = N (the active path's auto cap).  For each:
  ``ms`` (CUDA events around each of 25 calls, median), ``device_ms`` (a
  CUDA graph of 50 launches, median of 5 replays, over 50), ``host_us``
  (wall of 1000 calls back to back, median of 5: the wrapper's host
  work), and ``bitwise`` against the plain version; beside K6
  ``torch.nonzero``'s ``ms`` and device time (``torch.profiler``, it syncs);
* ``dense_ms_round`` and ``active_ms_round``: ``chip_smoke.py`` phase 3's
  dense 2c run and phase 4's active-set run (probe excluded) at
  ``--t-end`` ms (0 skips them), wall per round, with their K2 and K6
  launches.  These are host-bound; they are reported, and no gain is
  claimed from them;
* ``ptxas``: registers and static shared memory of both kernels, from
  nvcc's ``-Xptxas -v`` (runs that built the library).

One JSON line per run, then the card's name and power limit.  Compare two
trees only within one invocation: hosts differ between machines.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HARNESS = Path(__file__).resolve().parents[1]

WORKER = r'''
import json, statistics, sys, time
sys.path.insert(0, HARNESS)
import numpy as np
import torch
import chip_smoke as cs
from repro_torch.core.morphology import branched_tree
from repro_torch.kernels import build
from repro_torch.kernels.event_wheel import ops as ew_ops
from repro_torch.kernels.event_wheel import ref as ew_ref
from repro_torch.kernels.hines import ops as h_ops
from repro_torch.kernels.hines import ref as h_ref

build.build_all(("hines", "hh_rhs", "horizon", "compact", "segment_rank"))
dev = torch.device("cuda")
N = cs.N_MAIN


def host_us(fn, calls=1000, reps=5):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(t)


def timed(fn, want):
    got = fn()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return dict(bitwise=all(torch.equal(g, w) for g, w in zip(got, want)),
                ms=cs.cuda_ms(fn), device_ms=cs.device_ms(fn),
                host_us=host_us(fn))


out = {}
model, d, fac, b = cs._hines_case(branched_tree(depth=2, seg_per_branch=2),
                                  dev, N)
C, p = model.C, model.params
fac[:, :C] = h_ops.hines_factor(p.parent, p.g_axial, d.T).T
deT, bT = fac[:, :C].T, b.T
want = h_ref.hines_solve_factored_ref(p.parent, p.g_axial, deT, bT)
out["k2"] = timed(lambda: h_ops.hines_solve_factored(p.parent, p.g_axial,
                                                     deT, bT), want)

mask = torch.from_numpy(np.random.default_rng(7).random(N) < 0.5).to(dev)
out["k6"] = timed(lambda: ew_ops.compact_ids(mask, N),
                  ew_ref.compact_ids_ref(mask, N))
out["nonzero"] = dict(ms=cs.cuda_ms(lambda: torch.nonzero(mask)),
                      device_ms=cs.profiled_device_ms(
                          lambda: torch.nonzero(mask)))

for name, knobs in (("dense", {}), ("active", dict(wheel="auto",
                                                    **cs.ACTIVE))):
    if T_END <= 0:
        break
    build.reset_launches()
    run = cs._runner(dev, N, T_END, **knobs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, rounds = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if bool(res.failed) or int(res.dropped):
        raise SystemExit(f"{name} run failed or dropped events")
    n = build.launches()
    out[name] = dict(ms_round=wall / rounds * 1e3, rounds=rounds,
                     spikes=int(res.rec.count.sum()),
                     k2_launches=n["hines_solve_factored"],
                     k6_launches=n["compact_ids"])

ptxas = {}
for src, kern in (("hines", "hines_solve_factored_kernel"),
                  ("compact", "compact_ids_kernel")):
    entry = None
    for line in build.ptxas_log(src).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line and entry and kern in entry:
            ptxas[entry] = line.split(":", 1)[1].strip()
out["ptxas"] = ptxas
print("RESULT " + json.dumps(out))
'''


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", help="root of the tree run as A")
    ap.add_argument("new", nargs="?", default=str(HARNESS),
                    help="root of the tree run as B (default: this one)")
    ap.add_argument("--order", default="ABBA",
                    help="the runs, in turn (default ABBA)")
    ap.add_argument("--t-end", type=float, default=12.0,
                    help="simulated ms of the dense and active runs "
                         "(0: skip them)")
    args = ap.parse_args(argv)
    trees = {"A": args.base, "B": args.new}
    worker = (f"HARNESS = {str(HARNESS)!r}\nT_END = {args.t_end!r}\n"
              + WORKER)
    for name in args.order:
        env = dict(os.environ,
                   PYTHONPATH=str(Path(trees[name]).resolve() / "src"))
        r = subprocess.run([sys.executable, "-c", worker], env=env,
                           capture_output=True, text=True)
        got = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
        if r.returncode or not got:
            sys.stderr.write(r.stdout[-2000:] + r.stderr[-4000:])
            raise SystemExit(f"run {name} ({trees[name]}) failed")
        print(json.dumps({"tree": name, "root": trees[name],
                          **json.loads(got[0][len("RESULT "):])}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
