"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--t-end MS] [--out FILE] [--profile ROUNDS]

Phases, each reported on its own lines:

  1. setup: the card (nvidia-smi name and power limit), torch's CUDA, nvcc,
     ninja, and the parallel nvcc build of every kernel source;
  2. every kernel against its plain PyTorch version on the card, at the main
     path's shapes (K1/K2/K4 at N=16384 with C=13 and C=1, K5 at K=16), with
     CUDA-event timings (median of 25 runs) and each kernel's bound;
  3. the main path at full width: ``make_fap_vardt_runner`` on the branched
     cell (C=13), 16384 neurons with 16 synapses each, regime-mixed
     currents, ``horizon_impl="fused"`` -- with the kernels' launch counts;
  4. the same path at N=64 on the card (kernels) and on the CPU (plain
     versions): per-neuron spike counts equal, spike times within 1e-6 ms
     (the port rounds alike on both, ``repro_torch/core/detmath.py``);
  5. with ``--profile ROUNDS`` only: a ``torch.profiler`` trace of that many
     full-width rounds (device busy share, busiest kernels).

Any failed check raises, so the script exits non-zero and prints no result
line.  It needs a CUDA card and the repository's ``src/`` beside it.  The
last line of standard output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Regime mix of the paper's Fig. 10 (benchmarks/lab_experiment_fig8.py) and
# the branched cell's threshold current (benchmarks/_calibration.json).
PCTS = {"quiet": 0.3143, "slow": 0.3844, "moderate": 0.2702,
        "fast": 0.0310, "burst": 0.0001}
I_THRESH_BRANCHED = 0.1083984375
N_MAIN, K_IN, NET_SEED = 16384, 16, 11
RTOL, ATOL = 1e-12, 1e-14
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP64_FLOPS = 34e12             # H100 SXM fp64 outside the tensor cores
#                                (NVIDIA data sheet)
SRC = "src/repro_torch/csrc"
REPLACES = {
    "hines_factor": "src/repro/kernels/hines/hines.py:163",
    "hines_solve_factored": "src/repro/kernels/hines/hines.py:188",
    "hh_rhs": "src/repro/kernels/hh_rhs/hh_rhs.py:46",
    "horizon_score": "src/repro/kernels/event_wheel/event_wheel.py:38",
}
SOURCE = {"hines_factor": f"{SRC}/hines.cu",
          "hines_solve_factored": f"{SRC}/hines.cu",
          "hh_rhs": f"{SRC}/hh_rhs.cu", "horizon_score": f"{SRC}/horizon.cu"}


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def regime_currents(n, seed=0):
    from repro_torch.core.network import regime_current
    names = list(PCTS)
    p = np.array([PCTS[k] for k in names])
    assign = np.random.default_rng(seed).choice(len(names), size=n,
                                                p=p / p.sum())
    return np.array([regime_current(names[a], I_THRESH_BRANCHED)
                     for a in assign])


def cuda_ms(fn, reps=25, warmup=3):
    """Median time of one call, CUDA events around each of ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check_close(name, got, ref, exact=False):
    fin = torch.isfinite(ref)
    diff = (got - ref).abs()[fin]
    err = float(diff.max()) if diff.numel() else 0.0
    if exact:
        ok = torch.equal(got, ref)
    else:
        ok = bool(fin.all()) and bool((diff <= ATOL + RTOL * ref.abs()[fin]).all())
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e})")
    return err


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phase 1 --
def phase_setup():
    from repro_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    say("setup", f"nvidia-smi: {smi}")
    nvcc = build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1]
    say("setup", f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"nvcc {ver}; ninja {'present' if shutil.which('ninja') else 'absent'}"
        f"; device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    paths = build.build_all()
    say("setup", f"kernel build {time.perf_counter() - t0:.2f} s "
        f"({len(paths)} sources in parallel, sm_90a)")
    for name in paths:
        for line in build.ptxas_log(name).splitlines():
            if "registers" in line or "spill" in line:
                say("setup", f"ptxas {name}: {line.strip()}")
    return smi


# ---------------------------------------------------------------- phase 2 --
def _hines_case(morph, dev, N):
    from repro_torch.core.cell import CellModel
    model = CellModel(morph, device=dev)
    C = model.C
    g = torch.Generator(device="cpu").manual_seed(C)
    d = (torch.rand((N, C), generator=g, dtype=torch.float64) + 0.5).to(dev)
    d = d + model.params.g_axial + model._contrib             # assembled
    fac = torch.rand((N, model.n_factors()), generator=g,
                     dtype=torch.float64).to(dev)
    b = torch.randn((N, C), generator=g, dtype=torch.float64).to(dev)
    return model, d, fac, b


def phase_kernels(dev):
    from repro_torch.core.morphology import branched_tree, soma_only
    from repro_torch.core.network import make_network
    from repro_torch.kernels import build
    from repro_torch.kernels.event_wheel import ops as ew_ops
    from repro_torch.kernels.event_wheel import ref as ew_ref
    from repro_torch.kernels.hh_rhs import ops as hh_ops
    from repro_torch.kernels.hh_rhs import ref as hh_ref
    from repro_torch.kernels.hines import ops as h_ops
    from repro_torch.kernels.hines import ref as h_ref

    N = N_MAIN
    rows = {}
    for morph in (branched_tree(depth=2, seg_per_branch=2), soma_only()):
        model, d, fac, b = _hines_case(morph, dev, N)
        C, p = model.C, model.params
        # the main path's layouts: transposed [N, C] rows, factor-row slices
        dT = d.T
        de = h_ops.hines_factor(p.parent, p.g_axial, dT)
        fac[:, :C] = de.T
        deT = fac[:, :C].T
        e1 = check_close(f"hines_factor C={C}", de,
                         h_ref.hines_factor_ref(p.parent, p.g_axial, dT))
        x = h_ops.hines_solve_factored(p.parent, p.g_axial, deT, b.T)
        e2 = check_close(f"hines_solve_factored C={C}", x,
                         h_ref.hines_solve_factored_ref(p.parent, p.g_axial,
                                                        deT, b.T))
        Y = torch.cat([torch.rand((N, C), dtype=torch.float64, device=dev)
                       * 120.0 - 80.0,
                       torch.rand((N, 3 * C + 2), dtype=torch.float64,
                                  device=dev)], dim=1)
        v, m, h, n = (Y[:, i * C:(i + 1) * C] for i in range(4))
        outs = hh_ops.hh_rhs(p.area, v, m, h, n)
        e4 = max(check_close(f"hh_rhs[{i}] C={C}", o, r) for i, (o, r) in
                 enumerate(zip(outs, hh_ref.hh_rhs_ref(p.area, v, m, h, n))))
        t1 = cuda_ms(lambda: h_ops.hines_factor(p.parent, p.g_axial, dT))
        t1p = cuda_ms(lambda: h_ref.hines_factor_ref(p.parent, p.g_axial, dT))
        t2 = cuda_ms(lambda: h_ops.hines_solve_factored(p.parent, p.g_axial,
                                                        deT, b.T))
        t2p = cuda_ms(lambda: h_ref.hines_solve_factored_ref(
            p.parent, p.g_axial, deT, b.T))
        t4 = cuda_ms(lambda: hh_ops.hh_rhs(p.area, v, m, h, n))
        t4p = cuda_ms(lambda: hh_ref.hh_rhs_ref(p.area, v, m, h, n))
        say("kernels", f"C={C} N={N}: hines_factor {t1:.4f} ms (plain "
            f"{t1p:.4f}) err {e1:.2e}; hines_solve_factored {t2:.4f} ms "
            f"(plain {t2p:.4f}) err {e2:.2e}; hh_rhs {t4:.4f} ms (plain "
            f"{t4p:.4f}) err {e4:.2e}")
        if C > 1:
            ne = N * C
            rows["hines_factor"] = (e1, t1, t1p, *bound_ms(
                16 * ne + 12 * C, 3 * (C - 1) * N))
            rows["hines_solve_factored"] = (e2, t2, t2p, *bound_ms(
                24 * ne + 12 * C, (6 * (C - 1) + 1) * N))
            rows["hh_rhs"] = (e4, t4, t4p, *bound_ms(72 * ne + 8 * C,
                                                     280 * ne))

    net = make_network(N, k_in=K_IN, seed=NET_SEED)
    pre, dly = ew_ops.by_post_layout(net, dev)
    K = pre.shape[0]
    gen = torch.Generator(device="cpu").manual_seed(5)
    tc = (torch.rand(N, generator=gen, dtype=torch.float64) * 20.0).to(dev)
    tc[:64] = 20.0                                    # some clocks at t_end
    kw = dict(t_end=20.0, horizon_cap=2.0)
    hor, score = ew_ops.horizon_score(tc, pre, dly, **kw)
    h_r, s_r = ew_ref.horizon_gather_ref(tc, pre, dly, **kw)
    e5 = max(check_close("horizon_score.hor", hor, h_r, exact=True),
             check_close("horizon_score.score", score, s_r, exact=True))
    t5 = cuda_ms(lambda: ew_ops.horizon_score(tc, pre, dly, **kw))
    t5p = cuda_ms(lambda: ew_ref.horizon_gather_ref(tc, pre, dly, **kw))
    say("kernels", f"K={K} N={N}: horizon_score {t5:.4f} ms (plain "
        f"{t5p:.4f}) bitwise")
    rows["horizon_score"] = (e5, t5, t5p, *bound_ms(
        12 * K * N + 8 * N + 16 * N, (2 * K + 5) * N))
    say("kernels", f"all four kernels agree with their plain versions "
        f"(rtol {RTOL}, atol {ATOL}; horizon bitwise); launches so far "
        f"{build.launches()}")
    return rows


# ---------------------------------------------------------------- phase 3 --
def _run(dev, n, t_end):
    from repro_torch.core.cell import CellModel
    from repro_torch.core.exec_fap import make_fap_vardt_runner
    from repro_torch.core.morphology import branched_tree
    from repro_torch.core.network import make_network
    model = CellModel(branched_tree(depth=2, seg_per_branch=2), device=dev)
    net = make_network(n, k_in=K_IN, seed=NET_SEED)
    run = make_fap_vardt_runner(model, net, regime_currents(n), t_end,
                                horizon_impl="fused", device=dev)
    return run()


def phase_main(dev, t_end):
    from repro_torch.kernels import build
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, rounds = _run(dev, N_MAIN, t_end)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = build.launches()
    spikes = int(res.rec.count.sum())
    solver = {k: int(v) for k, v in res.solver.items()}
    say("main", f"N={N_MAIN} C=13 k_in={K_IN} t_end={t_end} ms "
        f"horizon_impl=fused: rounds {rounds}, n_steps {int(res.n_steps)}, "
        f"n_events {int(res.n_events)}, n_resets {int(res.n_resets)}, "
        f"spikes {spikes}, dropped {int(res.dropped)}, "
        f"failed {bool(res.failed)}")
    say("main", f"solver {json.dumps(solver)}")
    say("main", f"wall {wall:.2f} s, {wall / max(rounds, 1) * 1e3:.1f} ms per "
        f"round; launches {json.dumps(launches)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if bool(res.failed):
        raise AssertionError("main path: an integrator failed")
    if int(res.dropped) != 0:
        raise AssertionError(f"main path dropped {int(res.dropped)} events")
    if spikes <= 0 or int(res.n_events) <= 0:
        raise AssertionError("main path produced no spikes or no events")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    return launches, dict(rounds=rounds, wall_s=wall, spikes=spikes,
                          n_steps=int(res.n_steps),
                          n_events=int(res.n_events),
                          n_resets=int(res.n_resets), solver=solver)


# ---------------------------------------------------------------- phase 4 --
def phase_card_vs_cpu(dev, n=64, t_end=10.0):
    t0 = time.perf_counter()
    gpu, _ = _run(dev, n, t_end)
    cpu, _ = _run("cpu", n, t_end)
    gc, cc = gpu.rec.count.cpu().numpy(), cpu.rec.count.numpy()
    gt, ct = gpu.rec.times.cpu().numpy(), cpu.rec.times.numpy()
    fin = np.isfinite(ct)
    dt = float(np.abs(gt[fin] - ct[fin]).max()) if fin.any() else 0.0
    same = np.array_equal(gt, ct) and int(gpu.n_steps) == int(cpu.n_steps) \
        and torch.equal(gpu.y_final.cpu(), cpu.y_final)
    say("card-vs-cpu", f"N={n} C=13 t_end={t_end} ms: spikes card "
        f"{int(gc.sum())} cpu {int(cc.sum())}; n_steps card "
        f"{int(gpu.n_steps)} cpu {int(cpu.n_steps)}; max spike-time "
        f"difference {dt:.3e} ms; final states bitwise equal: {same} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not np.array_equal(gc, cc) or not np.array_equal(np.isfinite(gt), fin):
        raise AssertionError("per-neuron spike counts differ card vs CPU")
    if int(cc.sum()) == 0:
        raise AssertionError("card-vs-CPU run produced no spikes")
    if dt > 1e-6:
        raise AssertionError(f"spike times differ card vs CPU by {dt} ms")


def phase_profile(dev, n_rounds, t_end, skip=54):
    """Where a full-width round's time goes: ``torch.profiler`` over
    ``n_rounds`` rounds of the main path after ``skip`` unprofiled ones (the
    spiking part of the run): wall time, summed device time, device busy
    share, launches and the busiest device kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.cell import CellModel
    from repro_torch.core.exec_fap import make_fap_vardt_runner
    from repro_torch.core.morphology import branched_tree
    from repro_torch.core.network import make_network
    model = CellModel(branched_tree(depth=2, seg_per_branch=2), device=dev)
    run = make_fap_vardt_runner(model, make_network(N_MAIN, k_in=K_IN,
                                                    seed=NET_SEED),
                                regime_currents(N_MAIN), t_end,
                                horizon_impl="fused", device=dev)
    carry = run.init_carry()
    for _ in range(skip):
        carry = run.round_body(carry)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_rounds):
            carry = run.round_body(carry)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    timed = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    ev = [e for e in timed if str(e.device_type).endswith("CUDA")] or timed
    dev_us = sum(e.self_device_time_total for e in ev)
    launches = sum(e.count for e in ev)
    say("profile", f"rounds {skip}..{skip + n_rounds - 1}: wall "
        f"{wall_us / n_rounds / 1e3:.1f} ms per round (profiled), device "
        f"{dev_us / n_rounds / 1e3:.2f} ms per round, busy share "
        f"{dev_us / wall_us:.3f}, {launches / n_rounds:.0f} device ops per "
        f"round")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
        say("profile", f"  {e.key[:60]:60s} {e.count / n_rounds:8.0f}/round "
            f"{e.self_device_time_total / n_rounds / 1e3:8.3f} ms/round")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--t-end", type=float, default=20.0,
                    help="simulated ms of the full-width main path")
    ap.add_argument("--out", default=None, help="also write results as JSON")
    ap.add_argument("--profile", type=int, default=0, metavar="ROUNDS",
                    help="also trace this many full-width rounds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda")
    t_all = time.perf_counter()
    smi = phase_setup()
    rows = phase_kernels(dev)
    launches, main_stats = phase_main(dev, args.t_end)
    phase_card_vs_cpu(dev)
    if args.profile:
        phase_profile(dev, args.profile, args.t_end)
    kernels = [{"name": k, "route": "cuda", "source": SOURCE[k],
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": rows[k][0], "ms": rows[k][1],
                "plain_ms": rows[k][2], "bound_ms": rows[k][3],
                "bound_by": rows[k][4], "library_ms": None}
               for k in REPLACES]
    say("done", f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"gpu": smi, "kernels": kernels, "main": main_stats}, indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
