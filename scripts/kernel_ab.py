"""K1, K2, K3, K5, K6, K7, K8, K9 and K10 of the port, two source trees in
turns on one NVIDIA card.

    python3 scripts/kernel_ab.py BASE_TREE [NEW_TREE ...] [--order ABBA]
                                 [--t-end MS] [--only GROUP,...]

Each tree (the root of a checkout; NEW_TREE defaults to this one; further
trees are C, D, ... in ``--order``) runs in
its own process with its own ``src/`` first on the path and builds its own
kernels; the measuring code is this checkout's (``chip_smoke.py``'s
helpers), so only the code under test differs.  Every run measures, at the
main path's shapes (``chip_smoke.py`` phases 2, 5 and 8):

* K1 ``hines_factor`` on ``d.T`` of the branched cell's ``[N, C]`` rows
  (C = 13), N = 16384; K2 ``hines_solve_factored`` on the same cell,
  d_elim as the ``factors[:, :C].T`` slice of ``[N, n_factors]`` rows and b
  as transposed ``[N, C]`` rows; K3 ``hines_solve`` on transposed ``[N,
  C]`` rows of the branched (``k3``) and the ball-and-stick cell (C = 11,
  ``k3_c11``); K1, K2 and K3 in the same layouts on the warp frame, at
  ``chip_smoke.py`` phase 33's detailed cell (C = 1021, N = 4096:
  ``k1_1021``, ``k2_1021``, ``k3_1021``; trees without the frame skip
  them); K5 ``horizon_score`` on phase 2's inputs (the network's
  by-post layout, K = 16, clocks uniform in [0, 20) from seed 5, the
  first 64 at t_end = 20, horizon cap 2); K6 ``compact_ids`` on a 50 %
  mask of N = 16384 lanes with cap = N (the active path's auto cap); K7
  ``compact_gather`` on the network's out-edge table (MO = 33) with a
  mask of 1866 set lanes from seed 23 (the active path's busiest spike
  mask's count), cap 128, fill = E; K8 ``segment_rank`` on a key batch
  as the active path's compact fan-out makes it (128 rows of the network's
  out-edge table, 123 of them a spiking neuron's: ``post * B + bucket``
  with B = 16 for each real edge, the invalid key N * B for the padding,
  E = 128 x the largest out-degree) at max_rank 19; K9 ``spike_compact``
  at D = 4, M = 4096, cap 2048 on the transport's transposed mask
  (strides (1, D)) at the SPMD path's density (1436 of 16384 set) and a
  broadcast value row; K10 (``ops.flash_attention``, float32 out, inputs
  from ``chip_smoke._attn_inputs``) in float32 at phase 17's commonest
  decode shape (B 3, H 4, Hkv 2, D 16, Sq 1 against a 48-row cache at its
  median kv_len 23: ``k10_f32_decode``), at a 4096-row cache (B 4, H 9,
  Hkv 3, D 64: ``k10_f32_decode_4096``) and at the serve model's 4 x 2048
  causal prefill (``k10_f32_prefill``), and in bf16 at the decode step
  against 256 and 4096 rows and the same prefill (``k10_bf16_*``); K10's
  backward (``flash_attention_bwd_cuda``, inputs from
  ``chip_smoke._bwd_inputs``) at smollm-135m's training shape (B 8, H
  9/3, S 256, D 64, causal: ``k10_bwd_{bf16,f32}``) and at 4 x 2048
  (``k10_bwd_{bf16,f32}_2048``), bf16 with dO rounded to bf16 as bf16
  training hands it over and, ``*_f32do``, with phase 27's float32 dO,
  with ``sha256`` of dq, dk and dv.
  Inputs come from one seed, the same in both trees.  For each: ``ms``
  (CUDA events
  around each of 25 calls, median), ``device_ms`` (a CUDA graph of 50
  launches, median of 5 replays, over 50), ``host_us`` (wall of 1000 calls
  back to back, median of 5: the wrapper's host work), and ``bitwise``
  against the plain version (K10: ``max_abs_err`` instead, the kernel
  that ran, ``scaled_dot_product_attention``'s device time as a
  yardstick, and for bf16 inputs ``sha256`` of the bf16 and the float32
  output's bytes, to hold them bitwise between trees); beside K6
  ``torch.nonzero``'s ``ms`` and device time (``torch.profiler``, it
  syncs);
* ``launch_floor_ms``: the device time of a one-element in-place
  ``torch.add_`` in the same graph harness, the least any launch costs;
* ``dense``, ``active`` and ``2a``: ``chip_smoke.py`` phase 3's dense 2c
  run, phase 4's active-set run (probe excluded) and phase 9's 2a run at
  ``--t-end`` ms (0 skips them): wall per round (2c) or per window (2a),
  with their K1/K2/K3/K6/K8 launches.  These are host-bound; they are
  reported, and no gain is claimed from them;
* ``ptxas``: registers, shared memory and spills of the kernels,
  from nvcc's ``-Xptxas -v`` (runs that built the library).

``--only`` keeps some groups of keys: ``hines`` (K1-K3 at both sizes),
``events`` (K5-K9, ``nonzero``), ``k10`` (the forward rows), ``k10_bwd``,
``paths`` (``dense``, ``active``, ``2a``) and ``ptxas``; the launch floor
is always measured, and only the kernels of the groups kept are built.

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
from repro_torch.core.exec_bsp import make_bsp_fixed_runner
from repro_torch.core.exec_common import out_edge_table
from repro_torch.core.network import make_network
from repro_torch.core.morphology import ball_and_stick, branched_tree
from repro_torch.kernels import build
from repro_torch.kernels.event_wheel import ops as ew_ops
from repro_torch.kernels.event_wheel import ref as ew_ref
from repro_torch.kernels.hines import ops as h_ops
from repro_torch.kernels.hines import ref as h_ref


def want(group):
    return ONLY is None or group in ONLY


build.build_all(tuple(
    src for src, groups in (
        ("hines", ("hines", "paths")), ("hh_rhs", ("paths",)),
        ("horizon", ("events", "paths")), ("compact", ("events", "paths")),
        ("segment_rank", ("events", "paths")),
        ("flash_attention", ("k10",)), ("flash_prefill", ("k10", "k10_bwd")),
        ("flash_decode", ("k10",)), ("flash_backward", ("k10_bwd",)))
    if any(want(g) for g in groups)))
dev = torch.device("cuda")
N = cs.N_MAIN


def host_us(fn, calls=1000, reps=5):
    # (calls back to back: a device-bound call measures its device time)
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


def hines_rows():
    model, d, fac, b = cs._hines_case(branched_tree(depth=2, seg_per_branch=2),
                                      dev, N)
    C, p = model.C, model.params
    dT, bT = d.T, b.T
    out["k1"] = timed(lambda: h_ops.hines_factor(p.parent, p.g_axial, dT),
                      h_ref.hines_factor_ref(p.parent, p.g_axial, dT))
    fac[:, :C] = h_ops.hines_factor(p.parent, p.g_axial, dT).T
    deT = fac[:, :C].T
    want = h_ref.hines_solve_factored_ref(p.parent, p.g_axial, deT, bT)
    out["k2"] = timed(lambda: h_ops.hines_solve_factored(p.parent, p.g_axial,
                                                         deT, bT), want)
    for key, morph in (("k3", branched_tree(depth=2, seg_per_branch=2)),
                       ("k3_c11", ball_and_stick())):
        m3, d3, _, b3 = cs._hines_case(morph, dev, N)
        q = m3.params
        out[key] = timed(lambda: h_ops.hines_solve(q.parent, q.g_axial, d3.T,
                                                   b3.T),
                         h_ref.hines_solve_ref(q.parent, q.g_axial, d3.T, b3.T))

    # K1, K2 and K3 on the warp frame at the detailed cell's C = 1021, N =
    # 4096 (chip_smoke.py phase 2's timed rows, the same layouts); a tree
    # without the warp frame skips these keys
    from repro_torch.kernels.hines import hines as h_cuda
    if hasattr(h_cuda, "plan"):
        mw, dw, facw, bw = cs._hines_case(
            branched_tree(depth=cs.DETAILED_DEPTH, seg_per_branch=2), dev,
            cs.DETAILED_N)
        Cw, pw = mw.C, mw.params
        dwT, bwT = dw.T, bw.T
        out["k1_1021"] = timed(
            lambda: h_ops.hines_factor(pw.parent, pw.g_axial, dwT),
            h_ref.hines_factor_ref(pw.parent, pw.g_axial, dwT))
        facw[:, :Cw] = h_ops.hines_factor(pw.parent, pw.g_axial, dwT).T
        dewT = facw[:, :Cw].T
        out["k2_1021"] = timed(
            lambda: h_ops.hines_solve_factored(pw.parent, pw.g_axial, dewT,
                                               bwT),
            h_ref.hines_solve_factored_ref(pw.parent, pw.g_axial, dewT, bwT))
        out["k3_1021"] = timed(
            lambda: h_ops.hines_solve(pw.parent, pw.g_axial, dwT, bwT),
            h_ref.hines_solve_ref(pw.parent, pw.g_axial, dwT, bwT))
        for key, k in (("k1_1021", "hines_factor"),
                       ("k2_1021", "hines_solve_factored"),
                       ("k3_1021", "hines_solve")):
            if hasattr(h_cuda, "blocks_per_sm"):   # the several-neuron frame
                tree = h_cuda.schedule(pw.parent)
                tables = h_cuda.warp_tables(Cw, tree.words.numel(), tree.F)
                out[key]["plan"] = list(h_cuda.plan(Cw, k, tables))
                out[key]["blocks_per_sm"] = h_cuda.blocks_per_sm(k, Cw,
                                                                 tables)
            else:
                out[key]["plan"] = list(h_cuda.plan(Cw, k))
        del mw, dw, facw, bw, dewT


out = {"launch_floor_ms": cs.launch_floor_ms()}
if want("hines"):
    hines_rows()

if want("events"):
    mask = torch.from_numpy(np.random.default_rng(7).random(N) < 0.5).to(dev)
    out["k6"] = timed(lambda: ew_ops.compact_ids(mask, N),
                      ew_ref.compact_ids_ref(mask, N))
    out["nonzero"] = dict(ms=cs.cuda_ms(lambda: torch.nonzero(mask)),
                          device_ms=cs.profiled_device_ms(
                              lambda: torch.nonzero(mask)))

    net = make_network(N, k_in=cs.K_IN, seed=cs.NET_SEED)
    pre, dly = ew_ops.by_post_layout(net, dev)
    g5 = torch.Generator(device="cpu").manual_seed(5)
    tc = (torch.rand(N, generator=g5, dtype=torch.float64) * 20.0).to(dev)
    tc[:64] = 20.0
    hkw = dict(t_end=20.0, horizon_cap=2.0)
    out["k5"] = timed(lambda: ew_ops.horizon_score(tc, pre, dly, **hkw),
                      ew_ref.horizon_gather_ref(tc, pre, dly, **hkw))
    table = torch.as_tensor(out_edge_table(net), device=dev).contiguous()
    n_edges = int(net.post.shape[0])
    spk = np.zeros(N, bool)
    spk[np.random.default_rng(23).choice(N, 1866, replace=False)] = True
    spk = torch.from_numpy(spk).to(dev)
    out["k7"] = timed(lambda: ew_ops.compact_gather(spk, table, 128,
                                                    fill=n_edges),
                      ew_ref.compact_gather_ref(spk, table, 128, n_edges))

    # K8's keys as the active path's compact fan-out makes them: 123 spiking
    # neurons' rows of the out-edge table in a batch of 128 rows (the auto
    # spike cap), key = post * B + bucket for each real edge, N * B for the
    # table's padding and the empty rows
    gen = np.random.default_rng(19)
    B, S = 16, 19
    rows = out_edge_table(net)
    batch = np.full((128, rows.shape[1]), n_edges)
    batch[:123] = rows[gen.choice(N, 123, replace=False)]
    real = batch < n_edges
    post = np.asarray(net.post)[np.minimum(batch, n_edges - 1)]
    key = np.where(real, post * B + gen.integers(0, B, batch.shape), N * B)
    key = torch.from_numpy(key.reshape(-1).astype(np.int32)).to(dev)
    out["k8"] = timed(lambda: ew_ops.segment_rank(key, S),
                      ew_ref.segment_rank_ref(key, S))
    D, M, cap = 4, 4096, 2048
    pm = torch.from_numpy(gen.random((M, D)) < 1436 / (D * M)).to(dev).T
    pv = torch.from_numpy(gen.random(M) * 20.0).to(dev)[None, :].expand(D, M)
    out["k9"] = timed(lambda: ew_ops.spike_compact(pm, pv, cap),
                      ew_ref.compact_rows_ref(pm, pv, cap))

import hashlib
from repro_torch.kernels.attention import ops as a_ops
from repro_torch.kernels.attention import ref as a_ref

if want("k10"):
    def k10(dtype, B, H, Hkv, Sq, Skv, D, kv_len, calls):
        q, k, v = cs._attn_inputs(dev, dtype, B, H, Hkv, Sq, Skv, D)
        offset = None if kv_len is None else kv_len - Sq
        kw = dict(causal=True, offset=offset, kv_len=kv_len)
        fn = lambda: a_ops.flash_attention(q, k, v, out_dtype=torch.float32,
                                           **kw)
        build.reset_launches()
        got = fn()
        ran = [n for n, c in build.launches().items()
               if c and n.startswith("flash_attention_")]
        want = a_ref.flash_attention_ref(q, k, v, True, offset, kv_len,
                                         torch.float32)
        kv = kv_len or Skv
        ks, vs = k[:, :, :kv], v[:, :, :kv]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row = dict(kernel=ran, max_abs_err=float((got - want).abs().max()),
                   ms=cs.cuda_ms(fn), device_ms=cs.device_ms(fn),
                   host_us=host_us(fn, calls=calls),
                   sdpa_device_ms=cs.device_ms(lambda: sdpa(
                       q, ks, vs, is_causal=Sq > 1, enable_gqa=True)))
        if dtype == torch.bfloat16:
            for o in (torch.bfloat16, torch.float32):
                x = a_ops.flash_attention(q, k, v, out_dtype=o, **kw)
                row[f"sha256_{str(o)[6:]}"] = hashlib.sha256(
                    x.float().cpu().contiguous().numpy().tobytes()).hexdigest()
        return row


    torch.backends.cuda.matmul.allow_tf32 = False      # plain version in fp32
    for key, dtype, shape, calls in (
            ("k10_f32_decode", torch.float32, (3, 4, 2, 1, 48, 16, 23), 1000),
            ("k10_f32_decode_4096", torch.float32, (4, 9, 3, 1, 4096, 64, 4096),
             1000),
            ("k10_f32_prefill", torch.float32, (4, 9, 3, 2048, 2048, 64, None),
             50),
            ("k10_bf16_decode", torch.bfloat16, (4, 9, 3, 1, 256, 64, 256),
             1000),
            ("k10_bf16_decode_4096", torch.bfloat16,
             (4, 9, 3, 1, 4096, 64, 4096), 1000),
            ("k10_bf16_prefill", torch.bfloat16,
             (4, 9, 3, 2048, 2048, 64, None), 200)):
        out[key] = k10(dtype, *shape, calls)

from repro_torch.kernels.attention.flash_backward import \
    flash_attention_bwd_cuda

if want("k10_bwd"):


    def k10_bwd(dtype, B, H, Hkv, Sq, Skv, D, calls, bf16_do):
        q, k, v, o, do = cs._bwd_inputs(dev, dtype, B, H, Hkv, Sq, Skv, D, True)
        if bf16_do:
            do = do.to(torch.bfloat16).float()
        fn = lambda: flash_attention_bwd_cuda(q, k, v, o, do, True)
        got = fn()
        want = a_ref.flash_attention_bwd_ref(q, k, v, o, do, True)
        return dict(
            max_abs_err=max(float((g.float() - w.float()).abs().max())
                            for g, w in zip(got, want)),
            ms=cs.cuda_ms(fn), device_ms=cs.device_ms(fn),
            host_us=host_us(fn, calls=calls),
            sha256=hashlib.sha256(b"".join(
                x.float().cpu().contiguous().numpy().tobytes()
                for x in got)).hexdigest())


    SMOLLM, LONG = (8, 9, 3, 256, 256, 64), (4, 9, 3, 2048, 2048, 64)
    for key, dtype, shape, calls, bf16_do in (
            ("k10_bwd_bf16", torch.bfloat16, SMOLLM, 200, True),
            ("k10_bwd_bf16_2048", torch.bfloat16, LONG, 20, True),
            ("k10_bwd_bf16_f32do", torch.bfloat16, SMOLLM, 200, False),
            ("k10_bwd_bf16_2048_f32do", torch.bfloat16, LONG, 20, False),
            ("k10_bwd_f32", torch.float32, SMOLLM, 200, False),
            ("k10_bwd_f32_2048", torch.float32, LONG, 20, False)):
        out[key] = k10_bwd(dtype, *shape, calls, bf16_do)


if want("paths"):
    def launches():
        n = build.launches()
        return {k: n[k] for k in ("hines_factor", "hines_solve_factored",
                                  "hines_solve", "horizon_score", "compact_ids",
                                  "compact_gather", "segment_rank")}


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
        out[name] = dict(ms_round=wall / rounds * 1e3, rounds=rounds,
                         spikes=int(res.rec.count.sum()), launches=launches())

    if T_END > 0:
        model, net = cs._baseline_model_net(dev, N)
        run = make_bsp_fixed_runner(model, net, cs.regime_currents(N), T_END,
                                    method="derivimplicit", device=dev)
        build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cs._gate_run("2a", res)
        out["2a"] = dict(ms_window=wall / run.n_windows * 1e3,
                         windows=run.n_windows, spikes=int(res.rec.count.sum()),
                         launches=launches())

if want("ptxas"):
    ptxas = {}
    for src, kern in (("hines", "hines_factor_kernel"),
                      ("hines", "hines_solve_factored_kernel"),
                      ("hines", "hines_solve_kernel"),
                      ("hines", "hines_warp_kernel"),
                      ("horizon", "horizon_kernel"),
                      ("compact", "compact_ids_kernel"),
                      ("compact", "compact_gather_kernel"),
                      ("compact", "compact_rows_kernel"),
                      ("segment_rank", "segment_rank_kernel"),
                      ("flash_attention", "flash_attention_kernel"),
                      ("flash_decode", "flash_decode_f32_kernel"),
                      ("flash_decode", "flash_decode_kernel"),
                      ("flash_prefill", "flash_prefill_kernel"),
                      ("flash_backward", "flash_bwd_dq"),
                      ("flash_backward", "flash_bwd_dkdv")):
        entry = None
        for line in build.ptxas_log(src).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif entry and kern in entry and ("registers" in line
                                              or "spill" in line):
                # templated kernels: one entry per instantiation
                ptxas.setdefault(kern, {}).setdefault(entry, []).append(
                    line.split(":", 2)[-1].strip())
    out["ptxas"] = ptxas
print("RESULT " + json.dumps(out))
'''


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", help="root of the tree run as A")
    ap.add_argument("new", nargs="*", default=[str(HARNESS)],
                    help="roots of the trees run as B, C, ... (default: "
                         "this one as B)")
    ap.add_argument("--order", default="ABBA",
                    help="the runs, in turn (default ABBA)")
    ap.add_argument("--t-end", type=float, default=12.0,
                    help="simulated ms of the dense, active and 2a runs "
                         "(0: skip them)")
    ap.add_argument("--only", default=None,
                    help="comma-separated groups to measure (default: all)")
    args = ap.parse_args(argv)
    trees = dict(zip("ABCDEFGH", [args.base, *args.new]))
    only = None if args.only is None else tuple(args.only.split(","))
    worker = (f"HARNESS = {str(HARNESS)!r}\nT_END = {args.t_end!r}\n"
              f"ONLY = {only!r}\n" + WORKER)
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
