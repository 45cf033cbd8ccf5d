"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--t-end MS] [--out FILE] [--profile ROUNDS]

Phases, each reported on its own lines:

  1. setup: the card (nvidia-smi name and power limit), torch's CUDA, nvcc,
     ninja, and the parallel nvcc build of every kernel source;
  2. the per-step and horizon kernels against their plain PyTorch versions
     on the card, at the main path's shapes (K1/K2/K4 at N=16384 with C=13
     and C=1, K5 at K=16; K1, K2 and K5 bitwise, K3 == K2(K1); K1/K2 also
     at C=29 and at N=16421, K5 at N 1, 255, 16385 x K 1, 5, 16, 33 with
     clocks at t_end, +-inf and NaN, untimed), with each kernel's time per call
     (CUDA events around each of 25 calls, median: the wrapper's host work
     included),
     its device time (events around the replay of a CUDA graph of 50
     launches; phases 5, 8, 13 and 15 time alike) and its bound, and the
     launch floor (the device time of a one-element in-place ``add_``);
  3. the dense main path at full width: ``make_fap_vardt_runner`` on the
     branched cell (C=13), 16384 neurons with 16 synapses each,
     regime-mixed currents, ``horizon_impl="fused"`` -- with the kernels'
     launch counts;
  4. the active-set path at the same width, cell, network, currents and
     t_end: ``batch="compact", batch_cap="auto", fanout="compact",
     spike_cap="auto", queue="wheel", wheel=WheelSpec.auto(net)`` -- all
     seven kernels must launch (the auto caps' dense probe is part of it);
  5. the scheduler kernels K6/K7/K8 against their plain versions on the
     card, bitwise, at the active path's shapes: its auto caps, the edge
     table of its network, a spike mask and a key batch that the path
     itself produced (with timings, bounds and ``torch.nonzero`` beside
     K6), K6 at ragged N on mask views 1-15 bytes off alignment, K7 at
     caps 1 and N, MO 1 and 64 on mask views 1-15 bytes off, and K8
     also at max_rank 0, on all-equal keys and on batches of the path's
     pattern at E = 4225, 18000 and 60000 (its chunked staging);
  6. the dense path at N=64, 4 ms, on the card (kernels) and on the CPU
     (plain versions): spike trains and final states bitwise equal (the
     port rounds alike on both, ``repro_torch/core/detmath.py``);
  7. the active path at N=64, 6 ms, with a binding batch cap and a small
     spike cap (roll-over and dense fan-out fallback both run): card and
     CPU bitwise equal; on the card ``batch_cap=0`` equals the dense path
     exactly;
  8. the fused Hines solve K3 against its plain version and against
     K2(K1(d), b), bitwise, at N=16384 on the branched cell (C=13) and the
     ball-and-stick cell (C=11), with its timing, its bound and the dense
     ``torch.linalg.solve`` on the same systems beside it;
  9. the paper's baseline method 2a at full width: ``make_bsp_fixed_runner(
     method="derivimplicit")`` on phase 3's cell, network, currents and
     t_end -- K3 once per step -- reported beside phase 3's 2c run;
 10. the other baselines: 1a BSP-fixed equals 1c FAP-fixed (full width,
     10 ms); 2b BSP-vardt dense equals compact with a cap below the
     frontier (N=4096, 5 ms); 2c under ``jac_policy="iteration"`` (full
     width, 5 ms: nsetups == nni, K3 launched, K1/K2 not);
 11. 2a and 2c-iteration at N=64, 6 ms, on the card and on the CPU: spike
     trains, steps and final states bitwise equal;
 12. the SPMD round (``repro_torch.distributed.run_fap_spmd``) at full
     width and 4 ms: four ranks share the card over gloo, on phase 3's
     cell, network and currents, once with ``transport="sparse"`` and the
     dense knobs and once with the full stack (``sparse_ragged``, compact
     batch and fan-out, wheel queue, incremental horizon): both reach
     t_end with nothing dropped, have equal spike counts, events and
     steps, and launch K9, K1, K2, K4 on every rank (K6-K8 in the full
     stack); per channel bytes and host wall per round beside the
     allgather transport's bytes, and the fullest rank pair's parcel of
     each round;
 13. the parcel packer K9 against its plain version on the card, bitwise,
     at the SPMD path's shapes (D = 4 ranks, M = 4096, its parcel cap):
     masks of 0-100 %, a row over the cap and a mask phase 12 produced
     (timed in the transport's transposed layout); then D = 1, 3, 4 and 8
     at M = 4096 and 4097, transposed, in contiguous rows and as views
     1-15 bytes past an aligned base;
 14. the SPMD round at N=256, 4 ms, on the card: ``allgather`` == ``sparse`` ==
     the global round (``optimized=False``) == the single-host
     ``run_fap_vardt(step_budget=8)``, and four card ranks == four CPU
     ranks bitwise for ``sparse`` and for the global round (spike trains,
     steps, final states);
 15. flash attention K10's four kernels against their plain version on
     the card, bf16 (bf16 and float32 out) and float32, each case checking
     which kernel ran (all four must): the serve path's shapes (prefill
     B=4, S=2048, H=9, Hkv=3, D=64; decode at kv_len 1, 37, 255, 256, 2048
     and 4096), decode with several query rows, ragged Sq and Skv,
     bidirectional, groups 1, 3 and 8, D 16/64/128 (deepseek-7b's and
     qwen2-72b's heads) and zamba2-7b's D = 112 (prefill B=2, S=128,
     H=Hkv=32; decode B=4 at kv_len 1, 37, 256); times of the prefill and
     of decode at kv_len 256 and 4096 (bf16 in), of zamba2's D = 112
     prefill and decode at kv_len 256 (bf16 in), and of the float32
     kernels at the prefill and at decode kv_len 4096 (printed only),
     beside the plain version,
     ``scaled_dot_product_attention`` (a yardstick only) and the bound;
     the decode kernels' device time by kv splits;
 16. the LM serve path at full width: smollm-135m on the card from a
     seeded generator, ``lm.prefill`` of 4 x 2048 tokens (K10 once per
     layer, all by the prefill kernel), then ``launch.serve.lm_main`` at
     its CLI defaults: every request served, no non-finite logits, K10
     launched 30 times per decode step, all by the decode kernel; tok/s,
     ms per step, peak memory;
 17. the LM path card against CPU: reduced smollm-135m with the same
     weights in float32 (K10's float32 kernels) and bf16 compute (its bf16
     kernels): a 2 x 40-token prefill (the prefill kernels) and a short
     serve run (the decode kernels) whose logits agree within a stated
     tolerance, the CPU's greedy picks differing from the card's only
     where its top two logits lie within it; the float32 kernels timed at
     the shapes these runs called them with most, at the median kv length
     of those calls (their ``kernels`` entries);
 18. the plastic cell under the Schur preconditioner at full width:
     ``make_fap_vardt_runner`` on the branched cell with
     ``with_plasticity=True`` (n_state 56) and ``BDFOptions(
     precond="schur")``, phase 3's network, currents, horizon and t_end:
     it reaches t_end, fails nothing, drops nothing, spikes, keeps every
     rho in [0, 1] and launches K1, K2, K4 and K5; rounds, steps, nni,
     nncf, nsetups and wall beside phase 3's;
 19. carefully-speculative 2c at full width: ``make_spec_runner`` on phase
     3's cell, network and currents, 4 ms, with ``fanout="compact"``
     (phase 4's spike cap) and ``queue="wheel"``: nothing failed or
     dropped, hits + backsteps > 0, wasted steps >= backsteps, K1, K2, K4,
     K7 and K8 launched, total spikes within max(2, 10 %) of phase 3's
     spikes before 4 ms; its ``SpecStats``, rounds, validated steps and
     wall;
 20. phases 18 and 19's paths at N=64, 4 ms, card against CPU: 2c on the
     plastic cell under schur with ``jac_policy`` "reuse" (K1/K2) and
     "iteration" (K3), and the speculative runner with dense and with
     compact fan-out: spike trains, steps, counters (solver counters,
     ``SpecStats``) and final states bitwise equal; on the card the
     speculative dense fan-out equals the compact one event for event;
 22. phase 3's runner at full width with ``checkpoint_every=8``: a
     ``FaultPlan`` kill at 0.6 of phase 3's rounds raises
     ``SimulatedFailure`` at that round, and ``resume=True`` reproduces
     phase 3 bitwise (spike trains, steps, solver and sched counters, the
     final ``zn[:, 0]``), launching K1, K2, K4 and K5; checkpoint bytes, ms
     per save and per restore;
 23. ``SimService`` at full width: 4 lanes of phase 3's network (65,536
     neurons a round), 8 tenants of 3 ms with currents in [i_active,
     i_burst] of the branched cell, QoS class 0 capped at N/4, the fused
     horizon and tenant 1 poisoned at its round 4: every request
     completes, at least one quarantine, tenant 1 and tenant 0 bitwise
     equal to their solo 1-lane services, spikes, K1, K2, K4 and K5
     launched; rounds, ms per service round beside phase 3's, tenant-ms per
     wall second, admission waits, peak memory;
 24. card against CPU at N=64, bitwise: kill/resume and poison rollback
     at 4 ms (each also equal to the plain run), and a 3-lane, 5-tenant
     service of 3 ms with a poisoned tenant, and its first 3 tenants over
     two compact runners (compact batch at N/2 and fan-out at spike cap 4,
     wheel; the incremental scatter horizon, and the fused one), the rows
     forms of K6 and K7 launched; then the SPMD round at
     N=256, 4 ms on four card ranks (sparse, compact, incremental
     horizon) killed and resumed on four ranks and on two (the elastic
     reseed), bitwise the uninterrupted run;
 25. the other LM families at full width: whisper-base, rwkv6-7b,
     zamba2-7b and qwen3-moe-30b-a3b (16 of its 48 layers: its experts do
     not fit the card at 48), weights drawn on the card: ``lm.prefill`` of
     2 x 128 tokens (whisper also 2 x 1500 frames) and
     ``serve.serve_requests`` of 4 requests, 4 slots, max-new 8, cache 64:
     every request served, no non-finite logit, peak memory below 75 GiB,
     K10 launched exactly as the family needs it (per decode step /
     prefill: qwen3-moe 16 / 16, zamba2 13 / 13 at D = 112, whisper 12 /
     18, rwkv6 0 / 0), all by the decode / prefill kernel; ms per step,
     tok/s, prefill ms, init seconds, peak memory;
 26. phase 17 on the reduced qwen3-moe-30b-a3b, arctic-480b, rwkv6-7b,
     zamba2-7b and whisper-base, float32 and bf16 compute: card and CPU
     logits within ``LM_TOL``, greedy picks differing only at top-2 ties,
     every MoE layer's expert assignments and keep masks equal on both
     devices (in bf16 compute apart only at ties of the probabilities,
     and the ranks such a tie moves);
 27. K10's backward (``csrc/flash_backward.cu``, two kernels: dq, then dk
     and dv) against its plain version on the card, bf16 and float32:
     smollm-135m's training shape (B 8, S 256, H 9, Hkv 3, D 64, causal),
     4 x 2048, D 16 (ragged), zamba2-7b's D = 112, group 8 at D = 128,
     whisper's encoder (1500 x 1500, bidirectional) and cross-attention
     (Sq 128, Skv 1500): within 1e-5 (1 + |ref|) (+ 2**-7 |ref| for bf16
     outputs), a second call bitwise the first; each case's ms per call,
     device ms, bound, plain version and SDPA's backward;
 28. smollm-135m trained at full width by ``launch/train.py`` at its
     defaults (batch 8, seq 256, lr 3e-4, WSD), 30 steps, saved every
     10: the loss falls, K10's forward and both backward kernels launch
     30 layers x 30 steps; a run killed at step 17 and resumed from step
     10 gives the uninterrupted losses bitwise; ms a step, tok/s, peak
     memory;
 29. whisper-base trained at full width (3 steps on one batch: finite,
     falling), and every family's reduced config (dense, vlm, moe, ssm,
     hybrid, audio; float32) and the dense one in bf16 compute: 3
     ``train_step``s card against CPU, gradients, losses, grad norms and
     parameters within stated tolerances;
 30. the global SPMD round (``build_fap_round(optimized=False)``, the
     paper-faithful baseline) at full width and 4 ms, four ranks on the
     card, ``queue="dense"``: against phase 12's ``sparse`` run, spike
     counts per neuron, events, steps, resets and rounds exact, nothing
     dropped, spike times within 1e-9 ms (and whether all is bitwise);
     K1, K2 and K4 launched on every rank; ms per round and each
     channel's bytes and host wall per round beside phase 12's;
 31. ``SimService`` at full width over the active-set runner: phase 23's
     lanes, tenants, currents, QoS classes, t_end and poisoned tenant,
     ``batch="compact", batch_cap=N/4, fanout="compact"`` at phase 4's
     spike cap, ``queue="wheel"``, the fused horizon: every request
     completes, the poisoned tenant is quarantined and retried, tenants 1
     and 0 bitwise equal to their solo services, the rows forms of K6 and
     K7 and K8 launched; both rows kernels against their plain versions,
     bitwise, on the busiest masks the service gave them and on masks of
     0-100 %, with their times and bounds; ms per service round and
     tenant-ms per wall second beside phase 23's;
 32. the dry run (``launch/dryrun.py``) against the card: smollm-135m on
     the ``meta`` device at phase 28's training shape (batch 8 x seq 256,
     an AdamW step under ``remat`` at lr 1e-4) and phase 16's decode shape
     (4 slots, cache 256), on the card's own (1, 1) mesh, where every
     collective term is 0; then the same training step for real on the
     card, after a warm-up step: its ``max_memory_allocated`` against the
     dry run's ``peak_bytes_one_device`` within ``MEM_RATIO``, K10's
     forward (the bf16 prefill kernel, twice a layer under ``remat``) and
     both backward kernels launched (counts zeroed just before it), and
     one real decode step (the decode kernel once a layer); the step's
     bound from ``counted_flops`` at 67 TFLOP/s (float32, what
     ``common.mm`` runs) and 989 TFLOP/s (bf16) and the measured ms's
     share of each, printed beside the card's name and power limit;
 21. with ``--profile ROUNDS`` only: a ``torch.profiler`` trace of that many
     full-width rounds of the dense and of the active path, and of that
     many full-width decode steps of the serve path and of phase 25's
     four families, and of that many full-width smollm-135m training
     steps (device busy share, busiest kernels).

Phases 3, 4, 9, 18 and 22 run 5 ms (``--t-end``; phase 4's auto-cap
probe runs min(t_end, 5) ms, so its caps, and phase 31's, are those of
a 6 ms run), the SPMD phases 12 and 30 and the speculative phase 19 4
ms.  Each phase's wall is
printed as it ends (``[wall]``) and all of them on the ``[done]`` line.
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
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# Regime mix of the paper's Fig. 10 (benchmarks/lab_experiment_fig8.py) and
# the branched cell's threshold current (benchmarks/_calibration.json).
PCTS = {"quiet": 0.3143, "slow": 0.3844, "moderate": 0.2702,
        "fast": 0.0310, "burst": 0.0001}
I_THRESH_BRANCHED = 0.1083984375
I_ACTIVE_BRANCHED = 0.30332508087158205    # ... and its active and burst
I_BURST_BRANCHED = 0.33084812164306643     # currents (same file)
N_MAIN, K_IN, NET_SEED = 16384, 16, 11
RTOL, ATOL = 1e-12, 1e-14
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP64_FLOPS = 34e12             # H100 SXM fp64 outside the tensor cores
#                                (NVIDIA data sheet)
INT32_OPS = 33.5e12            # H100 SXM5 peak INT32 outside the tensor cores
#                                (NVIDIA H100 Tensor Core GPU Architecture
#                                white paper, table of peak rates)
SRC = "src/repro_torch/csrc"
REPLACES = {
    "hines_factor": "src/repro/kernels/hines/hines.py:163",
    "hines_solve_factored": "src/repro/kernels/hines/hines.py:188",
    "hines_solve": "src/repro/kernels/hines/hines.py:73",
    "hh_rhs": "src/repro/kernels/hh_rhs/hh_rhs.py:46",
    "horizon_score": "src/repro/kernels/event_wheel/event_wheel.py:38",
    "compact_ids": "src/repro/kernels/event_wheel/event_wheel.py:115",
    "compact_gather": "src/repro/kernels/event_wheel/event_wheel.py:176",
    # the rows forms: what JAX's vmap over the service's tenants makes of
    # the same two Pallas kernels
    "compact_ids_rows": "src/repro/kernels/event_wheel/event_wheel.py:115",
    "compact_gather_rows":
        "src/repro/kernels/event_wheel/event_wheel.py:176",
    "segment_rank": "src/repro/kernels/event_wheel/event_wheel.py:234",
    "compact_rows": "src/repro/kernels/event_wheel/event_wheel.py:256",
    "flash_attention_f32_decode": "src/repro/kernels/attention/flash.py:65",
    "flash_attention_f32_prefill": "src/repro/kernels/attention/flash.py:65",
    "flash_attention_prefill": "src/repro/kernels/attention/flash.py:65",
    "flash_attention_decode": "src/repro/kernels/attention/flash.py:65",
    # no TPU kernel: the JAX package differentiates its jnp attention
    "flash_attention_bwd": "src/repro/models/attention.py:22, :96",
}
SOURCE = {"hines_factor": f"{SRC}/hines.cu",
          "hines_solve_factored": f"{SRC}/hines.cu",
          "hines_solve": f"{SRC}/hines.cu",
          "hh_rhs": f"{SRC}/hh_rhs.cu", "horizon_score": f"{SRC}/horizon.cu",
          "compact_ids": f"{SRC}/compact.cu",
          "compact_gather": f"{SRC}/compact.cu",
          "compact_ids_rows": f"{SRC}/compact.cu",
          "compact_gather_rows": f"{SRC}/compact.cu",
          "segment_rank": f"{SRC}/segment_rank.cu",
          "compact_rows": f"{SRC}/compact.cu",
          "flash_attention_f32_decode": f"{SRC}/flash_decode.cu",
          "flash_attention_f32_prefill": f"{SRC}/flash_attention.cu",
          "flash_attention_prefill": f"{SRC}/flash_prefill.cu",
          "flash_attention_decode": f"{SRC}/flash_decode.cu",
          "flash_attention_bwd": f"{SRC}/flash_backward.cu"}
K10_KERNELS = ("flash_attention_f32_decode", "flash_attention_f32_prefill",
               "flash_attention_prefill", "flash_attention_decode")
ROW_KEYS = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms")
OUR_KERNELS = ("hines_factor_kernel", "hines_solve_factored_kernel",
               "hines_solve_kernel",
               "hh_rhs_kernel", "horizon_kernel", "compact_ids_kernel",
               "compact_gather_kernel", "compact_ids_rows_kernel",
               "compact_gather_rows_kernel", "segment_rank_kernel",
               "compact_rows_kernel", "flash_attention_kernel",
               "flash_prefill_kernel", "flash_decode_kernel",
               "flash_decode_f32_kernel", "flash_decode_merge_kernel",
               "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel",
               "flash_bwd_dq_mma_kernel", "flash_bwd_dkdv_mma_kernel")
DENSE_PATH = ("hines_factor", "hines_solve_factored", "hh_rhs",
              "horizon_score")
ACTIVE_PATH = DENSE_PATH + ("compact_ids", "compact_gather", "segment_rank")
BASELINE_PATH = ("hines_solve",)
SPEC_PATH = ("hines_factor", "hines_solve_factored", "hh_rhs",
             "compact_gather", "segment_rank")
ACTIVE = dict(batch="compact", batch_cap="auto", fanout="compact",
              spike_cap="auto", queue="wheel")
RANKS = 4                      # SPMD ranks, all on cuda:0 (one card)
SPMD_T_END = 4.0               # simulated ms of the full-width SPMD runs
SPEC_T_END = 4.0               # ... and of the speculative run (phase 19)
PARCEL_CAP = 2048              # parcel slots per (source, dest) rank pair
SPMD_PATH = ("hines_factor", "hines_solve_factored", "hh_rhs",
             "compact_rows")
SPMD_RUNS = {
    "sparse": dict(transport="sparse"),
    "full_stack": dict(transport="sparse_ragged", batch="compact",
                       fanout="compact", queue="wheel",
                       horizon="incremental"),
}
FULL_STACK_PATH = ("compact_ids", "compact_gather", "segment_rank")
GLOBAL_PATH = ("hines_factor", "hines_solve_factored", "hh_rhs")
# the service over the active-set runner (phase 31), and at N = 64 (24)
COMPACT_SERVICE_PATH = ("hines_factor", "hines_solve_factored", "hh_rhs",
                        "horizon_score", "compact_ids_rows",
                        "compact_gather_rows", "segment_rank")
COMPACT_SMALL = dict(batch="compact", fanout="compact", spike_cap=4,
                     queue="wheel")
BF16_FLOPS = 989e12            # H100 SXM bf16 on the tensor cores, dense
#                                (NVIDIA data sheet)
LM_ARCH = "smollm-135m"        # the serve CLI's default --arch
LM_PREFILL = (4, 2048)         # phase 16's prefill: prompts x tokens
# K10 against its plain version (phase 15), element by element: within
# 1e-5 * (1 + |want|) for the order of float32 sums and exp, plus, for
# bf16 inputs, the bound that two bf16 roundings of each p (2**-8 of it
# each, weighed by |v|) and of a bf16 output allow:
# 2**-7 * (sum_j (p_j / l) |v_j| + |o|), ``ref.bf16_rounding_bound``.
ATTN_TOL = 1e-5
# The LM path, card against CPU (phase 17): logits within 1e-4 in float32
# compute (sum order); in bf16 compute within 2**-5 of the largest logit
# (K10 and the CPU's plain version round p alike, but a bf16 rounding of
# an activation that lands on the other side flips by 2**-8 of it, and
# such flips compound over the layers and the logit GEMM).
LM_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -5}
# MoE routing, card against CPU (phase 26): equal in float32 compute; in
# bf16 compute a token may take other experts only where the CPU's
# probabilities of them lie within 2**-9 of its largest -- the half-ulp of
# one bf16 rounding of the router's input landing on the other side.  The
# phase prints the widest gap it saw.
ROUTE_TIE = {"float32": 0.0, "bfloat16": 2.0 ** -9}


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


def device_ms(fn, launches=50, reps=5):
    """Device time of one call: CUDA events around the replay of a CUDA
    graph of ``launches`` calls captured on the current stream (median of
    ``reps`` replays), so the wrapper's host work is not in the figure."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    del graph
    torch.cuda.synchronize()
    return statistics.median(times)


def launch_floor_ms():
    """The device time of the smallest launch: a one-element in-place
    ``torch.add_`` in ``device_ms``'s CUDA graph of 50 launches."""
    one = torch.zeros(1, dtype=torch.float64, device="cuda")
    return device_ms(lambda: one.add_(1.0))


def profiled_device_ms(fn, calls=20, tries=3):
    """Device time of one call of a function that a CUDA graph cannot
    capture, because it waits for the card (``torch.nonzero``'s count,
    ``torch.linalg.solve``'s error check): ``torch.profiler``'s summed
    device time of the kernels it runs, over ``calls`` calls.  A trace
    that holds no device time is taken again, ``tries`` times in all."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if str(e.device_type).endswith("CUDA"))
        if us > 0:
            return us / calls / 1e3
    raise AssertionError(f"the profiler saw no device time in {tries} "
                         "traces")


def queued_device_ms(fn, host_ms, calls=20, tries=4):
    """Device time of one call of a function that neither a CUDA graph
    nor the profiler sees whole, but that does not wait for the card
    (autograd's backward, whose kernels its engine's thread launches): a
    spin kernel (``torch.cuda._sleep``) holds the stream while the host
    queues ``calls`` calls, and CUDA events around them time the calls
    back to back.  The spin lasts 3x the host's time for the calls
    (``host_ms`` each); it is doubled until the start event is still
    pending when the last call is queued, so no host gap is in the
    figure."""
    fn()
    torch.cuda.synchronize()
    spin_ms = max(20.0, 3 * calls * host_ms)
    for _ in range(tries):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * 2e6))     # >= spin_ms at <= 2 GHz
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        queued = not a.query()
        b.synchronize()
        if queued:
            return a.elapsed_time(b) / calls
        spin_ms *= 2
    raise AssertionError(f"the host did not queue {calls} calls within a "
                         f"{spin_ms / 2:.0f} ms spin")


def kernel_row(err, fn, plain, nbytes, ops, rate=FP64_FLOPS, library=None,
               library_device=None):
    """A kernel's line of the ``kernels`` table: its error against the
    plain version, per-call and device times, the plain version's and the
    library call's times, and the bound of ``nbytes`` and ``ops``.  The
    library call's device time comes from ``device_ms``, or from
    ``library_device`` (``profiled_device_ms`` for a call that waits for
    the card, ``"queued"`` for ``queued_device_ms``)."""
    bound, by = bound_ms(nbytes, ops, rate)
    row = dict(max_abs_err=err, ms=cuda_ms(fn), device_ms=device_ms(fn),
               plain_ms=cuda_ms(plain), bound_ms=bound, bound_by=by,
               library_ms=None, library_device_ms=None)
    if library is not None:
        row["library_ms"] = cuda_ms(library)
        if library_device == "queued":
            row["library_device_ms"] = queued_device_ms(library,
                                                        row["library_ms"])
        else:
            row["library_device_ms"] = (library_device or device_ms)(library)
    return row


def fmt_row(row):
    lib = "" if row["library_ms"] is None else (
        f", library {row['library_ms']:.4f} ms (device "
        f"{row['library_device_ms']:.5f})")
    return (f"{row['ms']:.4f} ms per call, device {row['device_ms']:.5f} ms, "
            f"plain {row['plain_ms']:.4f} ms{lib}, bound "
            f"{row['bound_ms']:.6f} ms ({row['bound_by']})")


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


def bound_ms(nbytes, ops, rate=FP64_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
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
    from repro_torch.kernels.hines import hines as h_cuda
    from repro_torch.kernels.hines import ops as h_ops
    from repro_torch.kernels.hines import ref as h_ref

    N = N_MAIN
    rows = {}
    # (tree, N, timed): the main path's cell first (its rows go into the
    # kernels line), the soma, C = 29 and a ragged N checked only
    cases = ((branched_tree(depth=2, seg_per_branch=2), N, True),
             (soma_only(), N, True), (branched_tree(depth=3), N, False),
             (branched_tree(depth=2, seg_per_branch=2), N + 37, False))
    for morph, n, timed in cases:
        model, d, fac, b = _hines_case(morph, dev, n)
        C, p = model.C, model.params
        # the main path's layouts: transposed [N, C] rows, factor-row slices
        dT = d.T
        de = h_ops.hines_factor(p.parent, p.g_axial, dT)
        fac[:, :C] = de.T
        deT = fac[:, :C].T
        e1 = check_close(f"hines_factor C={C} N={n}", de,
                         h_ref.hines_factor_ref(p.parent, p.g_axial, dT),
                         exact=True)
        x = h_ops.hines_solve_factored(p.parent, p.g_axial, deT, b.T)
        e2 = check_close(f"hines_solve_factored C={C} N={n}", x,
                         h_ref.hines_solve_factored_ref(p.parent, p.g_axial,
                                                        deT, b.T), exact=True)
        check_close(f"hines_solve == K2(K1) C={C} N={n}",
                    h_ops.hines_solve(p.parent, p.g_axial, dT, b.T), x,
                    exact=True)
        Y = torch.cat([torch.rand((n, C), dtype=torch.float64, device=dev)
                       * 120.0 - 80.0,
                       torch.rand((n, 3 * C + 2), dtype=torch.float64,
                                  device=dev)], dim=1)
        v, m, h, nn = (Y[:, i * C:(i + 1) * C] for i in range(4))
        outs = hh_ops.hh_rhs(p.area, v, m, h, nn)
        e4 = max(check_close(f"hh_rhs[{i}] C={C}", o, r) for i, (o, r) in
                 enumerate(zip(outs, hh_ref.hh_rhs_ref(p.area, v, m, h, nn))))
        if not timed:
            say("kernels", f"C={C} N={n}: hines_factor, hines_solve_factored "
                f"bitwise (tiles of {h_cuda.tile_neurons(C)} neurons), "
                f"hines_solve == K2(K1); hh_rhs err {e4:.2e}")
            continue
        ne = n * C
        got = {
            "hines_factor": kernel_row(
                e1, lambda: h_ops.hines_factor(p.parent, p.g_axial, dT),
                lambda: h_ref.hines_factor_ref(p.parent, p.g_axial, dT),
                16 * ne + 12 * C, 3 * (C - 1) * n),
            "hines_solve_factored": kernel_row(
                e2, lambda: h_ops.hines_solve_factored(p.parent, p.g_axial,
                                                       deT, b.T),
                lambda: h_ref.hines_solve_factored_ref(p.parent, p.g_axial,
                                                       deT, b.T),
                24 * ne + 12 * C, (6 * (C - 1) + 1) * n),
            "hh_rhs": kernel_row(
                e4, lambda: hh_ops.hh_rhs(p.area, v, m, h, nn),
                lambda: hh_ref.hh_rhs_ref(p.area, v, m, h, nn),
                72 * ne + 8 * C, 280 * ne)}
        for name, row in got.items():
            say("kernels", f"C={C} N={n}: {name} {fmt_row(row)}; err "
                f"{row['max_abs_err']:.2e}")
        if C > 1:
            rows.update(got)

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
    rows["horizon_score"] = kernel_row(
        e5, lambda: ew_ops.horizon_score(tc, pre, dly, **kw),
        lambda: ew_ref.horizon_gather_ref(tc, pre, dly, **kw),
        12 * K * N + 8 * N + 16 * N, (2 * K + 5) * N)
    say("kernels", f"K={K} N={N}: horizon_score "
        f"{fmt_row(rows['horizon_score'])}; bitwise")
    # ragged N, the generic body's K, clocks at t_end, +-inf and NaN on a
    # tenth of the neurons and neuron 0: bit for bit, NaNs included
    gen5 = np.random.default_rng(55)
    shapes = [(n5, k5) for n5 in (1, 255, N + 1) for k5 in (1, 5, K, 33)]
    for n5, k5 in shapes:
        p5 = torch.from_numpy(gen5.integers(0, n5, (k5, n5))
                              .astype(np.int32)).to(dev)
        d5 = torch.from_numpy(gen5.uniform(0.1, 3.0, (k5, n5))).to(dev)
        for special in (20.0, np.inf, -np.inf, np.nan):
            t5 = gen5.uniform(0.0, 20.0, n5)
            t5[gen5.random(n5) < 0.1] = special
            t5[0] = special
            t5 = torch.from_numpy(t5).to(dev)
            for g, w in zip(ew_ops.horizon_score(t5, p5, d5, **kw),
                            ew_ref.horizon_gather_ref(t5, p5, d5, **kw)):
                if not torch.equal(g.view(torch.int64), w.view(torch.int64)):
                    raise AssertionError(f"horizon_score N={n5} K={k5} "
                                         f"clocks {special}: kernel differs "
                                         f"from its plain version")
    say("kernels", f"horizon_score at (N, K) {shapes}, clocks at t_end, "
        f"+-inf and NaN: bitwise")
    floor = launch_floor_ms()
    say("kernels", f"K1/K2/K5 bitwise equal to their plain versions, K3 == "
        f"K2(K1), K4 within rtol {RTOL}, atol {ATOL}; launch floor "
        f"{floor:.5f} ms (device time of a one-element in-place "
        f"torch.add_); launches so far {build.launches()}")
    return rows


# ---------------------------------------------------------------- phase 3 --
def _runner(dev, n, t_end, **knobs):
    """The runner of the branched cell on make_network(n, 16, seed 11) with
    regime-mixed currents; ``wheel="auto"`` sizes the wheel from the net.
    Building it runs the auto caps' dense probe."""
    from repro_torch.core.cell import CellModel
    from repro_torch.core.exec_fap import make_fap_vardt_runner
    from repro_torch.core.morphology import branched_tree
    from repro_torch.core.network import make_network
    from repro_torch.sched import WheelSpec
    model = CellModel(branched_tree(depth=2, seg_per_branch=2), device=dev)
    net = make_network(n, k_in=K_IN, seed=NET_SEED)
    if knobs.get("wheel") == "auto":
        knobs["wheel"] = WheelSpec.auto(net)
    return make_fap_vardt_runner(model, net, regime_currents(n), t_end,
                                 horizon_impl="fused", device=dev, **knobs)


def _run(dev, n, t_end, **knobs):
    return _runner(dev, n, t_end, **knobs)()


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
    missing = [k for k in DENSE_PATH if launches[k] <= 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    return launches, dict(t_end=t_end, rounds=rounds, wall_s=wall,
                          spikes=spikes, n_steps=int(res.n_steps),
                          n_events=int(res.n_events),
                          n_resets=int(res.n_resets), solver=solver,
                          counts=res.rec.count.cpu().numpy(),
                          ref=_host_result(res))


def _host_result(res):
    """What phase 22 holds bitwise to phase 3: the spike record, the final
    ``zn[:, 0]`` and every counter, on the host."""
    return dict(times=res.rec.times.cpu(), count=res.rec.count.cpu(),
                overflow=int(res.rec.overflow), y=res.y_final.cpu(),
                counters=[int(res.n_steps), int(res.n_events),
                          int(res.n_resets), int(res.dropped),
                          bool(res.failed)]
                + [int(v) for v in res.solver.values()]
                + [int(v) for v in (res.sched or ())])


def _same_host(a, b):
    return (torch.equal(a["times"], b["times"])
            and torch.equal(a["count"], b["count"])
            and torch.equal(a["y"], b["y"]) and a["overflow"] == b["overflow"]
            and a["counters"] == b["counters"])


# ---------------------------------------------------------------- phase 4 --
class _Recorder:
    """Keeps copies of the first argument (a mask or a key batch) of the
    named dispatchers of ``kernels.event_wheel.ops`` on a path, one device
    copy per call and no host synchronisation, so that a later phase can
    check the kernels on the path's own inputs (``seen[name]``).  The
    wrapped dispatchers still launch and count as before."""

    def __init__(self, *names):
        from repro_torch.kernels.event_wheel import ops as ew_ops
        self.ops = ew_ops
        self.real = {k: getattr(ew_ops, k) for k in names}
        self.seen = {k: [] for k in names}

    def __enter__(self):
        for name, fn in self.real.items():
            def rec(x, *a, _name=name, _fn=fn, **kw):
                self.seen[_name].append(x.clone())
                return _fn(x, *a, **kw)

            setattr(self.ops, name, rec)
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.ops, name, fn)

    @staticmethod
    def busiest(batches, valid):
        """The recorded batch with the most valid entries."""
        return max(batches, key=lambda b: int(valid(b).sum()))


def phase_active(dev, t_end, dense):
    """The active-set path at full width, counts zeroed just before."""
    from repro_torch.core import exec_common as xc
    from repro_torch.kernels import build
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Recorder("compact_gather", "segment_rank") as seen:
        run = _runner(dev, N_MAIN, t_end, wheel="auto", **ACTIVE)
        torch.cuda.synchronize()
        t_probe = time.perf_counter() - t0
        res, rounds = run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = build.launches()
    spikes = int(res.rec.count.sum())
    counts = res.rec.count.cpu().numpy()
    differ = int((counts != dense["counts"]).sum())
    m = xc.sched_metrics(res.sched)
    spec = run.wheel
    say("active", f"N={N_MAIN} C=13 k_in={K_IN} t_end={t_end} ms {ACTIVE}: "
        f"batch_cap {run.batch_cap}, spike_cap {run.spike_cap}, wheel "
        f"{spec.n_buckets} buckets x {spec.bucket_slots} slots x "
        f"{spec.bucket_width} ms")
    say("active", f"rounds {rounds}, n_steps {int(res.n_steps)}, n_events "
        f"{int(res.n_events)}, n_resets {int(res.n_resets)}, spikes {spikes}"
        f" (dense phase {int(dense['counts'].sum())}; {differ} neurons "
        f"differ in spike count), dropped {int(res.dropped)}, record "
        f"overflow {int(res.rec.overflow)}, failed {bool(res.failed)}")
    say("active", f"sched {json.dumps(m)}")
    say("active", f"wall {wall:.2f} s (probe {t_probe:.2f} s, run "
        f"{wall - t_probe:.2f} s), {(wall - t_probe) / max(rounds, 1) * 1e3:.1f}"
        f" ms per round; launches {json.dumps(launches)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if bool(res.failed):
        raise AssertionError("active path: an integrator failed")
    if int(res.dropped) != 0 or int(res.rec.overflow) != 0:
        raise AssertionError(f"active path dropped {int(res.dropped)} events,"
                             f" record overflow {int(res.rec.overflow)}")
    if spikes <= 0:
        raise AssertionError("active path produced no spikes")
    missing = [k for k in ACTIVE_PATH if launches[k] <= 0]
    if missing:
        raise AssertionError(f"active path never launched {missing}")
    n_keys = N_MAIN * spec.n_buckets
    return launches, dict(
        rounds=rounds, wall_s=wall, probe_s=t_probe, spikes=spikes,
        spike_count_differs=differ, n_steps=int(res.n_steps),
        n_events=int(res.n_events), batch_cap=run.batch_cap,
        spike_cap=run.spike_cap, wheel=list(spec), sched=m,
        mask=_Recorder.busiest(seen.seen["compact_gather"], lambda b: b),
        keys=_Recorder.busiest(seen.seen["segment_rank"],
                               lambda b: b < n_keys))


# ---------------------------------------------------------------- phase 5 --
def rank_compares(key, max_rank):
    """Compares K8 needs on these keys: all earlier events for a rank below
    max_rank, else up to the group's max_rank-th earlier member."""
    E = key.shape[0]
    if max_rank == 0 or E == 0:
        return 0
    order = np.argsort(key, kind="stable")
    starts = np.searchsorted(key[order], key[order], side="left")
    r = np.arange(E) - starts
    stop = order[np.minimum(starts + max_rank - 1, E - 1)] + 1
    return int(np.where(r < max_rank, order, stop).sum())


def phase_sched_kernels(dev, act):
    """K6/K7/K8 against their plain versions at the active path's shapes."""
    from repro_torch.core.exec_common import out_edge_table
    from repro_torch.core.network import make_network
    from repro_torch.kernels.event_wheel import ops as ew_ops
    from repro_torch.kernels.event_wheel import ref as ew_ref
    N, rows = N_MAIN, {}
    gen = np.random.default_rng(7)
    masks = {d: torch.from_numpy(gen.random(N) < d).to(dev)
             for d in (0.0, 0.01, 0.5, 1.0)}

    def same(name, got, want):
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: kernel differs from its plain "
                                     f"version")

    cap = act["batch_cap"]
    caps = sorted({cap, 256})
    for c in caps:
        for d, m in masks.items():
            same(f"compact_ids cap={c} density={d}", ew_ops.compact_ids(m, c),
                 ew_ref.compact_ids_ref(m, c))
    if int(masks[1.0].sum()) <= caps[0]:
        raise AssertionError("no compact_ids case with a count above cap")
    # ragged lengths and mask views 1-15 bytes past an aligned buffer
    odd = [(n, off) for n in (N + 5, 4097, 17) for off in (0, 1, 7, 15)]
    for n, off in odd:
        for d in masks:
            buf = torch.from_numpy(gen.random(n + 16) < d).to(dev)
            mv = buf[off:off + n]
            for c in sorted({1, cap, n}):
                same(f"compact_ids N={n} offset={off} cap={c} density={d}",
                     ew_ops.compact_ids(mv, c), ew_ref.compact_ids_ref(mv, c))
    m = masks[0.5]
    rows["compact_ids"] = kernel_row(
        0.0, lambda: ew_ops.compact_ids(m, cap),
        lambda: ew_ref.compact_ids_ref(m, cap), N + 4 * cap + 4, N,
        INT32_OPS, library=lambda: torch.nonzero(m),
        library_device=profiled_device_ms)
    say("sched-kernels", f"compact_ids N={N} caps {caps}, densities "
        f"{sorted(masks)}, and N x mask offset {odd}: bitwise; "
        f"{fmt_row(rows['compact_ids'])} (library: torch.nonzero)")

    net = make_network(N, k_in=K_IN, seed=NET_SEED)
    table = torch.as_tensor(out_edge_table(net), device=dev).contiguous()
    E, MO = int(net.pre.shape[0]), int(table.shape[1])
    s_cap = act["spike_cap"]
    real = act["mask"]
    for d, mm in [("path", real)] + list(masks.items()):
        same(f"compact_gather spike_cap={s_cap} mask={d}",
             ew_ops.compact_gather(mm, table, s_cap, fill=E),
             ew_ref.compact_gather_ref(mm, table, s_cap, E))
    n_real = int(real.sum())
    filled = min(n_real, s_cap)
    rows["compact_gather"] = kernel_row(
        0.0, lambda: ew_ops.compact_gather(real, table, s_cap, fill=E),
        lambda: ew_ref.compact_gather_ref(real, table, s_cap, E),
        N + 4 * filled * MO + 4 * s_cap * (MO + 1) + 4, N + s_cap * MO,
        INT32_OPS)
    say("sched-kernels", f"compact_gather N={N} MO={MO} spike_cap={s_cap} "
        f"fill=E={E}, path mask with {n_real} spikes and densities "
        f"{sorted(masks)}: bitwise; {fmt_row(rows['compact_gather'])}")
    # caps 1 and N, tables of MO 1 and 64, mask views 1-15 bytes past an
    # aligned buffer
    for mo in (1, 64):
        t7 = torch.from_numpy(gen.integers(-10**6, 10**6, (N, mo))
                              .astype(np.int32)).to(dev)
        for off in range(1, 16):
            buf = torch.from_numpy(gen.random(N + 16) < (0.01, 0.5)[off % 2])
            mv = buf.to(dev)[off:off + N]
            for c in (1, N):
                same(f"compact_gather MO={mo} offset={off} cap={c}",
                     ew_ops.compact_gather(mv, t7, c, fill=E),
                     ew_ref.compact_gather_ref(mv, t7, c, E))
    say("sched-kernels", "compact_gather caps 1 and N x MO 1 and 64 x mask "
        "offsets 1-15: bitwise")

    keys = act["keys"]
    S, B = act["wheel"][1], act["wheel"][0]
    n_keys = N * B
    bad = keys.clone()
    bad[::7] = n_keys                                # more invalid keys
    rank_cases = [("path", keys, S), ("path+invalid", bad, S),
                  ("path", keys, 0), ("all equal", torch.full_like(keys, 7), S)]
    # longer batches of the wheel's pattern: valid keys target*B+bucket in
    # the path's share, the rest N*B; E = 18000 stages its keys in one chunk
    # past 48 KB, E = 60000 in three (past 227 KB)
    share = float((keys < n_keys).float().mean())
    for E in (int(keys.shape[0]) + 1, 18000, 60000):
        k = torch.from_numpy(np.where(gen.random(E) < share,
                                      gen.integers(0, n_keys, E), n_keys)
                             .astype(np.int32)).to(dev)
        rank_cases.append((f"E={E}", k, S))
    for name, k, mr in rank_cases:
        same(f"segment_rank {name} max_rank={mr}",
             (ew_ops.segment_rank(k, mr),), (ew_ref.segment_rank_ref(k, mr),))
    Ek = int(keys.shape[0])
    n_valid = int((keys < n_keys).sum())
    ops = rank_compares(keys.cpu().numpy(), S)
    rows["segment_rank"] = kernel_row(
        0.0, lambda: ew_ops.segment_rank(keys, S),
        lambda: ew_ref.segment_rank_ref(keys, S), 8 * Ek, ops, INT32_OPS)
    say("sched-kernels", f"segment_rank E={Ek} ({n_valid} valid keys "
        f"target*{B}+bucket, the rest N*B) max_rank={S}, and "
        f"{[(n, int(k.shape[0]), mr) for n, k, mr in rank_cases[2:]]}"
        f" (name, E, max_rank): bitwise; "
        f"{fmt_row(rows['segment_rank'])}; {ops} compares needed (of "
        f"{Ek * (Ek - 1) // 2} pairs) at {INT32_OPS:.3g} int32 ops/s")
    return rows


# ---------------------------------------------------------------- phase 6 --
def phase_card_vs_cpu(dev, n=64, t_end=4.0):
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


# ---------------------------------------------------------------- phase 7 --
def _same_run(a, b):
    return (torch.equal(a.rec.times.cpu(), b.rec.times.cpu())
            and torch.equal(a.rec.count.cpu(), b.rec.count.cpu())
            and torch.equal(a.y_final.cpu(), b.y_final.cpu())
            and int(a.n_steps) == int(b.n_steps)
            and int(a.n_events) == int(b.n_events))


def phase_active_card_vs_cpu(dev, n=64, t_end=6.0, batch_cap=16,
                             spike_cap=2):
    """The active path with a binding batch cap (roll-over) and a small
    spike cap (dense fan-out fallback): card == CPU bitwise; on the card
    batch_cap=0 == the dense path."""
    from repro_torch.core import exec_common as xc
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    kw = dict(ACTIVE, wheel="auto", batch_cap=batch_cap, spike_cap=spike_cap)
    dense_fanout = xc.fanout_edges
    fallbacks = []

    def counting(*a):
        fallbacks.append(1)
        return dense_fanout(*a)

    xc.fanout_edges = counting
    build.reset_launches()
    try:
        gpu, rg = _run(dev, n, t_end, **kw)
    finally:
        xc.fanout_edges = dense_fanout
    compact_inserts = build.launches()["compact_gather"] - len(fallbacks)
    cpu, rc = _run("cpu", n, t_end, **kw)
    rolled = int(gpu.sched.runnable) - int(gpu.sched.stepped)
    same = _same_run(gpu, cpu) and rg == rc
    say("active-card-vs-cpu", f"N={n} C=13 t_end={t_end} ms batch_cap="
        f"{batch_cap} spike_cap={spike_cap} wheel: rounds card {rg} cpu {rc};"
        f" spikes {int(gpu.rec.count.sum())}; n_steps card "
        f"{int(gpu.n_steps)} cpu {int(cpu.n_steps)}; {rolled} lane-rounds "
        f"rolled over, {compact_inserts} compact and {len(fallbacks)} dense "
        f"fan-outs; spike trains, n_steps and final states bitwise equal: "
        f"{same}")
    if not same:
        raise AssertionError("active path differs card vs CPU")
    if int(cpu.rec.count.sum()) == 0 or int(gpu.dropped) != 0:
        raise AssertionError("active card-vs-CPU run: no spikes or drops")
    if rolled <= 0 or not fallbacks or compact_inserts <= 0:
        raise AssertionError("active card-vs-CPU run missed the roll-over, "
                             "the compact fan-out or its dense fallback")
    full, rf = _run(dev, n, t_end, **dict(kw, batch_cap=0))
    dense, rd = _run(dev, n, t_end, queue="wheel", wheel="auto")
    same0 = _same_run(full, dense) and rf == rd \
        and int(full.dropped) == int(dense.dropped) == 0
    say("active-card-vs-cpu", f"card, batch_cap=0 vs dense twin: rounds "
        f"{rf} vs {rd}, identical: {same0} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not same0:
        raise AssertionError("batch_cap=0 differs from the dense path")


# ---------------------------------------------------------------- phase 8 --
def phase_fused_solve(dev):
    """K3 bitwise against its plain version and against K2(K1(d), b) at
    the baseline path's shapes, timed beside the plain version and the
    dense ``torch.linalg.solve`` on the same systems."""
    from repro_torch.core.hines import dense_tree_matrix
    from repro_torch.core.morphology import ball_and_stick, branched_tree
    from repro_torch.kernels.hines import ops as h_ops
    from repro_torch.kernels.hines import ref as h_ref
    N, row = N_MAIN, None
    for morph in (branched_tree(depth=2, seg_per_branch=2), ball_and_stick()):
        model, d, _, b = _hines_case(morph, dev, N)
        C, p = model.C, model.params
        dT, bT = d.T, b.T                   # the cell's [N, C] rows, as views
        x = h_ops.hines_solve(p.parent, p.g_axial, dT, bT)
        check_close(f"hines_solve C={C} vs plain", x,
                    h_ref.hines_solve_ref(p.parent, p.g_axial, dT, bT),
                    exact=True)
        check_close(f"hines_solve C={C} vs K2(K1)", x,
                    h_ops.hines_solve_factored(
                        p.parent, p.g_axial,
                        h_ops.hines_factor(p.parent, p.g_axial, dT), bT),
                    exact=True)
        dense = dense_tree_matrix(p.parent, p.g_axial,
                                  d - p.g_axial - model._contrib)
        rhs = b[..., None]
        xl = torch.linalg.solve(dense, rhs)[..., 0]
        err = float((xl - x.T).abs().max())
        ne = N * C
        got = kernel_row(
            0.0, lambda: h_ops.hines_solve(p.parent, p.g_axial, dT, bT),
            lambda: h_ref.hines_solve_ref(p.parent, p.g_axial, dT, bT),
            24 * ne + 12 * C, (8 * (C - 1) + 1) * N,
            library=lambda: torch.linalg.solve(dense, rhs),
            library_device=profiled_device_ms)
        say("fused-solve", f"C={C} N={N}: hines_solve {fmt_row(got)} "
            f"(library: torch.linalg.solve on the dense [N, C, C] systems); "
            f"bitwise equal to the plain version and to K2(K1(d), b); "
            f"dense solve differs by {err:.2e}")
        if C == 13:
            row = got
    return {"hines_solve": row}


# ---------------------------------------------------------------- phase 9 --
def _baseline_model_net(dev, n):
    from repro_torch.core.cell import CellModel
    from repro_torch.core.morphology import branched_tree
    from repro_torch.core.network import make_network
    return (CellModel(branched_tree(depth=2, seg_per_branch=2), device=dev),
            make_network(n, k_in=K_IN, seed=NET_SEED))


def _gate_run(name, res):
    spikes = int(res.rec.count.sum())
    if bool(res.failed):
        raise AssertionError(f"{name}: an integrator failed")
    if int(res.dropped) != 0 or int(res.rec.overflow) != 0:
        raise AssertionError(f"{name}: dropped {int(res.dropped)} events, "
                             f"record overflow {int(res.rec.overflow)}")
    if spikes <= 0:
        raise AssertionError(f"{name}: no spikes")
    return spikes


def phase_baseline(dev, t_end, main):
    """Method 2a (BSP fixed-step, derivimplicit) at full width, counts
    zeroed just before; reported beside phase 3's 2c run."""
    from repro_torch.core.exec_bsp import make_bsp_fixed_runner
    from repro_torch.kernels import build
    model, net = _baseline_model_net(dev, N_MAIN)
    run = make_bsp_fixed_runner(model, net, regime_currents(N_MAIN), t_end,
                                method="derivimplicit", device=dev)
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = build.launches()
    spikes = _gate_run("2a", res)
    steps = run.n_windows * run.steps_per_window
    say("baseline", f"2a (BSP fixed, derivimplicit, dt 0.025 ms) N={N_MAIN} "
        f"C=13 k_in={K_IN} t_end={t_end} ms: {run.n_windows} windows x "
        f"{run.steps_per_window} steps, n_steps {int(res.n_steps)} "
        f"({steps} per neuron), n_events {int(res.n_events)}, spikes "
        f"{spikes}, dropped {int(res.dropped)}, failed {bool(res.failed)}")
    say("baseline", f"2a wall {wall:.2f} s, {wall / t_end:.3f} s per "
        f"simulated ms, {wall / run.n_windows * 1e3:.1f} ms per window; "
        f"launches {json.dumps(launches)}")
    say("baseline", f"2a vs 2c (phase 3, same cell, network, currents, "
        f"t_end): steps {int(res.n_steps)} vs {main['n_steps']} (ratio "
        f"{int(res.n_steps) / main['n_steps']:.3f}), wall {wall:.2f} vs "
        f"{main['wall_s']:.2f} s (ratio {wall / main['wall_s']:.3f}), "
        f"spikes {spikes} vs {main['spikes']}")
    if launches["hines_solve"] != steps:
        raise AssertionError(f"2a launched K3 {launches['hines_solve']} "
                             f"times for {steps} steps")
    return launches, dict(wall_s=wall, n_steps=int(res.n_steps),
                          steps_per_neuron=steps, windows=run.n_windows,
                          n_events=int(res.n_events), spikes=spikes)


# --------------------------------------------------------------- phase 10 --
def phase_other_baselines(dev, n_2b=4096, t_fixed=10.0, t_vardt=5.0):
    from repro_torch.core.bdf import BDFOptions
    from repro_torch.core.exec_bsp import run_bsp_fixed, run_bsp_vardt
    from repro_torch.core.exec_fap import (make_fap_fixed_runner,
                                           make_fap_vardt_runner)
    from repro_torch.kernels import build
    out = {}
    model, net = _baseline_model_net(dev, N_MAIN)
    cur = regime_currents(N_MAIN)
    t0 = time.perf_counter()
    r1a = run_bsp_fixed(model, net, cur, t_fixed, method="cnexp", device=dev)
    t1 = time.perf_counter()
    r1c, rounds = make_fap_fixed_runner(model, net, cur, t_fixed,
                                        method="cnexp", device=dev)()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for name, r in (("1a", r1a), ("1c", r1c)):
        _gate_run(name, r)
    fin = torch.isfinite(r1a.rec.times)
    dts = float((r1a.rec.times[fin] - r1c.rec.times[fin]).abs().max())
    dyn = (r1a.y_final - r1c.y_final).abs().amax(dim=1)
    dy, n_dy = float(dyn.max()), int((dyn > 0).sum())
    same = torch.equal(r1a.rec.count, r1c.rec.count) \
        and torch.equal(fin, torch.isfinite(r1c.rec.times)) \
        and int(r1a.n_events) == int(r1c.n_events) \
        and int(r1a.n_steps) == int(r1c.n_steps)
    say("baselines", f"1a BSP-fixed vs 1c FAP-fixed (cnexp) N={N_MAIN} "
        f"t_end={t_fixed} ms: spikes {int(r1a.rec.count.sum())} vs "
        f"{int(r1c.rec.count.sum())}, n_events {int(r1a.n_events)} vs "
        f"{int(r1c.n_events)}, 1c rounds {rounds}; spike counts, record "
        f"slots, events and steps equal: {same}; spike times within "
        f"{dts:.2e} ms; final states within {dy:.2e} ({n_dy} neurons "
        f"differ: the queues sum a "
        f"step's weights in slot order, and the two runners fill slots at "
        f"other times); wall {t1 - t0:.2f} vs {t2 - t1:.2f} s")
    if not same or dts > 1e-9:
        raise AssertionError("1a BSP-fixed differs from 1c FAP-fixed")
    out["1a_1c"] = dict(n=N_MAIN, t_end=t_fixed, rounds=rounds,
                        wall_1a_s=t1 - t0, wall_1c_s=t2 - t1,
                        spikes=int(r1a.rec.count.sum()))

    model_b, net_b = _baseline_model_net(dev, n_2b)
    cur_b = regime_currents(n_2b)
    cap = n_2b // 4
    t0 = time.perf_counter()
    rd = run_bsp_vardt(model_b, net_b, cur_b, t_vardt, device=dev)
    t1 = time.perf_counter()
    rc = run_bsp_vardt(model_b, net_b, cur_b, t_vardt, batch="compact",
                       batch_cap=cap, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _gate_run("2b dense", rd)
    _gate_run("2b compact", rc)
    same = _same_run(rd, rc) and int(rd.n_resets) == int(rc.n_resets)
    say("baselines", f"2b BSP-vardt N={n_2b} t_end={t_vardt} ms: dense vs "
        f"compact batch_cap={cap} (frontier {int(rc.sched.runnable)} lanes "
        f"over {int(rd.sched.rounds)} windows, {int(rc.sched.rounds)} "
        f"chunks): n_steps {int(rd.n_steps)} vs {int(rc.n_steps)}, spikes "
        f"{int(rd.rec.count.sum())}, identical event for event: {same}; "
        f"wall {t1 - t0:.2f} vs {t2 - t1:.2f} s")
    if not same or int(rc.sched.rounds) <= int(rd.sched.rounds):
        raise AssertionError("2b compact differs from dense, or its cap "
                             "did not bind")
    out["2b"] = dict(n=n_2b, t_end=t_vardt, batch_cap=cap,
                     n_steps=int(rd.n_steps), wall_dense_s=t1 - t0,
                     wall_compact_s=t2 - t1)

    build.reset_launches()
    t0 = time.perf_counter()
    ri, rounds = make_fap_vardt_runner(
        model, net, cur, t_vardt, opts=BDFOptions(jac_policy="iteration"),
        horizon_impl="fused", device=dev)()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = build.launches()
    _gate_run("2c-iteration", ri)
    solver = {k: int(v) for k, v in ri.solver.items()}
    say("baselines", f"2c jac_policy=iteration N={N_MAIN} t_end={t_vardt} "
        f"ms: rounds {rounds}, n_steps {int(ri.n_steps)}, spikes "
        f"{int(ri.rec.count.sum())}, solver {json.dumps(solver)}; wall "
        f"{wall:.2f} s; launches {json.dumps(launches)}")
    if solver["nsetups"] != solver["nni"] or launches["hines_solve"] <= 0 \
            or launches["hines_factor"] or launches["hines_solve_factored"]:
        raise AssertionError("2c-iteration: nsetups != nni, or K3 not "
                             "launched, or K1/K2 launched")
    out["2c_iteration"] = dict(n=N_MAIN, t_end=t_vardt, rounds=rounds,
                               wall_s=wall, solver=solver,
                               launches=launches)
    return out


# --------------------------------------------------------------- phase 11 --
def phase_baselines_card_vs_cpu(dev, n=64, t_end=6.0):
    from repro_torch.core.bdf import BDFOptions
    from repro_torch.core.exec_bsp import run_bsp_fixed
    from repro_torch.core.exec_fap import make_fap_vardt_runner
    t0 = time.perf_counter()
    cur = regime_currents(n)
    for name in ("2a", "2c-iteration"):
        res = []
        for d in (dev, torch.device("cpu")):
            model, net = _baseline_model_net(d, n)
            if name == "2a":
                res.append(run_bsp_fixed(model, net, cur, t_end,
                                         method="derivimplicit", device=d))
            else:
                res.append(make_fap_vardt_runner(
                    model, net, cur, t_end,
                    opts=BDFOptions(jac_policy="iteration"),
                    horizon_impl="fused", device=d)()[0])
        g, c = res
        same = _same_run(g, c)
        say("baselines-card-vs-cpu", f"{name} N={n} C=13 t_end={t_end} ms: "
            f"spikes {int(g.rec.count.sum())}, n_steps card "
            f"{int(g.n_steps)} cpu {int(c.n_steps)}; spike trains, steps and "
            f"final states bitwise equal: {same} "
            f"({time.perf_counter() - t0:.1f} s)")
        if not same or int(c.rec.count.sum()) == 0:
            raise AssertionError(f"{name} differs card vs CPU")


# --------------------------------------------------------------- phase 12 --
def _spmd_rank(group, n, t_end, runs, keep_masks=False):
    """Runs of ``run_fap_spmd`` on this rank (phase 3's cell, network and
    currents at width ``n``), each with the launch counts zeroed just
    before.  Returns, from every rank: launch counts per rank and
    (``keep_masks``) rank 0's busiest parcel mask, which phase 13 hands
    to K9 again."""
    from repro_torch.core.cell import CellModel
    from repro_torch.core.morphology import branched_tree
    from repro_torch.core.network import make_network
    from repro_torch.distributed.exchange import ExchangeSpec
    from repro_torch.distributed.fap_spmd import run_fap_spmd
    from repro_torch.kernels import build
    from repro_torch.kernels.event_wheel import ops as ew_ops
    from repro_torch.sched import WheelSpec
    model = CellModel(branched_tree(depth=2, seg_per_branch=2),
                      device=group.device)
    net = make_network(n, k_in=K_IN, seed=NET_SEED)
    cur = regime_currents(n)
    real = ew_ops.spike_compact
    out = {}
    for name, kw in runs.items():
        kw = dict(kw)
        if kw.get("queue") == "wheel":
            kw["wheel"] = WheelSpec.auto(net)
        masks = []

        def keep(mask, values, cap):
            masks.append(mask)
            return real(mask, values, cap)

        if keep_masks:
            ew_ops.spike_compact = keep
        build.reset_launches()
        if group.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            res, rounds = run_fap_spmd(
                model, net, cur, t_end, group,
                exchange=ExchangeSpec(parcel_cap=kw.pop("parcel_cap")),
                **kw)
        finally:
            ew_ops.spike_compact = real
        if group.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        names = list(build.launches())
        counts = group.all_gather(torch.tensor(
            [list(build.launches().values())]), "other")
        out[name] = dict(res=res, rounds=rounds, wall_s=wall,
                         launches=dict(zip(names, counts.T.tolist())))
        if keep_masks:
            if len(masks) != rounds:
                raise AssertionError(f"spmd {name}: {len(masks)} parcel "
                                     f"masks kept in {rounds} rounds")
            out[name]["mask"] = max(masks, key=lambda m: int(m.sum())) \
                .contiguous()
    return out


def _same_spmd(a, b):
    return (torch.equal(a.rec.times.cpu(), b.rec.times.cpu())
            and torch.equal(a.rec.count.cpu(), b.rec.count.cpu())
            and torch.equal(a.y_final.cpu(), b.y_final.cpu())
            and int(a.n_steps) == int(b.n_steps)
            and int(a.n_events) == int(b.n_events))


def phase_spmd(dev, t_end, main):
    """The SPMD round at full width, four ranks on the card."""
    from repro_torch.distributed.group import launch
    t0 = time.perf_counter()
    runs = launch(RANKS, _spmd_rank, N_MAIN, t_end,
                  {k: dict(kw, parcel_cap=PARCEL_CAP)
                   for k, kw in SPMD_RUNS.items()}, True,
                  backend="gloo", device=dev)
    say("spmd", f"{RANKS} ranks on {dev} over gloo, N={N_MAIN} C=13 "
        f"k_in={K_IN} t_end={t_end} ms, parcel_cap {PARCEL_CAP} (classes "
        f"of the ragged run {list(_ladder())}); spawn, build and both runs "
        f"{time.perf_counter() - t0:.1f} s")
    out = {}
    for name, r in runs.items():
        res, rounds = r["res"], r["rounds"]
        spikes = int(res.rec.count.sum())
        ch = res.comm["channels"]
        per = {k: {"bytes_per_round": v["bytes"] / rounds,
                   "ms_per_round": v["seconds"] / rounds * 1e3,
                   "calls": v["calls"]}
               for k, v in ch.items()}
        parcel = {k: v for k, v in per.items()
                  if k.startswith("exchange_parcel")}
        ref = f" (phase 3, one process, {main['t_end']} ms: " \
            f"{main['wall_s'] / max(main['rounds'], 1) * 1e3:.1f})"
        say("spmd", f"{name} {SPMD_RUNS[name]}: rounds {rounds}, n_steps "
            f"{int(res.n_steps)}, n_events {int(res.n_events)}, spikes "
            f"{spikes}, dropped {int(res.dropped)}, record overflow "
            f"{int(res.rec.overflow)}, failed {bool(res.failed)}; wall "
            f"{r['wall_s']:.2f} s, {r['wall_s'] / max(rounds, 1) * 1e3:.1f} "
            f"ms per round{ref}")
        say("spmd", f"{name} bytes per round on rank 0: notify "
            f"{per['exchange_notify']['bytes_per_round']:.0f} (allgather: "
            f"N*8 = {N_MAIN * 8}), parcel "
            f"{sum(v['bytes_per_round'] for v in parcel.values()):.0f} "
            f"(allgather: N*9 = {N_MAIN * 9}), counts "
            f"{per.get('exchange_counts', {}).get('bytes_per_round', 0):.0f}"
            f"; per tag {json.dumps({k: v['bytes_per_round'] for k, v in per.items()})}")
        say("spmd", f"{name} host wall inside the collectives, ms per round "
            f"on rank 0: "
            f"{json.dumps({k: round(v['ms_per_round'], 3) for k, v in per.items()})}")
        peak = res.comm["parcel_peak"]
        say("spmd", f"{name} largest per-pair parcel count per round: max "
            f"{max(peak, default=0)}, by round {peak}")
        say("spmd", f"{name} launches per rank {json.dumps(r['launches'])}")
        _gate_run(f"spmd {name}", res)
        if rounds >= 400:
            raise AssertionError(f"spmd {name}: did not reach t_end")
        if len(peak) != rounds or not 0 < max(peak) <= PARCEL_CAP:
            raise AssertionError(f"spmd {name}: parcel peaks {peak} in "
                                 f"{rounds} rounds, cap {PARCEL_CAP}")
        missing = [k for k in SPMD_PATH if min(r["launches"][k]) <= 0]
        if missing:
            raise AssertionError(f"spmd {name}: some rank never launched "
                                 f"{missing}")
        out[name] = dict(rounds=rounds, wall_s=r["wall_s"], spikes=spikes,
                         n_steps=int(res.n_steps),
                         n_events=int(res.n_events), channels=per,
                         parcel_peak=peak, launches=r["launches"])
    a, b = runs["sparse"]["res"], runs["full_stack"]["res"]
    fin = torch.isfinite(a.rec.times)
    dts = float((a.rec.times[fin] - b.rec.times[fin]).abs().max()) \
        if bool(fin.any()) else 0.0
    bitwise = _same_spmd(a, b)
    say("spmd", f"sparse vs full stack: spike counts, events and steps "
        f"equal: {torch.equal(a.rec.count, b.rec.count)}, "
        f"{int(a.n_events) == int(b.n_events)}, "
        f"{int(a.n_steps) == int(b.n_steps)}; spike times within {dts:.2e} "
        f"ms; bitwise equal (times, final states): {bitwise}")
    if not torch.equal(a.rec.count, b.rec.count) or dts > 1e-9 \
            or int(a.n_events) != int(b.n_events) \
            or int(a.n_steps) != int(b.n_steps):
        raise AssertionError("spmd: the full stack differs from sparse")
    fs = runs["full_stack"]["launches"]
    missing = [k for k in FULL_STACK_PATH if sum(fs[k]) <= 0]
    if missing:
        raise AssertionError(f"spmd full stack never launched {missing}")
    out["bitwise"] = bitwise
    return out, runs["sparse"]["mask"], sum(runs["sparse"]["launches"]
                                            ["compact_rows"]), a


def _ladder():
    from repro_torch.distributed.exchange import ExchangeSpec
    return ExchangeSpec(parcel_cap=PARCEL_CAP).class_ladder()


# --------------------------------------------------------------- phase 13 --
def phase_parcel_kernel(dev, path_mask):
    """K9 against its plain version, bitwise, at the SPMD path's shapes."""
    from repro_torch.kernels.event_wheel import ops as ew_ops
    from repro_torch.kernels.event_wheel import ref as ew_ref
    D, M, cap = RANKS, N_MAIN // RANKS, PARCEL_CAP
    gen = np.random.default_rng(13)
    row = torch.from_numpy(gen.random(M) * 20.0).to(dev)
    vals = row[None, :].expand(D, M)              # the transport's strides
    masks = {f"{d:.0%}": torch.from_numpy(gen.random((M, D)) < d).to(dev).T
             for d in (0.0, 0.05, 0.5, 1.0)}
    over = torch.from_numpy(gen.random((D, M)) < 0.05).to(dev)
    over[1, : cap + 100] = True                   # one row past the cap
    masks["row over cap"] = over
    # phase 12's busiest parcel mask, in the transport's layout (the
    # transpose of contiguous [M, D] bytes) and in contiguous rows
    masks["spmd path"] = path_mask.to(dev).T.contiguous().T
    masks["spmd path, rows"] = path_mask.to(dev).contiguous()
    cases = [(name, m, vals, cap) for name, m in masks.items()]
    # D = 1, 3, 4 and 8 in the transport's transposed layout, in contiguous
    # rows and as a transposed view 1-15 bytes past an aligned base; M = M
    # and M + 1 (no multiple of 16 / D); caps below and above the rows
    for d in (1, 3, 4, 8):
        for m_len in (M, M + 1):
            for layout in ("transposed", "contiguous", "offset"):
                off = int(gen.integers(1, 16)) if layout == "offset" else 0
                buf = torch.from_numpy(gen.random(m_len * d + off) < 0.3)
                mm = buf.to(dev)[off:].view(m_len, d).T
                if layout == "contiguous":
                    mm = mm.contiguous()
                vv = torch.from_numpy(gen.random(m_len)).to(dev)
                for c in (64, cap):
                    cases.append((f"D={d} M={m_len} {layout} cap={c}", mm,
                                  vv[None, :].expand(d, m_len), c))
    for name, m, v, c in cases:
        got = ew_ops.spike_compact(m, v, c)
        want = ew_ref.compact_rows_ref(m, v, c)
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"compact_rows mask={name}: kernel "
                                     f"differs from its plain version")
    if int(over[1].sum()) <= cap:
        raise AssertionError("no compact_rows case with a row over the cap")
    m = masks["spmd path"]
    kept = int(torch.clamp(m.sum(dim=1), max=cap).sum())
    nbytes = D * M + 8 * kept + D * cap * (4 + 8) + 4 * D
    row = kernel_row(0.0, lambda: ew_ops.spike_compact(m, vals, cap),
                     lambda: ew_ref.compact_rows_ref(m, vals, cap), nbytes,
                     D * M, INT32_OPS)
    say("parcel-kernel", f"compact_rows D={D} M={M} cap={cap}, masks "
        f"{list(masks)} (path mask: {int(m.sum())} set, {kept} kept), and "
        f"{len(cases) - len(masks)} cases of D 1/3/4/8 x M {M}/{M + 1} x "
        f"transposed/contiguous/offset x cap 64/{cap}: bitwise; "
        f"{fmt_row(row)}, {nbytes} bytes")
    return {"compact_rows": row}


# --------------------------------------------------------------- phase 14 --
def phase_spmd_small(dev, n=256, t_end=4.0):
    """At N=256: allgather == sparse == the single-host runner on the card;
    four card ranks == four CPU ranks."""
    from repro_torch.core.exec_fap import run_fap_vardt
    from repro_torch.distributed.group import launch
    t0 = time.perf_counter()
    runs = {"allgather": dict(transport="allgather", parcel_cap=64),
            "sparse": dict(transport="sparse", parcel_cap=64),
            "global": dict(optimized=False, parcel_cap=64)}
    card = launch(RANKS, _spmd_rank, n, t_end, runs, backend="gloo",
                  device=dev)
    cpu = launch(RANKS, _spmd_rank, n, t_end,
                 {k: runs[k] for k in ("sparse", "global")},
                 backend="gloo", device="cpu")
    model, net = _baseline_model_net(dev, n)
    single = run_fap_vardt(model, net, regime_currents(n), t_end,
                           step_budget=8, ev_cap=32, device=dev)
    ag, sp, sc = card["allgather"]["res"], card["sparse"]["res"], \
        cpu["sparse"]["res"]
    spk = sp.rec.times.shape[1]
    single = single._replace(rec=single.rec._replace(
        times=single.rec.times[:, :spk].cpu()))
    same_ag = _same_spmd(ag, sp) and \
        card["allgather"]["rounds"] == card["sparse"]["rounds"]
    same_1 = _same_spmd(sp, single)
    same_cpu = _same_spmd(sp, sc) and \
        card["sparse"]["rounds"] == cpu["sparse"]["rounds"]
    gl, glc = card["global"]["res"], cpu["global"]["res"]
    same_gl = _same_spmd(gl, sp) and \
        card["global"]["rounds"] == card["sparse"]["rounds"]
    same_gl_cpu = _same_spmd(gl, glc) and \
        card["global"]["rounds"] == cpu["global"]["rounds"]
    say("spmd-small", f"N={n} C=13 t_end={t_end} ms, {RANKS} ranks: spikes "
        f"{int(sp.rec.count.sum())}, n_steps card {int(sp.n_steps)} cpu "
        f"{int(sc.n_steps)} single-host {int(single.n_steps)}; allgather "
        f"== sparse: {same_ag}; sparse == single-host run_fap_vardt("
        f"step_budget=8): {same_1}; card ranks == CPU ranks bitwise: "
        f"{same_cpu}; the global round (optimized=False) == sparse: "
        f"{same_gl}, its card ranks == its CPU ranks bitwise: {same_gl_cpu}"
        f" ({time.perf_counter() - t0:.1f} s)")
    for name, r in (("allgather", ag), ("sparse", sp), ("cpu sparse", sc),
                    ("global", gl), ("cpu global", glc)):
        _gate_run(f"spmd-small {name}", r)
    if not (same_ag and same_1 and same_cpu and same_gl and same_gl_cpu):
        raise AssertionError("spmd-small: runs differ")
    missing = [k for k in GLOBAL_PATH
               if min(card["global"]["launches"][k]) <= 0]
    if missing:
        raise AssertionError(f"spmd-small global: some rank never launched "
                             f"{missing}")



# --------------------------------------------------------------- phase 15 --
def _attn_inputs(dev, dtype, B, H, Hkv, Sq, Skv, D, seed=0):
    """q, k, v in the model's layouts ([B, S, heads, D]) on the card, handed
    over as the ``transpose(1, 2)`` views the model passes."""
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn((B, S, h, D), generator=g).to(dev, dtype)
                 .transpose(1, 2)
                 for S, h in ((Sq, H), (Skv, Hkv), (Skv, Hkv)))


def check_attention(name, got, q, k, v, causal, offset, kv_len):
    """Holds K10's output ``got`` to the plain version on the same inputs;
    returns (max abs err, the largest share of its limit an element
    used)."""
    from repro_torch.kernels.attention import ref as a_ref
    want = a_ref.flash_attention_ref(q, k, v, causal, offset, kv_len,
                                     got.dtype).float()
    lim = ATTN_TOL * (1 + want.abs())
    if v.dtype == torch.bfloat16:
        lim += a_ref.bf16_rounding_bound(q, k, v, causal, offset, kv_len,
                                         got.dtype)
    err = (got.float() - want).abs()
    used = float((err / lim).max())
    if not bool(torch.isfinite(got).all()) or used > 1.0:
        raise AssertionError(f"{name}: K10 disagrees with its plain version "
                             f"(max abs err {float(err.max()):.3e}, "
                             f"{used:.3f} of the limit)")
    return float(err.max()), used


ATTN_CASES = [  # name, B, H, Hkv, Sq, Skv, D, causal, kv_len
    ("prefill", 4, 9, 3, 2048, 2048, 64, True, None),
    ("decode kv_len=1", 4, 9, 3, 1, 256, 64, True, 1),
    ("decode kv_len=37", 4, 9, 3, 1, 256, 64, True, 37),
    ("decode kv_len=255", 4, 9, 3, 1, 256, 64, True, 255),
    ("decode kv_len=256", 4, 9, 3, 1, 256, 64, True, 256),
    ("decode kv_len=2048", 4, 9, 3, 1, 2048, 64, True, 2048),
    ("decode kv_len=4096", 4, 9, 3, 1, 4096, 64, True, 4096),
    ("decode Sq=5 kv_len=555", 1, 9, 3, 5, 600, 64, True, 555),
    ("decode group 8 Sq=8 D=16", 1, 8, 1, 8, 64, 16, True, None),
    ("decode bidirectional Sq=20", 1, 3, 1, 20, 200, 64, False, 150),
    ("ragged Sq=37 Skv=100", 4, 9, 3, 37, 100, 64, True, None),
    ("bidirectional", 4, 9, 3, 256, 256, 64, False, None),
    ("group 1 D=16", 2, 8, 8, 130, 130, 16, True, None),
    ("group 8 Skv=333 D=128", 1, 16, 2, 100, 333, 128, True, None),
    ("deepseek-7b D=128", 1, 32, 32, 2048, 2048, 128, True, None),
    ("qwen2-72b D=128", 1, 64, 8, 2048, 2048, 128, True, None),
    ("qwen2-72b decode kv_len=4096", 2, 64, 8, 1, 4096, 128, True, 4096),
    ("zamba2-7b D=112 prefill", 2, 32, 32, 128, 128, 112, True, None),
    ("zamba2-7b D=112 decode kv_len=1", 4, 32, 32, 1, 256, 112, True, 1),
    ("zamba2-7b D=112 decode kv_len=37", 4, 32, 32, 1, 256, 112, True, 37),
    ("zamba2-7b D=112 decode kv_len=256", 4, 32, 32, 1, 256, 112, True,
     256),
    # D = 112 past the small decode instantiations: 8 and 32 rows (the
    # latter two bf16 row tiles, and split over the cache)
    ("decode D=112 group 8 kv_len=300", 1, 32, 4, 1, 320, 112, True, 300),
    ("decode D=112 group 8 Sq=4 kv_len=555", 1, 32, 4, 4, 600, 112, True,
     555),
]
# the shapes timed in phase 15: (row, case) -- the serve model's prefill,
# its decode step against a full 256-slot cache, and a 4096-row cache
ATTN_TIMED = (("flash_attention_prefill", "prefill"),
              ("flash_attention_decode", "decode kv_len=256"),
              ("decode kv_len=4096", "decode kv_len=4096"),
              ("prefill D=112", "zamba2-7b D=112 prefill"),
              ("decode D=112", "zamba2-7b D=112 decode kv_len=256"))
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
#                                (NVIDIA data sheet)


def _attn_row(dev, dtype, case):
    """Times K10 on ``case`` (bf16 or float32 in, float32 out)."""
    name, B, H, Hkv, Sq, Skv, D, causal, kv_len = case
    q, k, v = _attn_inputs(dev, dtype, B, H, Hkv, Sq, Skv, D)
    return _attn_row_on(name, q, k, v, causal,
                        None if kv_len is None else kv_len - Sq, kv_len)


def _attn_row_on(name, q, k, v, causal, offset, kv_len):
    """Times K10 on these inputs (float32 out) beside its plain version
    and ``scaled_dot_product_attention``, with its bound."""
    from repro_torch.kernels.attention import ops as a_ops
    from repro_torch.kernels.attention import ref as a_ref
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kw = dict(causal=causal, offset=offset, kv_len=kv_len,
              out_dtype=torch.float32)
    got = a_ops.flash_attention(q, k, v, **kw)
    err, _ = check_attention(name, got, q, k, v, causal, offset, kv_len)
    kv = kv_len or Skv
    ks, vs = k[:, :, :kv], v[:, :, :kv]
    flops = (2 if causal and Sq > 1 else 4) * B * H * Sq * kv * D
    size = q.element_size()
    nbytes = size * B * H * Sq * D + 2 * size * B * Hkv * kv * D \
        + 4 * B * H * Sq * D
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = kernel_row(
        err, lambda: a_ops.flash_attention(q, k, v, **kw),
        lambda: a_ref.flash_attention_ref(q, k, v, causal, offset, kv_len,
                                          torch.float32),
        nbytes, flops,
        BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS,
        library=lambda: sdpa(q, ks, vs, is_causal=causal and Sq > 1,
                             enable_gqa=True))
    say("attention", f"{name} B={B} H={H} Hkv={Hkv} Sq={Sq} kv={kv} D={D} "
        f"{str(q.dtype)[6:]}->float32: K10 {fmt_row(row)} (library: "
        f"scaled_dot_product_attention); "
        f"{flops / row['device_ms'] / 1e9:.1f} TFLOP/s on the device")
    return row


class _AttnRecorder:
    """Keeps copies of K10's inputs, call by call, grouped by shape (q's
    and k's), so phase 17 can time the kernel at its own geometry.  The
    wrapped dispatcher still launches and counts as before."""

    def __init__(self):
        from repro_torch.kernels.attention import ops as a_ops
        self.ops, self.real, self.seen = a_ops, a_ops.flash_attention, {}

    def __enter__(self):
        def rec(q, k, v, causal=True, offset=None, kv_len=None,
                out_dtype=None):
            self.seen.setdefault((tuple(q.shape), tuple(k.shape)), []).append(
                (q.clone(), k.clone(), v.clone(), causal, offset, kv_len))
            return self.real(q, k, v, causal=causal, offset=offset,
                             kv_len=kv_len, out_dtype=out_dtype)

        self.ops.flash_attention = rec
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention = self.real

    def commonest(self):
        """(calls, inputs): the shape called most often, and its call with
        the median kv length (a decode step's cache fill varies)."""
        calls = max(self.seen.values(), key=len)
        by_kv = sorted(calls, key=lambda c: c[5] or c[1].shape[2])
        return len(calls), by_kv[len(by_kv) // 2]


def phase_attention(dev):
    """K10's four kernels against their plain version in bf16 and float32
    at the serve path's shapes and the larger configs' head shapes, each
    case checking which kernel ran; timings of the prefill and of decode
    steps beside the plain version and ``scaled_dot_product_attention`` (a
    yardstick only: the port never calls it)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.attention import ops as a_ops
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in fp32
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, B, H, Hkv, Sq, Skv, D, causal, kv_len in ATTN_CASES:
            q, k, v = _attn_inputs(dev, dtype, B, H, Hkv, Sq, Skv, D)
            offset = None if kv_len is None else kv_len - Sq
            kind = flash.variant(dtype, Sq, H // Hkv, D)
            for out_dtype in dict.fromkeys((dtype, torch.float32)):
                build.reset_launches()
                got = a_ops.flash_attention(q, k, v, causal=causal,
                                            offset=offset, kv_len=kv_len,
                                            out_dtype=out_dtype)
                torch.cuda.synchronize()
                tag = f"{name} {str(dtype)[6:]}->{str(out_dtype)[6:]} " \
                    f"({kind})"
                if build.launches()[f"flash_attention_{kind}"] != 1:
                    raise AssertionError(f"{tag}: the {kind} kernel did not "
                                         f"run ({build.launches()})")
                errs[tag] = check_attention(tag, got, q, k, v, causal,
                                            offset, kv_len)
                del got
    for tag, (e, used) in errs.items():
        say("attention", f"{tag}: max abs err {e:.3e}, {used:.3f} of the "
            "limit")
    kinds = {t.rsplit("(", 1)[1][:-1] for t in errs}
    if kinds != {"f32_decode", "f32_prefill", "prefill", "decode"}:
        raise AssertionError(f"phase 15 ran only the {sorted(kinds)} kernels")
    say("attention", f"K10 agrees with its plain version on {len(errs)} "
        f"cases (limit {ATTN_TOL} * (1 + |want|), plus for bf16 inputs "
        "2**-7 * (sum_j (p_j / l) |v_j| + |o| if the output is bf16))")

    cases = {c[0]: c for c in ATTN_CASES}
    rows = {row: _attn_row(dev, torch.bfloat16, cases[case])
            for row, case in ATTN_TIMED}
    # the float32 kernels at the prefill and at a 4096-row cache; the
    # kernels line takes their rows at phase 17's own shapes, where their
    # launches are counted
    for case in ("prefill", "decode kv_len=4096"):
        _attn_row(dev, torch.float32, cases[case])
    for dtype, case in ((torch.bfloat16, "decode kv_len=256"),
                        (torch.bfloat16, "decode kv_len=4096"),
                        (torch.float32, "decode kv_len=4096")):
        B, H, Hkv, Sq, Skv, D, _, kv = cases[case][1:]
        q, k, v = _attn_inputs(dev, dtype, B, H, Hkv, Sq, Skv, D)
        times = {n: device_ms(lambda: flash.flash_attention_cuda(
            q, k, v, offset=kv - 1, kv_len=kv, out_dtype=torch.float32,
            splits=n)) for n in (1, 2, 4, 8, 16, 32)}
        say("attention", f"{case} {str(dtype)[6:]}: device ms by kv splits "
            f"per (batch, kv head): " + ", ".join(
                f"{n}: {t:.5f}" for n, t in times.items())
            + f"; the default takes {flash.decode_splits(B, Hkv, kv)[0]}")
    return rows


# --------------------------------------------------------------- phase 16 --
def phase_serve(dev, smi):
    """The full-width serve path: smollm-135m on the card from a seeded
    generator, a 4 x 2048-token prefill, then ``launch.serve.lm_main`` at
    its CLI defaults, with the launch counts zeroed just before it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, 0, device=dev)
    n_params = sum(p.numel() for p in [params["emb"], params["ln_f"]] +
                   [w for lp in params["layers"] for w in lp.values()])
    say("serve", f"{cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, head_dim "
        f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; {n_params} params "
        f"({cfg.param_dtype}, compute {cfg.compute_dtype}), init "
        f"{time.perf_counter() - t0:.2f} s")
    B, S = LM_PREFILL
    toks = torch.randint(0, cfg.vocab, (B, S),
                         generator=torch.Generator().manual_seed(1))
    lm.prefill(cfg, params, {"tokens": toks[:, :64]}, device=dev)  # warm-up
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = lm.prefill(cfg, params, {"tokens": toks}, device=dev)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    pre_counts = build.launches()
    pre_launches = pre_counts["flash_attention"]
    if tuple(logits.shape) != (B, 1, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} are not "
                             "finite [B, 1, V]")
    if pre_launches != cfg.n_layers or \
            pre_counts["flash_attention_prefill"] != cfg.n_layers:
        raise AssertionError(f"prefill launched K10 {pre_launches} times "
                             f"({pre_counts['flash_attention_prefill']} of "
                             f"them the prefill kernel), not once per layer "
                             f"({cfg.n_layers})")
    say("serve", f"prefill {B} x {S} tokens: {t_pre * 1e3:.1f} ms "
        f"({B * S / t_pre:.0f} tok/s), K10 launches {pre_launches}, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params, logits

    args = serve.build_parser().parse_args([])
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = serve.lm_main(args)
    launches = build.launches()
    steps = res.decode_steps
    stats = dict(arch=cfg.name, requests=args.requests, slots=args.slots,
                 max_new=args.max_new, cache_len=args.cache_len,
                 done=res.done, n_tokens=res.n_tokens, seconds=res.seconds,
                 decode_steps=steps, prefill_steps=res.prefill_steps,
                 tok_per_s=res.n_tokens / res.seconds,
                 ms_per_step=res.seconds / steps * 1e3,
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                 prefill_ms=t_pre * 1e3, prefill_tokens=B * S, gpu=smi)
    say("serve", f"lm_main at CLI defaults ({args.requests} requests, "
        f"{args.slots} slots, max-new {args.max_new}, cache {args.cache_len})"
        f": served {res.done}, {res.n_tokens} tokens in {res.seconds:.3f} s "
        f"= {stats['tok_per_s']:.1f} tok/s; {steps} decode steps "
        f"({res.prefill_steps} of them prefill) at "
        f"{stats['ms_per_step']:.2f} ms each; peak memory "
        f"{stats['peak_gib']:.3f} GiB; K10 launches "
        f"{launches['flash_attention']} (decode kernel "
        f"{launches['flash_attention_decode']}); on {smi}")
    if res.done != args.requests or res.n_tokens <= 0:
        raise AssertionError(f"served {res.done} of {args.requests} "
                             f"requests, {res.n_tokens} tokens")
    if res.nonfinite_steps:
        raise AssertionError(f"{res.nonfinite_steps} decode steps gave "
                             "non-finite logits")
    if launches["flash_attention"] != steps * cfg.n_layers or \
            launches["flash_attention_decode"] != steps * cfg.n_layers:
        raise AssertionError(f"K10 launched {launches['flash_attention']} "
                             f"times ({launches['flash_attention_decode']} "
                             f"the decode kernel), not {steps} steps x "
                             f"{cfg.n_layers}")
    return {"flash_attention_prefill": pre_counts["flash_attention_prefill"],
            "flash_attention_decode": launches["flash_attention_decode"]}, \
        stats


# --------------------------------------------------------------- phase 17 --
def phase_lm_card_vs_cpu(dev, requests=6, slots=3, max_new=8, cache_len=48,
                         prompt=(2, 40)):
    """Reduced smollm-135m with the same weights, card (K10) against CPU
    (plain versions), in float32 and in bf16 compute.  ``lm.prefill`` of
    ``prompt`` (batch, tokens) seeded tokens: 80 query rows per kv head, so
    the prefill kernel; logits within the tolerance.  Then a short serve
    run (decode steps, so the decode kernel) on the card records its
    logits and picks; the CPU run replays the card's picks (so both runs
    follow one token path) and checks its own logits and its own greedy
    picks against them.  Where the CPU's greedy pick differs from the
    card's, the CPU's top two logits must lie within the tolerance; the
    phase counts those picks."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.models import lm
    out = {}
    kernel = {"float32": "flash_attention_f32_decode",
              "bfloat16": "flash_attention_decode"}
    pre_kernel = {"float32": "flash_attention_f32_prefill",
                  "bfloat16": "flash_attention_prefill"}
    for cd in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config(LM_ARCH).reduced(),
                                  compute_dtype=cd)
        queue = serve.make_queue(cfg, requests, 0)
        seen = []
        params = lm.init_params(cfg, 0, device=dev)
        cpu_params = lm.init_params(cfg, 0, device="cpu")
        toks = torch.randint(0, cfg.vocab, prompt,
                             generator=torch.Generator().manual_seed(1))
        build.reset_launches()
        with _AttnRecorder() as pre_calls:
            got = lm.prefill(cfg, params, {"tokens": toks}, device=dev)
        pre_counts = build.launches()
        want = lm.prefill(cfg, cpu_params, {"tokens": toks}, device="cpu")
        pre_tol = LM_TOL[cd] * (1.0 if cd == "float32" else
                                float(want.abs().max()))
        pre_err = float((got.cpu() - want).abs().max())
        if not pre_err <= pre_tol:
            raise AssertionError(f"{cd}: card and CPU prefill logits differ "
                                 f"by {pre_err:.3e} > {pre_tol:.3e}")
        if pre_counts[pre_kernel[cd]] != pre_counts["flash_attention"] or \
                pre_counts["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"{cd}: the prefill did not go through "
                                 f"{pre_kernel[cd]} alone, once per layer "
                                 f"({pre_counts})")

        def record(logits):
            seen.append(logits.cpu())
            return serve.greedy(logits)

        build.reset_launches()
        with _AttnRecorder() as calls:
            card = serve.serve_requests(cfg, params, queue, slots, max_new,
                                        cache_len, device=dev, pick=record)
        counts = build.launches()
        if counts[kernel[cd]] + counts[pre_kernel[cd]] != \
                counts["flash_attention"] or not counts[kernel[cd]]:
            raise AssertionError(f"{cd}: the card run did not go through "
                                 f"{kernel[cd]} and {pre_kernel[cd]} alone "
                                 f"({counts})")
        tol = LM_TOL[cd] * (1.0 if cd == "float32" else
                            max(float(x.abs().max()) for x in seen))
        steps = iter(seen)
        worst, differ = 0.0, 0

        def replay(logits):
            nonlocal worst, differ
            theirs = next(steps)
            worst = max(worst, float((theirs - logits).abs().max()))
            if worst > tol:
                raise AssertionError(f"{cd}: card and CPU decode logits "
                                     f"differ by {worst:.3e} > {tol:.3e}")
            pick = serve.greedy(theirs)
            for b in np.flatnonzero(pick != serve.greedy(logits)):
                top2 = torch.topk(logits[b], 2).values
                if float(top2[0] - top2[1]) > tol:
                    raise AssertionError(f"{cd}: card picked {pick[b]}, the "
                                         f"CPU's top logit leads by "
                                         f"{float(top2[0] - top2[1]):.3e}")
                differ += 1
            return pick

        cpu = serve.serve_requests(cfg, cpu_params, queue, slots, max_new,
                                   cache_len, device="cpu", pick=replay)
        if next(steps, None) is not None or card.done != requests or \
                card.nonfinite_steps or cpu.nonfinite_steps:
            raise AssertionError(f"{cd}: the card and CPU runs diverged")
        out[cd] = dict(steps=card.decode_steps, max_abs_err=worst, tol=tol,
                       picks_differed=differ, picks=len(seen) * slots,
                       kernel=kernel[cd], launches=counts[kernel[cd]],
                       prefill_max_abs_err=pre_err, prefill_tol=pre_tol,
                       prefill_kernel=pre_kernel[cd],
                       prefill_launches=pre_counts[pre_kernel[cd]])
        if cd == "float32":
            # K10's float32 kernels at this path's own shapes: the shape
            # each was called with most, at the median kv length of those
            for key, rec in (("row", calls), ("prefill_row", pre_calls)):
                n, (q, k, v, causal, offset, kv_len) = rec.commonest()
                shapes = {f"q{a} k{b}": len(c) for (a, b), c in
                          rec.seen.items()}
                say("lm-vs-cpu", f"float32 K10 calls by shape {shapes}; "
                    f"timed at the commonest ({n} calls), at its median kv "
                    "length")
                out[cd][key] = _attn_row_on(f"reduced {LM_ARCH} float32",
                                            q, k, v, causal, offset, kv_len)
        say("lm-vs-cpu", f"reduced {LM_ARCH} compute {cd}: prefill "
            f"{prompt[0]} x {prompt[1]} tokens, logits max abs err "
            f"{pre_err:.3e} (tol {pre_tol:.3e}), "
            f"{pre_counts[pre_kernel[cd]]} launches of {pre_kernel[cd]}; "
            f"{requests} requests, {card.decode_steps} decode steps, logits "
            f"max abs err {worst:.3e} (tol {tol:.3e}), "
            f"{counts[kernel[cd]]} launches of {kernel[cd]}; CPU greedy "
            f"picks differed from the card's on {differ} of "
            f"{len(seen) * slots}, each within the tolerance of a top-2 tie")
    return out


# --------------------------------------------------------------- phase 18 --
def _plastic_run(dev, n, t_end, **opts):
    """Phase 3's runner (network, currents, fused horizon) on the plastic
    branched cell under ``BDFOptions(precond="schur", **opts)``: returns
    the model and the nullary runner."""
    from repro_torch.core.bdf import BDFOptions
    from repro_torch.core.cell import CellModel
    from repro_torch.core.exec_fap import make_fap_vardt_runner
    from repro_torch.core.morphology import branched_tree
    from repro_torch.core.network import make_network
    model = CellModel(branched_tree(depth=2, seg_per_branch=2),
                      with_plasticity=True, device=dev)
    net = make_network(n, k_in=K_IN, seed=NET_SEED)
    return model, make_fap_vardt_runner(
        model, net, regime_currents(n), t_end,
        opts=BDFOptions(precond="schur", **opts), horizon_impl="fused",
        device=dev)


def _per_round(stats):
    return stats["wall_s"] / max(stats["rounds"], 1) * 1e3


def _beside(name, got, ref):
    return f"{name} {got} vs {ref}"


def phase_plastic_schur(dev, t_end, main, smi):
    """The plastic cell under the Schur preconditioner at full width, on
    phase 3's network and currents, counts zeroed just before."""
    from repro_torch.kernels import build
    model, run = _plastic_run(dev, N_MAIN, t_end)
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, rounds = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = build.launches()
    spikes = _gate_run("plastic-schur", res)
    solver = {k: int(v) for k, v in res.solver.items()}
    rho = res.y_final[:, -1]
    rho_lo, rho_hi = float(rho.min()), float(rho.max())
    width = model.n_factors("schur")
    fac_mb = N_MAIN * width * 8 / 1e6
    out = dict(t_end=t_end, rounds=rounds, wall_s=wall, spikes=spikes,
               n_steps=int(res.n_steps), n_events=int(res.n_events),
               solver=solver, rho=[rho_lo, rho_hi], factor_mb=fac_mb,
               launches=launches)
    say("plastic-schur", f"N={N_MAIN} C=13 plastic (n_state "
        f"{model.n_state}) k_in={K_IN} t_end={t_end} ms precond=schur "
        f"horizon_impl=fused: rounds {rounds}, n_steps {int(res.n_steps)}, "
        f"n_events {int(res.n_events)}, spikes {spikes}, dropped "
        f"{int(res.dropped)}, failed {bool(res.failed)}; rho in "
        f"[{rho_lo:.6f}, {rho_hi:.6f}]; factor rows {width} float64 a "
        f"neuron, {fac_mb:.1f} MB")
    say("plastic-schur", f"solver {json.dumps(solver)}")
    ms = main["solver"]
    say("plastic-schur", "beside phase 3 (the same network, currents and "
        "t_end; no plasticity, precond=neuron): " + ", ".join(
            [_beside("rounds", rounds, main["rounds"]),
             _beside("n_steps", int(res.n_steps), main["n_steps"])]
            + [_beside(k, solver[k], ms[k])
               for k in ("nni", "nncf", "nsetups", "netf")]
            + [_beside("spikes", spikes, main["spikes"]),
               f"wall {wall:.2f} vs {main['wall_s']:.2f} s",
               f"{_per_round(out):.1f} vs {_per_round(main):.1f} ms per "
               f"round on {smi}"]) + f"; launches {json.dumps(launches)}")
    if rounds >= 1_000_000:
        raise AssertionError("plastic-schur: did not reach t_end")
    if not (0.0 <= rho_lo and rho_hi <= 1.0) \
            or not bool(torch.isfinite(res.y_final).all()):
        raise AssertionError(f"plastic-schur: rho in [{rho_lo}, {rho_hi}] "
                             f"or a non-finite state")
    missing = [k for k in DENSE_PATH if launches[k] <= 0]
    if missing:
        raise AssertionError(f"plastic-schur path never launched {missing}")
    return out


# --------------------------------------------------------------- phase 19 --
def _spec_run(dev, n, t_end, **knobs):
    """``make_spec_runner`` on phase 3's cell, network and currents with
    the wheel sized from the network (``WheelSpec.auto``)."""
    from repro_torch.core.exec_speculative import make_spec_runner
    from repro_torch.sched import WheelSpec
    model, net = _baseline_model_net(dev, n)
    return make_spec_runner(model, net, regime_currents(n), t_end,
                            queue="wheel", wheel=WheelSpec.auto(net),
                            device=dev, **knobs)()


def phase_speculative(dev, t_end, main, spike_cap, smi):
    """Carefully-speculative 2c at full width with compact fan-out and the
    wheel, counts zeroed just before; spikes held to phase 3's before
    ``t_end``."""
    from repro_torch.kernels import build
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, stats, rounds = _spec_run(dev, N_MAIN, t_end, fanout="compact",
                                   spike_cap=spike_cap)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = build.launches()
    spikes = _gate_run("speculative", res)
    st = {k: int(v) for k, v in stats._asdict().items()}
    counts = res.rec.count.cpu().numpy()
    main_counts = (main["ref"]["times"] < t_end).sum(dim=1).numpy()
    main_spikes = int(main_counts.sum())
    differ = int((counts != main_counts).sum())
    solver = {k: int(v) for k, v in res.solver.items()}
    out = dict(t_end=t_end, rounds=rounds, wall_s=wall, spikes=spikes,
               n_steps=int(res.n_steps), n_events=int(res.n_events),
               spec=st, spike_count_differs=differ, spike_cap=spike_cap,
               solver=solver, launches=launches)
    say("speculative", f"N={N_MAIN} C=13 k_in={K_IN} t_end={t_end} ms "
        f"horizon_cap 2, spec_window 2, fanout=compact spike_cap="
        f"{spike_cap} (phase 4's), queue=wheel: rounds {rounds}, validated "
        f"n_steps {int(res.n_steps)}, n_events {int(res.n_events)}, spikes "
        f"{spikes}, dropped {int(res.dropped)}, failed {bool(res.failed)}; "
        f"SpecStats {json.dumps(st)}")
    say("speculative", f"solver (validated lanes) {json.dumps(solver)}")
    say("speculative", f"beside phase 3 (2c, dense, the same cell, network "
        f"and currents, {main['t_end']} ms): spikes before {t_end} ms "
        f"{spikes} vs {main_spikes} ({differ} neurons differ in spike "
        f"count); rounds {rounds}, validated n_steps {int(res.n_steps)}, "
        f"wall {wall:.2f} s to {t_end} ms, phase 3 {main['rounds']} rounds,"
        f" {main['n_steps']} steps, {main['wall_s']:.2f} s to "
        f"{main['t_end']} ms; {_per_round(out):.1f} vs "
        f"{_per_round(main):.1f} ms per round on {smi}; launches "
        f"{json.dumps(launches)}")
    if st["hits"] + st["backsteps"] <= 0 \
            or st["wasted_steps"] < st["backsteps"]:
        raise AssertionError(f"speculative: SpecStats {st}")
    if abs(spikes - main_spikes) > max(2, 0.1 * main_spikes):
        raise AssertionError(f"speculative: {spikes} spikes against phase "
                             f"3's {main_spikes} before {t_end} ms")
    missing = [k for k in SPEC_PATH if launches[k] <= 0]
    if missing:
        raise AssertionError(f"speculative path never launched {missing}")
    return out


# --------------------------------------------------------------- phase 20 --
def phase_new_paths_card_vs_cpu(dev, smi, n=64, t_end=4.0, spike_cap=4):
    """Phases 18 and 19's paths at N=64, card against CPU bitwise; on the
    card the speculative dense fan-out equals the compact one."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    out = {}
    for policy, kernels in (("reuse", ("hines_factor",
                                       "hines_solve_factored")),
                            ("iteration", ("hines_solve",))):
        res = []
        for d in (dev, torch.device("cpu")):
            build.reset_launches()
            res.append(_plastic_run(d, n, t_end, jac_policy=policy)[1]())
            if d == dev:
                launches = build.launches()
        (g, rg), (c, rc) = res
        same = _same_run(g, c) and rg == rc and all(
            int(g.solver[k]) == int(c.solver[k]) for k in g.solver)
        say("new-card-vs-cpu", f"2c plastic precond=schur jac_policy="
            f"{policy} N={n} C=13 t_end={t_end} ms: rounds card {rg} cpu "
            f"{rc}; spikes {int(g.rec.count.sum())}; n_steps card "
            f"{int(g.n_steps)} cpu {int(c.n_steps)}; spike trains, steps, "
            f"solver counters and final states bitwise equal: {same} "
            f"({time.perf_counter() - t0:.1f} s on {smi})")
        if not same:
            raise AssertionError(f"2c plastic schur {policy} differs card "
                                 f"vs CPU")
        _gate_run(f"2c plastic schur {policy} N={n}", c)
        if any(launches[k] <= 0 for k in kernels):
            raise AssertionError(f"2c plastic schur {policy} never "
                                 f"launched {kernels}")
        out[f"plastic_schur_{policy}"] = dict(rounds=rg,
                                              n_steps=int(g.n_steps))
    card = {}
    for fanout in ("dense", "compact"):
        res = [_spec_run(d, n, t_end, fanout=fanout, spike_cap=spike_cap)
               for d in (dev, torch.device("cpu"))]
        (g, sg, rg), (c, sc, rc) = res
        same = _same_run(g, c) and rg == rc and all(
            int(a) == int(b) for a, b in zip(sg, sc))
        say("new-card-vs-cpu", f"speculative fanout={fanout} spike_cap="
            f"{spike_cap} queue=wheel N={n} t_end={t_end} ms: rounds card "
            f"{rg} cpu {rc}; spikes {int(g.rec.count.sum())}; validated "
            f"n_steps card {int(g.n_steps)} cpu {int(c.n_steps)}; SpecStats "
            f"card {[int(x) for x in sg]} cpu {[int(x) for x in sc]}; spike "
            f"trains, steps, SpecStats and final states bitwise equal: "
            f"{same} ({time.perf_counter() - t0:.1f} s on {smi})")
        if not same:
            raise AssertionError(f"speculative {fanout} differs card vs "
                                 f"CPU")
        _gate_run(f"speculative {fanout} N={n}", c)
        card[fanout] = (g, sg, rg)
        out[f"speculative_{fanout}"] = dict(rounds=rg,
                                            n_steps=int(g.n_steps))
    (a, sa, ra), (b, sb, rb) = card["dense"], card["compact"]
    same = _same_run(a, b) and ra == rb and all(
        int(x) == int(y) for x, y in zip(sa, sb))
    say("new-card-vs-cpu", f"card, speculative dense vs compact fan-out: "
        f"rounds {ra} vs {rb}, identical event for event: {same} "
        f"({time.perf_counter() - t0:.1f} s on {smi})")
    if not same:
        raise AssertionError("speculative compact fan-out differs from "
                             "dense")
    out["wall_s"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------- phase 22 --
class _Timed:
    """Wall time of each call of ``exec_common``'s checkpoint save and
    restore while in use (``run_checkpointed`` looks both up per call)."""

    def __init__(self):
        self.saves, self.restores = [], []

    def __enter__(self):
        from repro_torch.core import exec_common as xc
        self.real = xc.save_sim_checkpoint, xc.restore_sim_checkpoint

        def timed(fn, into):
            def call(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                into.append(time.perf_counter() - t0)
                return out
            return call

        xc.save_sim_checkpoint = timed(self.real[0], self.saves)
        xc.restore_sim_checkpoint = timed(self.real[1], self.restores)
        return self

    def __exit__(self, *exc):
        from repro_torch.core import exec_common as xc
        xc.save_sim_checkpoint, xc.restore_sim_checkpoint = self.real


def _ms(times):
    return statistics.mean(times) * 1e3 if times else 0.0


def phase_checkpoint(dev, t_end, main, smi, every=8):
    """Phase 3's runner at full width with ``checkpoint_every=8``: a
    ``FaultPlan`` kill at 0.6 of phase 3's rounds raises
    ``SimulatedFailure`` at that round, and ``resume=True`` then reproduces
    phase 3 bitwise, launching K1, K2, K4 and K5 (counts zeroed just
    before each run)."""
    from repro_torch.checkpoint import FaultPlan, SimulatedFailure
    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.kernels import build
    run = _runner(dev, N_MAIN, t_end)
    kill = int(0.6 * main["rounds"])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d, _Timed() as tm:
        build.reset_launches()
        try:
            run(checkpoint_every=every, ckpt_dir=d,
                fault=FaultPlan(fail_at_round=kill))
            failed_at = None
        except SimulatedFailure as e:
            failed_at = e.step
        kill_wall = time.perf_counter() - t0
        kill_launches = build.launches()
        if failed_at != kill:
            raise AssertionError(f"checkpoint: the kill at round {kill} "
                                 f"raised at {failed_at}")
        last = ck.latest_step(d)
        nbytes = ck.read_manifest(ck.step_path(d, last))["total_bytes"]
        n_saves = len(tm.saves)
        build.reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res, rounds = run(checkpoint_every=every, ckpt_dir=d, resume=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = build.launches()
    h = res.health
    same = _same_host(_host_result(res), main["ref"]) \
        and rounds == main["rounds"]
    out = dict(every=every, kill=kill, resumed_from=h["resumed_from"],
               rounds=rounds, checkpoint_bytes=nbytes,
               save_ms=_ms(tm.saves), restore_ms=_ms(tm.restores),
               saves=len(tm.saves), kill_wall_s=kill_wall,
               resume_wall_s=wall, checks=h["checks"], launches=launches,
               kill_launches=kill_launches)
    say("checkpoint", f"N={N_MAIN} C=13 t_end={t_end} ms checkpoint_every="
        f"{every}: SimulatedFailure at round {failed_at} ({kill_wall:.2f} s,"
        f" {n_saves} saves); resumed from round {h['resumed_from']} to "
        f"round {rounds} ({wall:.2f} s, {h['checks']} rounds checked, "
        f"{h['checkpoints_saved']} saves); bitwise equal to phase 3 (spike "
        f"trains, final zn[:, 0], steps, events, resets, solver and sched "
        f"counters): {same}")
    say("checkpoint", f"checkpoint {nbytes} bytes ({nbytes / 2**20:.1f} "
        f"MiB); save {_ms(tm.saves):.1f} ms (mean of {len(tm.saves)}), "
        f"restore {_ms(tm.restores):.1f} ms (mean of {len(tm.restores)}); "
        f"resumed run {wall / max(rounds - h['resumed_from'], 1) * 1e3:.1f}"
        f" ms per round beside phase 3's {_per_round(main):.1f} on {smi}; "
        f"launches {json.dumps(launches)}")
    if not same:
        raise AssertionError("checkpoint: the resumed run differs from "
                             "phase 3")
    if h["resumed_from"] != (kill // every) * every or \
            h["rollbacks"] or h["nonfinite_rounds"]:
        raise AssertionError(f"checkpoint: health {h}")
    missing = [k for k in DENSE_PATH if launches[k] <= 0]
    if missing:
        raise AssertionError(f"checkpoint: the resumed run never launched "
                             f"{missing}")
    return out


# --------------------------------------------------------------- phase 23 --
def _service_currents(n, seed=0):
    """Tenant currents in [i_active, i_burst] of the branched cell
    (benchmarks/_calibration.json) and QoS classes 0-1, from ``seed``."""
    rng = np.random.default_rng(seed)
    cur = I_ACTIVE_BRANCHED + (I_BURST_BRANCHED - I_ACTIVE_BRANCHED) * \
        rng.random(n)
    return [float(c) for c in cur], [int(q) for q in rng.integers(0, 2, n)]


def _service(run, t_end, lanes, reqs, **kw):
    from repro_torch.serve import SimService
    svc = SimService(runner=run, t_end=t_end, lanes=lanes, **kw)
    for r in reqs:
        svc.submit(r)
    return svc.run()


def _sim_runner(dev, n, t_end, **knobs):
    """The service's runner: phase 3's cell, network and horizon (the fused
    one unless ``knobs`` say otherwise), the currents per tenant; a wheel
    is sized from the network."""
    from repro_torch.core.exec_fap import make_fap_vardt_runner
    from repro_torch.sched import WheelSpec
    model, net = _baseline_model_net(dev, n)
    kw = dict(dict(horizon_impl="fused"), **knobs)
    if kw.get("queue") == "wheel":
        kw["wheel"] = WheelSpec.auto(net)
    return make_fap_vardt_runner(model, net, 0.0, t_end, device=dev, **kw)


def phase_service(dev, main, smi, lanes=4, tenants=8, t_end=3.0):
    """``SimService`` at full width: 4 lanes of N = 16384, 8 tenants, a
    poisoned tenant; counts zeroed just before the batched service."""
    from repro_torch.checkpoint import FaultPlan
    from repro_torch.kernels import build
    from repro_torch.serve import TenantRequest
    run = _sim_runner(dev, N_MAIN, t_end)
    cur, qos = _service_currents(tenants)
    reqs = [TenantRequest(rid=r, iinj=cur[r], qos=qos[r])
            for r in range(tenants)]
    caps = {0: N_MAIN // 4}
    poisoned, clean = 1, 0
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = _service(run, t_end, lanes, reqs, qos_caps=caps,
                   fault=FaultPlan(poison_tenant=poisoned,
                                   poison_at_round=4))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = build.launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    solo = {}
    t1 = time.perf_counter()
    for rid in (poisoned, clean):
        solo[rid] = _service(run, t_end, 1, [reqs[rid]], qos_caps=caps)
    solo_wall = time.perf_counter() - t1
    spikes = {rid: int(r.count.sum()) for rid, r in res.results.items()
              if r.status == "completed"}
    same = {rid: np.array_equal(res.results[rid].times,
                                solo[rid].results[rid].times)
            and np.array_equal(res.results[rid].count,
                               solo[rid].results[rid].count)
            for rid in solo}
    w = res.health["admission_wait_rounds"]
    per_round = wall / max(res.rounds, 1) * 1e3
    out = dict(lanes=lanes, tenants=tenants, t_end=t_end, rounds=res.rounds,
               wall_s=wall, ms_per_round=per_round,
               tenant_ms_per_s=tenants * t_end / wall, peak_gib=peak,
               completed=res.completed, quarantines=res.quarantines,
               retried=res.retried, wait_rounds=w, spikes=spikes,
               solo_wall_s=solo_wall, solo_identical=same,
               tenant_rounds={rid: r.rounds for rid, r in res.results.items()},
               qos=qos, currents=cur, launches=launches)
    say("service", f"SimService {lanes} lanes x N={N_MAIN} C=13 "
        f"({lanes * N_MAIN} neurons a round), {tenants} tenants t_end="
        f"{t_end} ms, currents {[round(c, 4) for c in cur]} nA, QoS "
        f"{qos} (cap {caps}), poisoned rid {poisoned} at its round 4: "
        f"{res.completed} completed, {res.evicted} evicted, {res.rejected} "
        f"rejected, {res.quarantines} quarantines, {res.retried} retries; "
        f"spikes {json.dumps(spikes)}")
    say("service", f"{res.rounds} service rounds in {wall:.2f} s, "
        f"{per_round:.1f} ms per service round beside phase 3's "
        f"{_per_round(main):.1f} ms per round "
        f"({per_round / _per_round(main):.2f}x), "
        f"{tenants * t_end / wall:.3f} tenant-ms per wall second; "
        f"admission wait mean {w['mean']:.1f} max {w['max']} rounds; peak "
        f"memory {peak:.2f} GiB on {smi}; launches {json.dumps(launches)}")
    say("service", f"solo 1-lane services of rid {poisoned} (poisoned in "
        f"the batch) and rid {clean}: bitwise equal to the batch: "
        f"{json.dumps({str(k): v for k, v in same.items()})} "
        f"({solo_wall:.2f} s)")
    if res.completed != tenants or res.quarantines < 1:
        raise AssertionError(f"service: {res.completed} of {tenants} "
                             f"completed, {res.quarantines} quarantines")
    if not all(same.values()):
        raise AssertionError("service: a tenant differs from its solo run")
    if min(spikes.values()) <= 0:
        raise AssertionError(f"service: a tenant without spikes {spikes}")
    missing = [k for k in DENSE_PATH if launches[k] <= 0]
    if missing:
        raise AssertionError(f"service path never launched {missing}")
    return out


# --------------------------------------------------------------- phase 24 --
def _robust_pair(dev, n, t_end, d):
    """A kill at 0.6 of the rounds then a resume, and a run with a
    poisoned lane, of phase 3's runner at width ``n`` on ``dev``."""
    from repro_torch.checkpoint import FaultPlan, SimulatedFailure
    run = _runner(dev, n, t_end)
    plain, rounds = run()
    try:
        run(checkpoint_every=4, ckpt_dir=f"{d}/kill",
            fault=FaultPlan(fail_at_round=int(0.6 * rounds)))
        raise AssertionError("robust card-vs-CPU: the kill did not fire")
    except SimulatedFailure:
        pass
    resumed, r1 = run(checkpoint_every=4, ckpt_dir=f"{d}/kill", resume=True)
    poisoned, r2 = run(checkpoint_every=4, ckpt_dir=f"{d}/poison",
                       fault=FaultPlan(poison_at_round=rounds // 3,
                                       poison_lane=n // 2))
    if poisoned.health["rollbacks"] != 1:
        raise AssertionError(f"robust card-vs-CPU: health "
                             f"{poisoned.health}")
    return [(_host_result(r), rr) for r, rr in ((plain, rounds),
                                                 (resumed, r1),
                                                 (poisoned, r2))]


def _spmd_robust_rank(group, n, t_end, d, world_of_ckpt):
    """On four ranks: the full-stack run, then killed and resumed; on two
    ranks: the resume of the four-rank checkpoints (``world_of_ckpt``)."""
    from repro_torch.checkpoint import FaultPlan, SimulatedFailure
    from repro_torch.core.cell import CellModel
    from repro_torch.core.morphology import branched_tree
    from repro_torch.core.network import make_network
    from repro_torch.distributed.exchange import ExchangeSpec
    from repro_torch.distributed.fap_spmd import run_fap_spmd
    model = CellModel(branched_tree(depth=2, seg_per_branch=2),
                      device=group.device)
    net = make_network(n, k_in=K_IN, seed=NET_SEED)
    kw = dict(transport="sparse", exchange=ExchangeSpec(parcel_cap=64),
              batch="compact", batch_cap=n // 2, horizon="incremental")

    def run(**more):
        res, rounds = run_fap_spmd(model, net, regime_currents(n), t_end,
                                   group, **kw, **more)
        return dict(ref=_host_result(res), rounds=rounds,
                    health=res.health)

    if group.world != world_of_ckpt:
        return run(ckpt_dir=d, resume=True)
    base = run()
    try:
        run(checkpoint_every=5, ckpt_dir=d,
            fault=FaultPlan(fail_at_round=int(0.6 * base["rounds"])))
        raise AssertionError("spmd robust: the kill did not fire")
    except SimulatedFailure:
        pass
    return dict(base=base, resumed=run(ckpt_dir=d, resume=True))


def phase_robust_card_vs_cpu(dev, smi, n=64, t_end=4.0, lanes=3, tenants=5,
                             t_service=3.0, n_spmd=256):
    """Kill/resume and poison rollback at N = 64, card against CPU
    bitwise; a 3-lane, 5-tenant service card against CPU bitwise; the
    SPMD round at N = 256 on four card ranks killed and resumed on four
    and on two ranks."""
    from repro_torch.checkpoint import FaultPlan
    from repro_torch.distributed.group import launch
    from repro_torch.kernels import build
    from repro_torch.serve import TenantRequest
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        card = _robust_pair(dev, n, t_end, f"{d}/card")
        cpu = _robust_pair(torch.device("cpu"), n, t_end, f"{d}/cpu")
    (p, rp), (k, rk), (q, rq) = card
    inner = _same_host(p, k) and _same_host(p, q) and rp == rk == rq
    across = all(_same_host(a, b) and ra == rb
                 for (a, ra), (b, rb) in zip(card, cpu))
    say("robust-card-vs-cpu", f"N={n} C=13 t_end={t_end} ms: rounds {rp}, "
        f"spikes {int(p['count'].sum())}; on the card kill/resume and "
        f"poison rollback == the plain run: {inner}; card == CPU bitwise "
        f"(plain, resumed, rolled back): {across} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not (inner and across) or int(p["count"].sum()) <= 0:
        raise AssertionError("robust card-vs-CPU: runs differ")
    from repro_torch.core.network import regime_current
    # above the fast regime: every tenant spikes within 3 ms and the CPU
    # side stays short (phase 23 runs the QoS cap)
    cur = [regime_current("fast", I_THRESH_BRANCHED) * (1.2 + 0.05 * r)
           for r in range(tenants)]
    reqs = [TenantRequest(rid=r, iinj=cur[r]) for r in range(tenants)]
    a, b = [_service(_sim_runner(dv, n, t_service), t_service, lanes, reqs,
                     fault=FaultPlan(poison_tenant=2, poison_at_round=3))
            for dv in (dev, torch.device("cpu"))]
    same = a.rounds == b.rounds and all(
        (a.results[r].status, a.results[r].retries, a.results[r].rounds)
        == (b.results[r].status, b.results[r].retries, b.results[r].rounds)
        and np.array_equal(a.results[r].times, b.results[r].times)
        for r in range(tenants))
    spikes = [int(a.results[r].count.sum()) for r in range(tenants)]
    say("robust-card-vs-cpu", f"SimService {lanes} lanes x N={n}, "
        f"{tenants} tenants, t_end={t_service} ms, rid 2 poisoned: "
        f"{a.completed} completed, {a.quarantines} quarantines, {a.rounds} "
        f"rounds, spikes {spikes}; card == CPU bitwise (statuses, retries, "
        f"rounds, spike trains): {same} ({time.perf_counter() - t0:.1f} s)")
    if not same or a.completed != tenants or a.quarantines < 1 \
            or min(spikes) <= 0:
        raise AssertionError("robust card-vs-CPU: the services differ")
    # the service over compact runners: the incremental (scatter) horizon
    # and the fused one, each tenant its own compact batch and fan-out;
    # one wave of tenants (the poisoned one among them)
    compact = {}
    reqs = reqs[:lanes]
    for hi in ("scatter", "fused"):
        build.reset_launches()
        knobs = dict(COMPACT_SMALL, batch_cap=n // 2, horizon_impl=hi)
        ca, cb = [_service(_sim_runner(dv, n, t_service, **knobs),
                           t_service, lanes, reqs,
                           fault=FaultPlan(poison_tenant=2,
                                           poison_at_round=3))
                  for dv in (dev, torch.device("cpu"))]
        launched = build.launches()
        c_same = ca.rounds == cb.rounds and all(
            (ca.results[r].status, ca.results[r].retries,
             ca.results[r].rounds)
            == (cb.results[r].status, cb.results[r].retries,
                cb.results[r].rounds)
            and np.array_equal(ca.results[r].times, cb.results[r].times)
            for r in range(lanes))
        c_spikes = [int(ca.results[r].count.sum()) for r in range(lanes)]
        say("robust-card-vs-cpu", f"SimService {lanes} lanes x N={n} over "
            f"the compact runner {knobs}: {ca.completed} completed, "
            f"{ca.quarantines} quarantines, {ca.rounds} rounds, spikes "
            f"{c_spikes}; card == CPU bitwise (statuses, retries, rounds, "
            f"spike trains): {c_same}; rows-kernel launches K6 "
            f"{launched['compact_ids_rows']}, K7 "
            f"{launched['compact_gather_rows']} "
            f"({time.perf_counter() - t0:.1f} s)")
        if not c_same or ca.completed != lanes or ca.quarantines < 1 \
                or min(c_spikes) <= 0 or launched["compact_ids_rows"] <= 0 \
                or launched["compact_gather_rows"] <= 0:
            raise AssertionError(f"robust card-vs-CPU: the compact services "
                                 f"({hi} horizon) differ")
        compact[hi] = ca.rounds
    with tempfile.TemporaryDirectory() as d:
        four = launch(RANKS, _spmd_robust_rank, n_spmd, t_end, d, RANKS,
                      backend="gloo", device=dev)
        two = launch(2, _spmd_robust_rank, n_spmd, t_end, d, RANKS,
                     backend="gloo", device=dev)
    base, res = four["base"], four["resumed"]
    same4 = _same_host(base["ref"], res["ref"]) and \
        base["rounds"] == res["rounds"]
    same2 = _same_host(base["ref"], two["ref"]) and \
        base["rounds"] == two["rounds"]
    say("robust-card-vs-cpu", f"SPMD N={n_spmd} t_end={t_end} ms sparse, "
        f"compact, incremental horizon on the card: rounds "
        f"{base['rounds']}, spikes {int(base['ref']['count'].sum())}; "
        f"killed on {RANKS} ranks, resumed from round "
        f"{res['health']['resumed_from']} on {RANKS} ranks bitwise: {same4}"
        f"; on 2 ranks (elastic_reseeded "
        f"{two['health']['elastic_reseeded']}) bitwise: {same2} "
        f"({time.perf_counter() - t0:.1f} s on {smi})")
    if not (same4 and same2) or not two["health"]["elastic_reseeded"] \
            or res["health"]["elastic_reseeded"]:
        raise AssertionError("robust SPMD: resumed runs differ")
    return dict(n=n, t_end=t_end, rounds=rp, service_rounds=a.rounds,
                compact_service_rounds=compact, spmd_rounds=base["rounds"],
                wall_s=time.perf_counter() - t0)


# --------------------------------------------------------------- phase 25 --
# The four families ported last, served at full width.  qwen3-moe keeps 16
# of its 48 layers: its 128 experts take 2.4 GB a layer in float32, so 48
# layers (117 GB) do not fit the card's 80 GB.
FAMILY_ARCHS = ("whisper-base", "rwkv6-7b", "zamba2-7b", "qwen3-moe-30b-a3b")
FAMILY_DEPTH = {"qwen3-moe-30b-a3b": 16}
# K10 launches per decode step and in the prefill, and the head size
# each runs at: the MoE's attention once a layer (GQA group 8); zamba2's
# shared block once per application, 81 // 6 = 13; whisper's decoder
# self- and cross-attention per step, and its 6 encoder layers on top in
# the prefill; RWKV6 attends to nothing.
FAMILY_K10 = {"qwen3-moe-30b-a3b": (16, 16, 64), "zamba2-7b": (13, 13, 112),
              "whisper-base": (12, 18, 64), "rwkv6-7b": (0, 0, None)}
FAMILY_PREFILL = (2, 128)          # prompts x tokens of lm.prefill
FAMILY_SERVE = dict(requests=4, slots=4, max_new=8, cache_len=64)
PEAK_GIB = 75.0


class _AttnShapes:
    """Records the (q, k) shapes of every K10 call, without copies; the
    wrapped dispatcher still launches and counts as before."""

    def __init__(self):
        from repro_torch.kernels.attention import ops as a_ops
        self.ops, self.real, self.shapes = a_ops, a_ops.flash_attention, []

    def __enter__(self):
        def rec(q, k, v, **kw):
            self.shapes.append((tuple(q.shape), tuple(k.shape)))
            return self.real(q, k, v, **kw)

        self.ops.flash_attention = rec
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention = self.real


def _family_cfg(arch):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch in FAMILY_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=FAMILY_DEPTH[arch])
    return cfg


def _n_params(tree):
    if isinstance(tree, dict):
        return sum(_n_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_n_params(v) for v in tree)
    return tree.numel()


def _k10_gate(tag, counts, shapes, want, kernel, D):
    """K10 launched ``want`` times, all by ``kernel``, at head size D."""
    bad = [s for s in shapes if s[0][-1] != D]
    if counts["flash_attention"] != want or \
            counts[f"flash_attention_{kernel}"] != want or bad:
        raise AssertionError(f"{tag}: K10 launched {counts['flash_attention']}"
                             f" times ({counts[f'flash_attention_{kernel}']} "
                             f"by the {kernel} kernel), not {want}; head "
                             f"sizes {sorted({s[0][-1] for s in shapes})}")


def phase_families(dev, smi):
    """Whisper-base, rwkv6-7b, zamba2-7b and qwen3-moe-30b-a3b (16 of 48
    layers) at published width, weights drawn on the card from a seeded
    CUDA generator: ``lm.prefill`` of 2 x 128 seeded tokens (whisper also
    [2, 1500, 512] seeded frames), then ``serve.serve_requests`` of the
    requests ``lm_main --requests 4 --slots 4 --max-new 8 --cache-len 64
    --seed 0`` serves.  Each model is freed before the next."""
    import gc

    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.models import lm
    out = {}
    for arch in FAMILY_ARCHS:
        cfg = _family_cfg(arch)
        per_step, in_prefill, D = FAMILY_K10[arch]
        cut = f", {cfg.n_layers} of its 48 layers (128 experts x 2.4 GB a " \
            "layer in float32: 48 layers do not fit 80 GB)" \
            if arch in FAMILY_DEPTH else f", all {cfg.n_layers} layers"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(0)
        params = lm.init_params(cfg, gen, device=dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n = _n_params(params)
        say("families", f"{cfg.name} [{cfg.source}]: family {cfg.family}"
            f"{cut}, d_model {cfg.d_model}, heads {cfg.n_heads}/"
            f"{cfg.n_kv_heads}, head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab}; {n} params ({cfg.param_dtype}, compute "
            f"{cfg.compute_dtype}), drawn on the card in {t_init:.2f} s")
        B, S = FAMILY_PREFILL
        batch = {"tokens": torch.randint(
            0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(1))}
        if cfg.family == "audio":
            batch["frames"] = torch.randn((B, cfg.enc_frames, cfg.d_model),
                                          generator=gen, device=dev)
        build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _AttnShapes() as pre_shapes:
            logits = lm.prefill(cfg, params, batch, device=dev)
            torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        pre = build.launches()
        if tuple(logits.shape) != (B, 1, cfg.vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{arch}: prefill logits "
                                 f"{tuple(logits.shape)} are not finite "
                                 "[B, 1, V]")
        _k10_gate(f"{arch} prefill", pre, pre_shapes.shapes, in_prefill,
                  "prefill", D)
        del logits, batch
        build.reset_launches()
        with _AttnShapes() as shapes:
            res = serve.serve_requests(
                cfg, params, serve.make_queue(cfg, FAMILY_SERVE["requests"],
                                              0),
                FAMILY_SERVE["slots"], FAMILY_SERVE["max_new"],
                FAMILY_SERVE["cache_len"], device=dev)
        counts = build.launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = res.decode_steps
        if res.done != FAMILY_SERVE["requests"] or res.nonfinite_steps:
            raise AssertionError(f"{arch}: served {res.done} requests, "
                                 f"{res.nonfinite_steps} steps with a "
                                 "non-finite logit")
        _k10_gate(f"{arch} serve", counts, shapes.shapes, steps * per_step,
                  "decode", D)
        if peak >= PEAK_GIB:
            raise AssertionError(f"{arch}: peak memory {peak:.2f} GiB")
        out[arch] = dict(
            layers=cfg.n_layers, params=n, init_s=t_init,
            prefill_ms=t_pre * 1e3, prefill_k10=pre["flash_attention"],
            requests=res.done, tokens=res.n_tokens, decode_steps=steps,
            prefill_steps=res.prefill_steps, seconds=res.seconds,
            ms_per_step=res.seconds / steps * 1e3,
            tok_per_s=res.n_tokens / res.seconds,
            k10_per_step=counts["flash_attention"] / steps, peak_gib=peak,
            gpu=smi)
        say("families", f"{cfg.name}: prefill {B} x {S} in {t_pre * 1e3:.1f}"
            f" ms ({pre['flash_attention']} K10 launches"
            f"{'' if D is None else ', all by the prefill kernel'}); served {res.done} requests, {res.n_tokens} tokens, "
            f"{steps} decode steps ({res.prefill_steps} prefill) at "
            f"{out[arch]['ms_per_step']:.2f} ms each = "
            f"{out[arch]['tok_per_s']:.1f} tok/s, {per_step} K10 decode-"
            f"kernel launches a step{'' if D is None else f' at D={D}'}; "
            f"init {t_init:.2f} s; peak memory {peak:.2f} GiB; on {smi}")
        del params, res
        gc.collect()
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 26 --
FAMILY_CPU_ARCHS = ("qwen3-moe-30b-a3b", "arctic-480b", "rwkv6-7b",
                    "zamba2-7b", "whisper-base")


class _RouteRecorder:
    """Records every MoE layer's routing (probabilities, expert ids, the
    dispatch entries and keep masks, on the host) while it runs."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.real, self.seen = moe, moe.route, []

    def __enter__(self):
        def rec(cfg, mp, xt):
            r = self.real(cfg, mp, xt)
            self.seen.append({k: getattr(r, k).cpu() for k in
                              ("probs", "expert", "e_s", "t_s", "keep")})
            return r

        self.moe.route = rec
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real


def _kept(r, E):
    """[G, Tg, E]: the experts each token reaches past the capacity."""
    G, Tg, _ = r["expert"].shape
    m = torch.zeros((G, Tg, E), dtype=torch.bool)
    g = torch.arange(G)[:, None].expand_as(r["e_s"])
    m[g, r["t_s"], r["e_s"]] = r["keep"]
    return m


def _same_routes(tag, card, cpu, tie):
    """(routings, routings equal, tokens whose experts differ, the widest
    of their probability gaps over the token's largest): every MoE
    routing of the card against the CPU's.  With ``tie`` 0 they must be
    equal.  Otherwise a token may take other experts on the two devices
    only where the CPU's probabilities of them tie within ``tie`` of its
    largest, and a token may keep other experts past the capacity only in
    a group where such a tie moved the ranks."""
    if len(card) != len(cpu):
        raise AssertionError(f"{tag}: {len(card)} MoE routings on the card, "
                             f"{len(cpu)} on the CPU")
    equal = flips = 0
    widest = 0.0
    for a, b in zip(card, cpu):
        if torch.equal(a["expert"], b["expert"]) and \
                torch.equal(a["keep"], b["keep"]):
            equal += 1
            continue
        if not tie:
            raise AssertionError(f"{tag}: MoE expert assignments or keep "
                                 "masks differ between the card and the CPU")
        chose = (a["expert"].sort(-1).values !=
                 b["expert"].sort(-1).values).any(-1)
        for g, t in chose.nonzero().tolist():
            p = b["probs"][g, t]
            gap = (p[a["expert"][g, t]].sort().values -
                   p[b["expert"][g, t]].sort().values).abs().max()
            widest = max(widest, float(gap) / float(p.max()))
            if float(gap) > tie * float(p.max()):
                raise AssertionError(f"{tag}: the card routed token {t} of "
                                     f"group {g} to other experts than the "
                                     f"CPU, {float(gap):.3e} apart in its "
                                     "probabilities")
        E = b["probs"].shape[-1]
        moved = (_kept(a, E) != _kept(b, E)).any(-1) & \
            ~chose.any(-1, keepdim=True)
        if bool(moved.any()):
            raise AssertionError(f"{tag}: keep masks differ in a group where "
                                 "no token took other experts")
        flips += int(chose.sum())
    return len(card), equal, flips, widest


def phase_families_card_vs_cpu(dev, requests=6, slots=3, max_new=8,
                               cache_len=48, prompt=(2, 40)):
    """Phase 17 on the reduced configs of qwen3-moe-30b-a3b, arctic-480b,
    rwkv6-7b, zamba2-7b and whisper-base, with the same weights, in float32
    and in bf16 compute: the card's prefill and serve logits against the
    CPU's within ``LM_TOL``, the CPU replaying the card's picks and its own
    greedy picks differing only where its top two logits lie within the
    tolerance; every MoE layer's expert assignments and keep masks equal
    on both devices in float32, and in bf16 compute apart only at ties of
    the probabilities within ``LM_TOL`` (a bf16 rounding of the router's
    input that lands on the other side moves a near-tie: ``_same_routes``);
    K10 launched by the compute dtype's kernels only."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.models import lm
    out = {}
    for arch in FAMILY_CPU_ARCHS:
        for cd in ("float32", "bfloat16"):
            tag = f"reduced {arch} {cd}"
            cfg = dataclasses.replace(get_config(arch).reduced(),
                                      compute_dtype=cd)
            params = lm.init_params(cfg, 0, device=dev)
            cpu_params = lm.init_params(cfg, 0, device="cpu")
            g = torch.Generator().manual_seed(1)
            batch = {"tokens": torch.randint(0, cfg.vocab, prompt,
                                             generator=g)}
            if cfg.family == "audio":
                batch["frames"] = torch.randn(
                    (prompt[0], cfg.enc_frames, cfg.d_model), generator=g)
            build.reset_launches()
            with _RouteRecorder() as card_pre:
                got = lm.prefill(cfg, params, batch, device=dev)
            counts = dict(build.launches())
            with _RouteRecorder() as cpu_pre:
                want = lm.prefill(cfg, cpu_params, batch, device="cpu")
            pre_tol = LM_TOL[cd] * (1.0 if cd == "float32" else
                                    float(want.abs().max()))
            pre_err = float((got.cpu() - want).abs().max())
            if not pre_err <= pre_tol:
                raise AssertionError(f"{tag}: card and CPU prefill logits "
                                     f"differ by {pre_err:.3e} > "
                                     f"{pre_tol:.3e}")
            tie = ROUTE_TIE[cd]
            routes = _same_routes(f"{tag} prefill", card_pre.seen,
                                  cpu_pre.seen, tie)
            seen = []

            def record(logits):
                seen.append(logits.cpu())
                return serve.greedy(logits)

            queue = serve.make_queue(cfg, requests, 0)
            build.reset_launches()
            with _RouteRecorder() as card_routes:
                card = serve.serve_requests(cfg, params, queue, slots,
                                            max_new, cache_len, device=dev,
                                            pick=record)
            for k, v in build.launches().items():
                counts[k] += v
            tol = LM_TOL[cd] * (1.0 if cd == "float32" else
                                max(float(x.abs().max()) for x in seen))
            steps = iter(seen)
            worst, differ = 0.0, 0

            def replay(logits):
                nonlocal worst, differ
                theirs = next(steps)
                worst = max(worst, float((theirs - logits).abs().max()))
                if worst > tol:
                    raise AssertionError(f"{tag}: card and CPU decode logits "
                                         f"differ by {worst:.3e} > "
                                         f"{tol:.3e}")
                pick = serve.greedy(theirs)
                for b in np.flatnonzero(pick != serve.greedy(logits)):
                    top2 = torch.topk(logits[b], 2).values
                    if float(top2[0] - top2[1]) > tol:
                        raise AssertionError(
                            f"{tag}: card picked {pick[b]}, the CPU's top "
                            f"logit leads by {float(top2[0] - top2[1]):.3e}")
                    differ += 1
                return pick

            with _RouteRecorder() as cpu_routes:
                cpu = serve.serve_requests(cfg, cpu_params, queue, slots,
                                           max_new, cache_len, device="cpu",
                                           pick=replay)
            if next(steps, None) is not None or card.done != requests or \
                    card.nonfinite_steps or cpu.nonfinite_steps:
                raise AssertionError(f"{tag}: the card and CPU runs diverged")
            more = _same_routes(f"{tag} serve", card_routes.seen,
                                cpu_routes.seen, tie)
            routes = tuple(a + b for a, b in zip(routes[:3], more[:3])) + \
                (max(routes[3], more[3]),)
            kinds = ("f32_decode", "f32_prefill") if cd == "float32" else \
                ("decode", "prefill")
            k10 = {k: counts[f"flash_attention_{k}"] for k in kinds}
            if sum(k10.values()) != counts["flash_attention"] or \
                    (cfg.family != "ssm") != (counts["flash_attention"] > 0):
                raise AssertionError(f"{tag}: K10 launches {counts}")
            out[f"{arch} {cd}"] = dict(
                prefill_max_abs_err=pre_err, prefill_tol=pre_tol,
                steps=card.decode_steps, max_abs_err=worst, tol=tol,
                picks_differed=differ, picks=len(seen) * slots,
                moe_routings=routes[0], moe_routings_equal=routes[1],
                moe_tie_flips=routes[2], moe_tie_widest=routes[3], k10=k10)
            say("families-vs-cpu", f"{tag}: prefill {prompt[0]} x "
                f"{prompt[1]} logits max abs err {pre_err:.3e} (tol "
                f"{pre_tol:.3e}); {requests} requests, {card.decode_steps} "
                f"decode steps, logits max abs err {worst:.3e} (tol "
                f"{tol:.3e}); CPU greedy picks differed on {differ} of "
                f"{len(seen) * slots}, each within the tolerance of a top-2 "
                f"tie; MoE routings {routes[1]} of {routes[0]} equal on both "
                f"devices, {routes[2]} token(s) routed apart at ties of the "
                f"probabilities (widest {routes[3]:.3e} of the largest, "
                f"tolerance {tie}); K10 launches {k10}")
    return out


# --------------------------------------------------------------- phase 27 --
# K10's backward against its plain version (phase 27): within 1e-5 * (1 +
# |want|) for the order of float32 sums and the exp (both compute in
# float32 from the same inputs), plus, for bf16 inputs, the rounding of the
# two float32 results to bf16 outputs, each within 2**-8 of its value:
# 2**-7 * |want|, as ``ref.bf16_rounding_bound`` counts an output's
# rounding.  Two float32 values that close round at most one bf16 ulp
# apart, and an ulp is at most 2**-7 of the value, so a flip at a power of
# two may use nearly all of the limit.
BWD_CASES = [  # name, B, H, Hkv, Sq, Skv, D, causal
    ("smollm-135m training", 8, 9, 3, 256, 256, 64, True),
    ("4 x 2048", 4, 9, 3, 2048, 2048, 64, True),
    ("D=16 ragged", 4, 4, 2, 300, 300, 16, True),
    ("zamba2-7b D=112", 2, 32, 32, 128, 128, 112, True),
    ("group 8 D=128", 1, 16, 2, 512, 512, 128, True),
    ("whisper encoder", 2, 8, 8, 1500, 1500, 64, False),
    ("whisper cross-attention", 2, 8, 8, 128, 1500, 64, False),
]


def _bwd_inputs(dev, dtype, B, H, Hkv, Sq, Skv, D, causal, seed=0):
    """q, k, v as the model hands them to K10, the forward's float32 o
    and a float32 gradient of o."""
    from repro_torch.kernels.attention import ops as a_ops
    q, k, v = _attn_inputs(dev, dtype, B, H, Hkv, Sq, Skv, D, seed)
    o = a_ops.flash_attention(q, k, v, causal=causal,
                              out_dtype=torch.float32)
    do = torch.randn((B, Sq, H, D), generator=torch.Generator().manual_seed(
        seed + 1)).to(dev).transpose(1, 2)
    return q, k, v, o, do


def _bwd_pairs(Sq, Skv, causal):
    """(query, key) pairs a (batch, head) attends: causal with the
    queries at the end of the timeline, row i sees Skv - Sq + i + 1."""
    return Sq * (Skv - Sq) + Sq * (Sq + 1) // 2 if causal else Sq * Skv


def phase_flash_backward(dev):
    """K10's backward kernels (``csrc/flash_backward.cu``) against their
    plain version on the card, bf16 and float32, at ``BWD_CASES``: within
    the stated tolerance, a second call bitwise the first (no atomics),
    one launch of each kernel a call; and every case's ms per call,
    device ms, bound (the five products S, dP, dv, dq, dk: 10 D FLOPs a
    pair, at bf16's tensor-core or float32's CUDA-core rate), the plain
    version's ms and SDPA's backward (``scaled_dot_product_attention``
    under autograd, a yardstick; its device ms by ``queued_device_ms``),
    and the share of the bound the device ms reach.  Returns the rows by
    (case, dtype)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import ref as a_ref
    from repro_torch.kernels.attention.flash_backward import \
        flash_attention_bwd_cuda
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows, worst = {}, 0.0
    for case in BWD_CASES:
        name, B, H, Hkv, Sq, Skv, D, causal = case
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, o, do = _bwd_inputs(dev, dtype, B, H, Hkv, Sq, Skv, D,
                                         causal)
            build.reset_launches()
            got = flash_attention_bwd_cuda(q, k, v, o, do, causal)
            torch.cuda.synchronize()
            n = build.launches()
            if n["flash_attention_bwd_dq"] != 1 or \
                    n["flash_attention_bwd_dkdv"] != 1:
                raise AssertionError(f"backward {name}: launches {n}")
            want = a_ref.flash_attention_bwd_ref(q, k, v, o, do, causal)
            err = 0.0
            for g, w, part in zip(got, want, ("dq", "dk", "dv")):
                w = w.float()
                lim = ATTN_TOL * (1 + w.abs())
                if dtype == torch.bfloat16:
                    lim += 2 * a_ref.BF16_U * w.abs()
                e = (g.float() - w).abs()
                used = float((e / lim).max())
                worst = max(worst, used)
                err = max(err, float(e.max()))
                if g.dtype != dtype or not bool(torch.isfinite(g).all()) \
                        or used > 1.0:
                    raise AssertionError(
                        f"backward {name} {dtype}: {part} disagrees with the "
                        f"plain version (max abs err {float(e.max()):.3e}, "
                        f"{used:.3f} of the limit)")
            again = flash_attention_bwd_cuda(q, k, v, o, do, causal)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"backward {name} {dtype}: a second "
                                     "call differs")
            say("backward", f"{name} B={B} H={H} Hkv={Hkv} Sq={Sq} Skv={Skv}"
                f" D={D} {'causal' if causal else 'full'} {str(dtype)[6:]}: "
                f"dq, dk, dv max abs err {err:.3e}; bitwise on a second "
                "call")
            pairs = B * H * _bwd_pairs(Sq, Skv, causal)
            size = q.element_size()
            nbytes = 2 * size * (B * H * Sq * D + 2 * B * Hkv * Skv * D) + \
                2 * 4 * B * H * Sq * D
            lq, lk, lv = (x.detach().requires_grad_(True) for x in (q, k, v))
            lo = sdpa(lq, lk, lv, is_causal=causal, enable_gqa=True)
            ldo = do.to(lo.dtype)
            row = kernel_row(
                err, lambda: flash_attention_bwd_cuda(q, k, v, o, do, causal),
                lambda: a_ref.flash_attention_bwd_ref(q, k, v, o, do, causal),
                nbytes, 10 * D * pairs,
                BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS,
                library=lambda: torch.autograd.grad(
                    lo, (lq, lk, lv), ldo, retain_graph=True),
                library_device="queued")
            row["bound_share"] = row["bound_ms"] / row["device_ms"]
            say("backward", f"{name} ({str(dtype)[6:]}): {fmt_row(row)} "
                "(library: "
                "scaled_dot_product_attention's backward); "
                f"{10 * D * pairs / row['device_ms'] / 1e9:.1f} TFLOP/s on "
                f"the device, {row['bound_share']:.4f} of the bound")
            rows[name, str(dtype)[6:]] = row
            del lo, lq, lk, lv
    say("backward", f"{len(BWD_CASES)} cases x bf16 and float32 within "
        f"tolerance, widest {worst:.3f} of the limit")
    return rows


# --------------------------------------------------------------- phase 28 --
TRAIN_STEPS = 30               # phase 28's run: launch/train.py's defaults
TRAIN_KILL = 17                # ... killed here, resumed from step 10


def phase_train(dev, smi):
    """smollm-135m trained at full width and depth on the card by
    ``launch.train`` at its defaults (batch 8, seq 256, lr 3e-4, WSD
    schedule) for ``TRAIN_STEPS`` steps, checkpointed every 10, weights
    drawn on the card: the loss falls; K10's forward (its bf16 prefill
    kernel) and both backward kernels launch once per layer a step (the
    counts zeroed just before the run); then a run killed at step
    ``TRAIN_KILL`` (exit 75) and resumed from its step-10 checkpoint gives
    the uninterrupted run's losses bitwise from step 10 on."""
    from repro_torch.kernels import build
    from repro_torch.launch import train
    ap = train.build_parser()
    with tempfile.TemporaryDirectory() as tmp:
        base = ["--steps", str(TRAIN_STEPS), "--save-every", "10",
                "--device", str(dev)]
        build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        whole = train.train(ap.parse_args(base + ["--ckpt-dir",
                                                  f"{tmp}/whole"]))
        wall = time.perf_counter() - t0
        counts = build.launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        args = ap.parse_args(base)
        from repro_torch.configs import get_config
        L = get_config(args.arch).n_layers
        want = L * TRAIN_STEPS
        losses = [h["loss"] for h in whole.history]
        if whole.rc != 0 or len(losses) != TRAIN_STEPS or \
                not all(np.isfinite(losses)) or \
                not np.mean(losses[-5:]) < np.mean(losses[:5]):
            raise AssertionError(f"training: rc {whole.rc}, losses {losses}")
        if {counts[k] for k in ("flash_attention", "flash_attention_prefill",
                                "flash_attention_bwd_dq",
                                "flash_attention_bwd_dkdv")} != {want}:
            raise AssertionError(f"training: K10 launches {counts}, not "
                                 f"{L} layers x {TRAIN_STEPS} steps")
        # steps 0 and 1 build and warm up; the rest is the steady state
        ms = statistics.median(h["time_s"] for h in whole.history[2:]) * 1e3
        tokens = args.batch * args.seq
        stats = dict(arch=args.arch, steps=TRAIN_STEPS, batch=args.batch,
                     seq=args.seq, lr=args.lr, n_params=whole.n_params,
                     first_loss=losses[0], last_loss=losses[-1],
                     ms_per_step=ms, tok_per_s=tokens / ms * 1e3,
                     wall_s=wall, peak_gib=peak, k10_forward=want,
                     k10_backward=want, gpu=smi)
        say("train", f"{args.arch} ({whole.n_params} params) at launch/"
            f"train.py's defaults: batch {args.batch} x seq {args.seq}, lr "
            f"{args.lr}, {TRAIN_STEPS} steps, save every 10: loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}; {ms:.2f} ms a step "
            f"(median of steps 2-{TRAIN_STEPS - 1}, host clock around the "
            f"step and the loss's sync), {stats['tok_per_s']:.0f} tok/s; run "
            f"{wall:.1f} s with checkpoints; peak memory {peak:.2f} GiB; K10 "
            f"forward (prefill kernel) and backward (dq, dkdv) {want} "
            f"launches each = {L} layers x {TRAIN_STEPS}; on {smi}")
        killed = train.train(ap.parse_args(base + [
            "--ckpt-dir", f"{tmp}/killed", "--inject-failure-at",
            str(TRAIN_KILL)]))
        resumed = train.train(ap.parse_args(base + ["--ckpt-dir",
                                                    f"{tmp}/killed"]))
        got = [h["loss"] for h in resumed.history]
        if killed.rc != 75 or resumed.rc != 0 or resumed.start != 10 or \
                got != losses[10:]:
            raise AssertionError(
                f"kill/resume: rc {killed.rc}, {resumed.rc}, start "
                f"{resumed.start}; losses {got} against {losses[10:]}")
        say("train", f"killed at step {TRAIN_KILL} (exit 75), resumed from "
            f"step {resumed.start}: losses of steps 10-{TRAIN_STEPS - 1} "
            "bitwise the uninterrupted run's")
    return {"flash_attention_bwd": want}, stats


# --------------------------------------------------------------- phase 29 --
TRAIN_CPU_ARCHS = ("smollm-135m", "internvl2-1b", "qwen3-moe-30b-a3b",
                   "rwkv6-7b", "zamba2-7b", "whisper-base")
# Card against CPU (phase 29): (loss, gradient) tolerances -- losses and
# grad norms relative, each leaf's gradient of its largest magnitude.
# Float32: the card and the CPU differ in last bits (exp, the order of
# float32 sums in cuBLAS, K10 and its backward against the plain
# versions).  ``scripts/train_sensitivity.py`` measures how far such bits
# move three steps on the CPU (every parameter scaled by 1 + 2**-24 n):
# up to 3e-7 in the loss and grad norm and 2.6e-5 of a leaf's gradient
# for the attention families (whisper-base's cross-attention), but 1e-4
# and 1.1e-3 for the recurrent ones (rwkv6-7b, zamba2-7b: 64-step host
# time loops through exp(-exp(.)) decays); each tolerance is about ten
# times that.  bf16 compute: one bf16 rounding of an activation that lands
# on the other side moves it by 2**-8 of itself, as phase 17's LM_TOL
# says.  The parameters after AdamW steps: within 1e-5 (1 + |p|) plus,
# per step, lr * min(2, 2 tau / |g|) -- a gradient entry within the
# tolerance tau of zero may take the other sign and move its parameter
# 2 lr apart.
TRAIN_TOL = {"float32": (1e-5, 3e-4), "float32 recurrent": (1e-3, 1e-2),
             "bfloat16": (2.0 ** -8, 2.0 ** -5)}
WHISPER_TRAIN = (2, 128)       # phase 29's full-width whisper: batch x seq


def _grads(lm, cfg, params, batch, dev):
    """The gradient leaves of ``lm.loss_and_grad``, in tree order."""
    from torch.utils._pytree import tree_flatten
    return tree_flatten(lm.loss_and_grad(cfg, params, batch,
                                         device=dev)[1])[0]


def phase_train_card_vs_cpu(dev, smi, steps=3, lr=1e-3):
    """whisper-base at full width (6 + 6 layers, 1500 frames, bf16) for
    three steps on one batch: finite, falling losses, K10's forward and
    backward once per attention call.  Then every family's reduced config
    (dense, vlm, moe, ssm, hybrid, audio; float32) and the dense one in
    bf16 compute: ``steps`` ``train_step``s from the same state and
    batches on the card and on the CPU, the gradients, losses, grad norms
    and parameters within ``TRAIN_TOL``."""
    import dataclasses

    from torch.utils._pytree import tree_flatten

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch
    from repro_torch.kernels import build
    from repro_torch.models import lm
    cfg = get_config("whisper-base")
    B, S = WHISPER_TRAIN
    params, opt = lm.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = make_batch(cfg, ShapeConfig("t", S, B, "train"), 0, 0,
                       device=dev)
    build.reset_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt, m = lm.train_step(cfg, params, opt, batch, lr,
                                       device=dev)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    counts = build.launches()
    calls = steps * (cfg.enc_layers + 2 * cfg.n_layers)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or \
            counts["flash_attention"] != calls or \
            counts["flash_attention_bwd_dq"] != calls or \
            counts["flash_attention_bwd_dkdv"] != calls:
        raise AssertionError(f"whisper-base training: losses {losses}, "
                             f"launches {counts}")
    out = {"whisper-base": dict(batch=B, seq=S, frames=cfg.enc_frames,
                                losses=losses, ms_per_step=times[-1] * 1e3)}
    say("train-vs-cpu", f"whisper-base full width (6 + 6 layers, d "
        f"{cfg.d_model}, {cfg.enc_frames} frames), batch {B} x {S}, lr {lr}"
        f", {steps} steps on one batch: loss "
        f"{' -> '.join(f'{x:.4f}' for x in losses)}; {times[-1] * 1e3:.1f} "
        f"ms the last step; K10 forward and backward {calls} launches each "
        f"(encoder self, decoder self and cross per layer)")
    del params, opt
    torch.cuda.empty_cache()
    runs = [(a, "float32") for a in TRAIN_CPU_ARCHS] + \
        [("smollm-135m", "bfloat16")]
    for arch, cd in runs:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  compute_dtype=cd)
        loss_tol, grad_tol = TRAIN_TOL[
            "float32 recurrent" if cd == "float32" and
            cfg.family in ("ssm", "hybrid") else cd]
        cpu, copt = lm.init_train_state(cfg, 0, device="cpu")
        card, gopt = lm.init_train_state(cfg, 0, device=dev)
        allow, widest, gwide = None, 0.0, 0.0
        build.reset_launches()
        for step in range(steps):
            batch = make_batch(cfg, ShapeConfig("t", 64, 4, "train"), 0,
                               step, device="cpu")
            gc = _grads(lm, cfg, cpu, batch, "cpu")
            gg = _grads(lm, cfg, card, batch, dev)
            for a, b in zip(gg, gc):
                e = float((a.cpu() - b).abs().max()) / \
                    max(float(b.abs().max()), 1e-30)
                gwide = max(gwide, e)
                if e > grad_tol:
                    raise AssertionError(f"{arch} {cd}: card and CPU "
                                         f"gradients {e:.3e} apart")
            add = [lr * torch.clamp(2 * grad_tol * g.abs().max() /
                                    g.abs().clamp_min(1e-30), max=2.0)
                   for g in gc]
            allow = add if allow is None else \
                [a + b for a, b in zip(allow, add)]
            cpu, copt, mc = lm.train_step(cfg, cpu, copt, batch, lr,
                                          device="cpu")
            card, gopt, mg = lm.train_step(cfg, card, gopt, batch, lr,
                                           device=dev)
            for key in ("loss", "grad_norm"):
                e = abs(float(mg[key]) - float(mc[key])) / \
                    abs(float(mc[key]))
                widest = max(widest, e)
                if not e <= loss_tol:
                    raise AssertionError(f"{arch} {cd} step {step}: card "
                                         f"and CPU {key} {e:.3e} apart")
            for a, b, al in zip(tree_flatten(card)[0], tree_flatten(cpu)[0],
                                allow):
                if not bool(((a.cpu() - b).abs() <=
                             1e-5 * (1 + b.abs()) + al).all()):
                    raise AssertionError(f"{arch} {cd}: card and CPU "
                                         f"parameters apart after step "
                                         f"{step}")
        counts = build.launches()
        attn = counts["flash_attention_bwd_dq"]
        if (cfg.family != "ssm") != (attn > 0) or \
                attn != counts["flash_attention_bwd_dkdv"]:
            raise AssertionError(f"{arch} {cd}: backward launches {counts}")
        out[f"{arch} {cd}"] = dict(loss=float(mc["loss"]),
                                   widest_loss_rel=widest,
                                   widest_grad_rel=gwide, bwd_launches=attn)
        say("train-vs-cpu", f"reduced {arch} {cd}: {steps} train steps, "
            f"losses and grad norms within {widest:.3e} relative (tol "
            f"{loss_tol:.3e}), gradients within {gwide:.3e} of each leaf's "
            f"largest (tol {grad_tol:.3e}), parameters within the AdamW "
            f"allowance; K10 backward {attn} launches of each kernel")
    return out


# --------------------------------------------------------------- phase 30 --
def phase_global_round(dev, t_end, spmd, sparse_res, smi):
    """The paper-faithful global round (``build_fap_round(optimized=False)``)
    at full width, four ranks on the card, ``queue="dense"``, counts zeroed
    just before; held to phase 12's sparse run."""
    from repro_torch.distributed.group import launch
    t0 = time.perf_counter()
    runs = launch(RANKS, _spmd_rank, N_MAIN, t_end,
                  {"global": dict(optimized=False, parcel_cap=PARCEL_CAP)},
                  backend="gloo", device=dev)
    r = runs["global"]
    res, rounds = r["res"], r["rounds"]
    spikes = int(res.rec.count.sum())
    per = {k: {"bytes_per_round": v["bytes"] / rounds,
               "ms_per_round": v["seconds"] / rounds * 1e3,
               "calls": v["calls"]}
           for k, v in res.comm["channels"].items()}
    sp = spmd["sparse"]
    ms_round = r["wall_s"] / max(rounds, 1) * 1e3
    sp_round = sp["wall_s"] / max(sp["rounds"], 1) * 1e3
    say("global", f"{RANKS} ranks on {dev} over gloo, N={N_MAIN} C=13 "
        f"k_in={K_IN} t_end={t_end} ms, build_fap_round(optimized=False), "
        f"queue=dense: rounds {rounds}, n_steps {int(res.n_steps)}, "
        f"n_events {int(res.n_events)}, n_resets {int(res.n_resets)}, "
        f"spikes {spikes}, dropped {int(res.dropped)}, failed "
        f"{bool(res.failed)}; wall {r['wall_s']:.2f} s, {ms_round:.1f} ms "
        f"per round beside phase 12's sparse {sp_round:.1f} on {smi} "
        f"(spawn, build and run {time.perf_counter() - t0:.1f} s)")
    def by_tag(channels, key, nd=None):
        return json.dumps({k: v[key] if nd is None else round(v[key], nd)
                           for k, v in channels.items()})

    say("global", f"bytes per round on rank 0: "
        f"{by_tag(per, 'bytes_per_round')}; phase 12's sparse "
        f"{by_tag(sp['channels'], 'bytes_per_round')}")
    say("global", f"host wall inside the collectives, ms per round on rank "
        f"0: {by_tag(per, 'ms_per_round', 3)}; phase 12's sparse "
        f"{by_tag(sp['channels'], 'ms_per_round', 3)}")
    say("global", f"launches per rank {json.dumps(r['launches'])}")
    _gate_run("global", res)
    if rounds >= 400:
        raise AssertionError("global: did not reach t_end")
    ref = sparse_res
    fin = torch.isfinite(ref.rec.times)
    dts = float((res.rec.times[fin] - ref.rec.times[fin]).abs().max()) \
        if bool(fin.any()) else 0.0
    same = dict(counts=torch.equal(res.rec.count, ref.rec.count),
                finite=torch.equal(torch.isfinite(res.rec.times), fin),
                n_events=int(res.n_events) == int(ref.n_events),
                n_steps=int(res.n_steps) == int(ref.n_steps),
                n_resets=int(res.n_resets) == int(ref.n_resets),
                rounds=rounds == sp["rounds"])
    bitwise = _same_spmd(res, ref)
    say("global", f"global vs phase 12's sparse: {json.dumps(same)}; spike "
        f"times within {dts:.2e} ms; bitwise equal (times, final states): "
        f"{bitwise}")
    if not all(same.values()) or dts > 1e-9:
        raise AssertionError("global: differs from phase 12's sparse run")
    missing = [k for k in GLOBAL_PATH if min(r["launches"][k]) <= 0]
    if missing:
        raise AssertionError(f"global: some rank never launched {missing}")
    return dict(rounds=rounds, wall_s=r["wall_s"], ms_per_round=ms_round,
                sparse_ms_per_round=sp_round, spikes=spikes,
                n_steps=int(res.n_steps), channels=per, bitwise=bitwise,
                launches=r["launches"])


# --------------------------------------------------------------- phase 31 --
def _compact_tenants(m, s_cap):
    """The rows of a [T, N] spike mask whose tenant takes the compact
    fan-out (1..``s_cap`` spikes), as ``exec_common.make_spike_insert``'s
    rows form decides from K7's counts."""
    c = m.sum(dim=1)
    return (c > 0) & (c <= s_cap)


def _rows_kernel_rows(dev, sel, spk, used, cap, s_cap):
    """The rows forms against their plain versions, bitwise, on the
    service path's busiest masks, on its mask with the most spikes in
    compact-fan-out tenants (``used``) and on masks of densities 0-100 %;
    their ``kernels`` rows at the path's masks: K6's at the busiest
    selection, beside ``torch.nonzero``; K7's at ``used``, where its
    output feeds the compact batch insert, with a row at the busiest
    mask (every tenant past the cap) printed beside it."""
    from repro_torch.core.exec_common import out_edge_table
    from repro_torch.core.network import make_network
    from repro_torch.kernels.event_wheel import ops as ew_ops
    from repro_torch.kernels.event_wheel import ref as ew_ref
    T, N = sel.shape
    net = make_network(N, k_in=K_IN, seed=NET_SEED)
    table = torch.as_tensor(out_edge_table(net), device=dev).contiguous()
    E, MO = int(net.pre.shape[0]), int(table.shape[1])
    gen = np.random.default_rng(31)
    masks = [("path", sel, spk), ("path-compact", sel, used)] + [
        (f"{d:.0%}", m, m) for d in (0.0, 0.01, 0.5, 1.0)
        for m in [torch.from_numpy(gen.random((T, N)) < d).to(dev)]]
    for name, mi, mg in masks:
        for g, w in zip(ew_ops.compact_ids_rows(mi, cap),
                        ew_ref.compact_ids_rows_ref(mi, cap)):
            if not torch.equal(g, w):
                raise AssertionError(f"compact_ids_rows mask={name}: kernel "
                                     f"differs from its plain version")
        for g, w in zip(ew_ops.compact_gather_rows(mg, table, s_cap, fill=E),
                        ew_ref.compact_gather_rows_ref(mg, table, s_cap, E)):
            if not torch.equal(g, w):
                raise AssertionError(f"compact_gather_rows mask={name}: "
                                     f"kernel differs from its plain version")
    rows = {}
    rows["compact_ids_rows"] = kernel_row(
        0.0, lambda: ew_ops.compact_ids_rows(sel, cap),
        lambda: ew_ref.compact_ids_rows_ref(sel, cap),
        T * N + 4 * T * cap + 4 * T, T * N, INT32_OPS,
        library=lambda: torch.nonzero(sel),
        library_device=profiled_device_ms)

    def gather_row(m):
        kept = int(torch.clamp(m.sum(dim=1), max=s_cap).sum())
        return kept, kernel_row(
            0.0, lambda: ew_ops.compact_gather_rows(m, table, s_cap, fill=E),
            lambda: ew_ref.compact_gather_rows_ref(m, table, s_cap, E),
            T * N + 4 * kept * MO + 4 * T * s_cap * (MO + 1) + 4 * T,
            T * N + kept * MO, INT32_OPS)

    kept, rows["compact_gather_rows"] = gather_row(used)
    busy_kept, busy = gather_row(spk)
    say("compact-service", f"compact_ids_rows T={T} N={N} cap={cap} (path "
        f"mask: {int(sel.sum())} set): bitwise, also at densities 0-100 %; "
        f"{fmt_row(rows['compact_ids_rows'])} (library: torch.nonzero)")
    per = used.sum(dim=1).tolist()
    say("compact-service", f"compact_gather_rows T={T} N={N} MO={MO} "
        f"spike_cap={s_cap} fill=E={E}, bitwise on the path's masks and at "
        f"densities 0-100 %; at the path mask with the most compact-fan-out "
        f"spikes (spikes per tenant {per}, {kept} kept): "
        f"{fmt_row(rows['compact_gather_rows'])}; at the busiest path mask "
        f"({int(spk.sum())} spikes, {busy_kept} kept, every tenant past the "
        f"cap): {fmt_row(busy)}")
    return rows, busy


def phase_compact_service(dev, dense, spike_cap, smi, lanes=4, tenants=8,
                          t_end=None):
    """``SimService`` at full width over the active-set runner: phase 23's
    lanes, tenants, currents, QoS classes and poisoned tenant, with
    ``batch="compact", batch_cap=N/4, fanout="compact"`` at phase 4's spike
    cap, ``queue="wheel"`` and the fused horizon; counts zeroed just
    before the batched service."""
    from repro_torch.checkpoint import FaultPlan
    from repro_torch.kernels import build
    from repro_torch.serve import TenantRequest
    t_end = dense["t_end"] if t_end is None else t_end
    cap = N_MAIN // 4
    run = _sim_runner(dev, N_MAIN, t_end, batch="compact", batch_cap=cap,
                      fanout="compact", spike_cap=spike_cap, queue="wheel")
    cur, qos = _service_currents(tenants)
    reqs = [TenantRequest(rid=r, iinj=cur[r], qos=qos[r])
            for r in range(tenants)]
    caps = {0: N_MAIN // 4}
    poisoned, clean = 1, 0
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Recorder("compact_ids_rows", "compact_gather_rows") as seen:
        res = _service(run, t_end, lanes, reqs, qos_caps=caps,
                       fault=FaultPlan(poison_tenant=poisoned,
                                       poison_at_round=4))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = build.launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    t1 = time.perf_counter()
    solo = {rid: _service(run, t_end, 1, [reqs[rid]], qos_caps=caps)
            for rid in (poisoned, clean)}
    solo_wall = time.perf_counter() - t1
    spikes = {rid: int(r.count.sum()) for rid, r in res.results.items()
              if r.status == "completed"}
    same = {rid: np.array_equal(res.results[rid].times,
                                solo[rid].results[rid].times)
            and np.array_equal(res.results[rid].count,
                               solo[rid].results[rid].count)
            for rid in solo}
    per_round = wall / max(res.rounds, 1) * 1e3
    w = res.health["admission_wait_rounds"]
    say("compact-service", f"SimService {lanes} lanes x N={N_MAIN} C=13, "
        f"{tenants} tenants t_end={t_end} ms (phase 23's currents, QoS and "
        f"poisoned rid {poisoned}), batch=compact batch_cap={cap}, "
        f"fanout=compact spike_cap={spike_cap}, queue=wheel, fused "
        f"horizon: {res.completed} completed, {res.evicted} evicted, "
        f"{res.rejected} rejected, {res.quarantines} quarantines, "
        f"{res.retried} retries (rid {poisoned}: "
        f"{res.results[poisoned].retries}); spikes {json.dumps(spikes)}")
    say("compact-service", f"{res.rounds} service rounds in {wall:.2f} s, "
        f"{per_round:.1f} ms per service round, "
        f"{tenants * t_end / wall:.3f} tenant-ms per wall second; beside "
        f"phase 23's dense service: {dense['rounds']} rounds, "
        f"{dense['ms_per_round']:.1f} ms per round, "
        f"{dense['tenant_ms_per_s']:.3f} tenant-ms per wall second; "
        f"admission wait mean {w['mean']:.1f} max {w['max']} rounds; peak "
        f"memory {peak:.2f} GiB on {smi}; launches {json.dumps(launches)}")
    say("compact-service", f"solo 1-lane services of rid {poisoned} "
        f"(poisoned in the batch) and rid {clean}: bitwise equal to the "
        f"batch: {json.dumps({str(k): v for k, v in same.items()})} "
        f"({solo_wall:.2f} s)")
    if res.completed != tenants or res.quarantines < 1 \
            or res.results[poisoned].retries < 1:
        raise AssertionError(f"compact service: {res.completed} of "
                             f"{tenants} completed, {res.quarantines} "
                             f"quarantines")
    if not all(same.values()):
        raise AssertionError("compact service: a tenant differs from its "
                             "solo run")
    if min(spikes.values()) <= 0:
        raise AssertionError(f"compact service: a tenant without spikes "
                             f"{spikes}")
    missing = [k for k in COMPACT_SERVICE_PATH if launches[k] <= 0]
    if missing:
        raise AssertionError(f"compact service path never launched "
                             f"{missing}")
    # each spiking round's fan-out branch per tenant, from the masks K7's
    # rows form was given: compact batch (1..spike_cap spikes) or the
    # dense insert of the tenant's own rows (more)
    s_cap = min(spike_cap, N_MAIN)
    spk_masks = seen.seen["compact_gather_rows"]
    small = [_compact_tenants(m, s_cap) for m in spk_masks]
    n_compact = sum(int(b.sum()) for b in small)
    n_dense = sum(int((m.sum(dim=1) > s_cap).sum()) for m in spk_masks)
    r_compact = sum(int(b.any()) for b in small)
    say("compact-service", f"fan-out per tenant over the {len(spk_masks)} "
        f"spiking rounds: {n_compact} compact batches (in {r_compact} "
        f"rounds; {launches['segment_rank']} K8 launches, the wheel's batch "
        f"insert), {n_dense} dense inserts")
    if n_compact <= 0:
        raise AssertionError("compact service: no tenant took the compact "
                             "fan-out")
    sel = _Recorder.busiest(seen.seen["compact_ids_rows"], lambda m: m)
    spk = _Recorder.busiest(spk_masks, lambda m: m)
    used = _Recorder.busiest(
        spk_masks, lambda m: m & _compact_tenants(m, s_cap)[:, None])
    rows, busy = _rows_kernel_rows(dev, sel, spk, used, cap, s_cap)
    out = dict(lanes=lanes, tenants=tenants, t_end=t_end, batch_cap=cap,
               spike_cap=spike_cap, rounds=res.rounds, wall_s=wall,
               ms_per_round=per_round, tenant_ms_per_s=tenants * t_end / wall,
               peak_gib=peak, quarantines=res.quarantines,
               retried=res.retried, spikes=spikes, solo_identical=same,
               solo_wall_s=solo_wall, launches=launches,
               fanout_compact_tenants=n_compact,
               fanout_compact_rounds=r_compact, fanout_dense_tenants=n_dense,
               compact_gather_rows_busiest=busy)
    return out, rows, launches


def phase_profile(dev, n_rounds, t_end, skip=54, path="dense", **knobs):
    """Where a full-width round's time goes: ``torch.profiler`` over
    ``n_rounds`` rounds of a path after ``skip`` unprofiled ones (the
    spiking part of the run): wall time, summed device time, device busy
    share, launches and the busiest device kernels."""
    from torch.profiler import ProfilerActivity, profile
    run = _runner(dev, N_MAIN, t_end, **knobs)
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
    say("profile", f"{path} path, rounds {skip}..{skip + n_rounds - 1}: wall "
        f"{wall_us / n_rounds / 1e3:.1f} ms per round (profiled), device "
        f"{dev_us / n_rounds / 1e3:.2f} ms per round, busy share "
        f"{dev_us / wall_us:.3f}, {launches / n_rounds:.0f} device ops per "
        f"round")
    ours = [e for e in ev if any(k in e.key for k in OUR_KERNELS)]
    ours_us = sum(e.self_device_time_total for e in ours)
    say("profile", f"{path} path: the ported kernels "
        f"{ours_us / n_rounds / 1e3:.3f} ms per round, "
        f"{ours_us / max(dev_us, 1e-9):.3f} of device time, "
        f"{sum(e.count for e in ours) / n_rounds:.0f} launches per round")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
        say("profile", f"  {e.key[:60]:60s} {e.count / n_rounds:8.0f}/round "
            f"{e.self_device_time_total / n_rounds / 1e3:8.3f} ms/round")


def phase_profile_train(dev, n_steps, warm=3):
    """Where a full-width training step's time goes: ``torch.profiler``
    over ``n_steps`` of ``lm.train_step`` on smollm-135m at
    ``launch/train.py``'s batch and sequence, after ``warm`` unprofiled
    steps."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch
    from repro_torch.models import lm
    cfg = get_config(LM_ARCH)
    params, opt = lm.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = make_batch(cfg, ShapeConfig("t", 256, 8, "train"), 0, 0,
                       device=dev)
    for _ in range(warm):
        params, opt, m = lm.train_step(cfg, params, opt, batch, 3e-4,
                                       device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            params, opt, m = lm.train_step(cfg, params, opt, batch, 3e-4,
                                           device=dev)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    timed = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    ev = [e for e in timed if str(e.device_type).endswith("CUDA")] or timed
    dev_us = sum(e.self_device_time_total for e in ev)
    say("profile", f"{cfg.name} training steps (batch 8 x 256): wall "
        f"{wall_us / n_steps / 1e3:.2f} ms per step (profiled), device "
        f"{dev_us / n_steps / 1e3:.3f} ms per step, busy share "
        f"{dev_us / wall_us:.3f}, "
        f"{sum(e.count for e in ev) / n_steps:.0f} device ops per step")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:10]:
        say("profile", f"  {e.key[:60]:60s} {e.count / n_steps:8.0f}/step "
            f"{e.self_device_time_total / n_steps / 1e3:8.3f} ms/step")
    del params, opt
    torch.cuda.empty_cache()


def phase_profile_serve(dev, n_steps, t_pos=128, arch=LM_ARCH):
    """Where a full-width decode step's time goes: ``torch.profiler`` over
    ``n_steps`` decode steps of ``arch`` (smollm-135m, or a phase-25
    family at its phase-25 depth) at the serve CLI's batch and cache,
    from ``t_pos`` on."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm
    cfg = _family_cfg(arch)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    state = lm.make_decode_state(cfg, 4, 256, device=dev)
    tok = torch.zeros((4, 1), dtype=torch.int64, device=dev)
    for t in range(t_pos):
        _, state = lm.decode_step(cfg, params, tok, state, t, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(t_pos, t_pos + n_steps):
            _, state = lm.decode_step(cfg, params, tok, state, t, device=dev)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    timed = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    ev = [e for e in timed if str(e.device_type).endswith("CUDA")] or timed
    dev_us = sum(e.self_device_time_total for e in ev)
    say("profile", f"{arch} decode steps {t_pos}..{t_pos + n_steps - 1}: "
        f"wall {wall_us / n_steps / 1e3:.2f} ms per step (profiled), device "
        f"{dev_us / n_steps / 1e3:.3f} ms per step, busy share "
        f"{dev_us / wall_us:.3f}, "
        f"{sum(e.count for e in ev) / n_steps:.0f} device ops per step")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
        say("profile", f"  {e.key[:60]:60s} {e.count / n_steps:8.0f}/step "
            f"{e.self_device_time_total / n_steps / 1e3:8.3f} ms/step")
    del params, state
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 32 --
DRYRUN_TRAIN = (8, 256)        # phase 28's training shape: batch x seq
DRYRUN_DECODE = (4, 256)       # phase 16's decode shape: slots x cache
# The card's peak over one training step against the dry run's
# ``peak_bytes_one_device`` (its storages on ``meta``: arguments, the
# step's activations, gradients and the new parameters and moments); the
# caching allocator rounds every block up to 512 bytes and holds cuBLAS's
# workspace besides.  Set from the first card run, which measured 1.0489
# ("NVIDIA H100 80GB HBM3, 700.00 W"): the allocator's rounding is
# deterministic, so the bound leaves about 5 % on either side of it.
MEM_RATIO = (1.0, 1.10)
F32_RATE, BF16_RATE = 67e12, 989e12     # dense peaks of the H100 SXM


def phase_dryrun(dev, smi):
    """The dry run of smollm-135m on ``meta`` at phase 28's training
    shape and phase 16's decode shape, on the card's mesh, against one
    real training step and one decode step on the card."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataPipeline
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    cfg = get_config(LM_ARCH)
    L = cfg.n_layers
    mesh = make_local_mesh()
    if mesh.sizes != (1, 1):
        raise AssertionError(f"the card's mesh is {mesh}, not (1, 1)")
    shapes = {"train": ShapeConfig("phase28", DRYRUN_TRAIN[1],
                                   DRYRUN_TRAIN[0], "train"),
              "decode": ShapeConfig("phase16", DRYRUN_DECODE[1],
                                    DRYRUN_DECODE[0], "decode")}
    t0 = time.perf_counter()
    recs = {k: dryrun.count_cell(cfg, s, mesh, skip_delta=True)
            for k, s in shapes.items()}
    dry_s = time.perf_counter() - t0
    for k, rec in recs.items():
        if rec["collective_bytes_per_device"] or \
                any(rec["collective_terms"].values()):
            raise AssertionError(f"dry run {k} on (1, 1): collectives "
                                 f"{rec['collective_terms']}")
    # the same training step on the card: phase 28's model and data
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(cfg, gen, device=dev)
    opt = adamw_init(params)
    batch = DataPipeline(cfg, shapes["train"], seed=0,
                         device=dev).next_batch()

    def step():
        return lm.train_step(cfg, params, opt, batch, dryrun.LR, remat=True,
                             device=dev)

    step()                                       # warm-up, discarded
    torch.cuda.synchronize()
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    _, _, metrics = step()
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    times = [time.perf_counter() - t1]
    peak = torch.cuda.max_memory_allocated()
    counts = build.launches()
    del metrics
    for _ in range(2):
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    ms = statistics.median(times) * 1e3
    want = {"flash_attention_prefill": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkdv": L}
    if not np.isfinite(loss) or \
            any(counts.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"phase 32's training step: loss {loss}, K10 "
                             f"launches {counts}, want {want}")
    pred = recs["train"]["peak_bytes_one_device"]
    ratio = peak / pred
    if not MEM_RATIO[0] <= ratio <= MEM_RATIO[1]:
        raise AssertionError(f"training step peak {peak} B against the dry "
                             f"run's {pred} B: ratio {ratio:.4f} outside "
                             f"{MEM_RATIO}")
    flops = recs["train"]["counted_flops"]
    bound = {"float32": flops / F32_RATE * 1e3,
             "bfloat16": flops / BF16_RATE * 1e3}
    # one decode step at phase 16's shape
    B, S = DRYRUN_DECODE
    state = lm.make_decode_state(cfg, B, S, device=dev)
    token = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    del batch, opt                    # the decode step holds params only
    torch.cuda.synchronize()
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    logits, _ = lm.decode_step(cfg, params, token, state, S - 1, device=dev)
    torch.cuda.synchronize()
    dec_peak = torch.cuda.max_memory_allocated()
    dec_counts = build.launches()
    if dec_counts.get("flash_attention_decode", 0) != L or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"phase 32's decode step: K10 launches "
                             f"{dec_counts}, want {L} decode")
    dec_pred = recs["decode"]["peak_bytes_one_device"]
    stats = dict(
        arch=cfg.name, train_shape=DRYRUN_TRAIN, decode_shape=DRYRUN_DECODE,
        dryrun_seconds=dry_s, model_flops=recs["train"]["model_flops"],
        counted_flops=flops,
        attention_flops=recs["train"]["attention_flops"],
        argument_bytes=recs["train"]["argument_bytes"],
        predicted_peak_bytes=pred, measured_peak_bytes=peak,
        peak_ratio=ratio, mem_ratio_bound=MEM_RATIO, ms_per_step=ms,
        step_ms=[t * 1e3 for t in times], bound_ms=bound,
        share_of_bound={k: v / ms for k, v in bound.items()},
        decode_predicted_peak_bytes=dec_pred,
        decode_measured_peak_bytes=dec_peak,
        decode_peak_ratio=dec_peak / dec_pred,
        decode_counted_flops=recs["decode"]["counted_flops"],
        launches={k: counts.get(k, 0) for k in want}, gpu=smi)
    say("dryrun", f"{cfg.name} on meta in {dry_s:.1f} s, mesh (1, 1): "
        f"collectives 0 in the train ({DRYRUN_TRAIN[0]} x {DRYRUN_TRAIN[1]})"
        f" and decode ({B} x {S}) cells; counted {flops} FLOP a training "
        f"step (model 6ND {recs['train']['model_flops']:.6g}, K10 "
        f"{recs['train']['attention_flops']}), arguments "
        f"{recs['train']['argument_bytes']}")
    say("dryrun", f"training step on the card: peak {peak} B measured "
        f"against {pred} B predicted, ratio {ratio:.4f} (bound {MEM_RATIO});"
        f" decode step {dec_peak} B against {dec_pred} B, ratio "
        f"{dec_peak / dec_pred:.4f} (not gated); K10 launches {stats['launches']}")
    say("dryrun", f"step {ms:.2f} ms (median of 3 after a warm-up, host "
        f"clock to a sync); bound {bound['float32']:.3f} ms at 67 TFLOP/s "
        f"float32 (share {bound['float32'] / ms:.4f}), "
        f"{bound['bfloat16']:.4f} ms at 989 TFLOP/s bf16 (share "
        f"{bound['bfloat16'] / ms:.5f}); on {smi}")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--t-end", type=float, default=5.0,
                    help="simulated ms of the full-width phases 3, 4, 9, "
                    "18 and 22")
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
    walls = {}

    def timed(label, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        walls[label] = time.perf_counter() - t0
        say("wall", f"phase {label}: {walls[label]:.1f} s")
        return out

    smi = timed("1 setup", phase_setup)
    rows = timed("2 kernels", phase_kernels, dev)
    launches, main_stats = timed("3 main", phase_main, dev, args.t_end)
    act_launches, act = timed("4 active", phase_active, dev, args.t_end,
                              main_stats)
    rows.update(timed("5 sched-kernels", phase_sched_kernels, dev, act))
    timed("6 card-vs-cpu", phase_card_vs_cpu, dev)
    timed("7 active-card-vs-cpu", phase_active_card_vs_cpu, dev)
    rows.update(timed("8 fused-solve", phase_fused_solve, dev))
    base_launches, base = timed("9 baseline", phase_baseline, dev,
                                args.t_end, main_stats)
    others = timed("10 other-baselines", phase_other_baselines, dev)
    timed("11 baselines-card-vs-cpu", phase_baselines_card_vs_cpu, dev)
    spmd, path_mask, launches["compact_rows"], sparse_res = timed(
        "12 spmd", phase_spmd, dev, SPMD_T_END, main_stats)
    rows.update(timed("13 parcel-kernel", phase_parcel_kernel, dev,
                      path_mask))
    timed("14 spmd-small", phase_spmd_small, dev)
    glob = timed("30 global", phase_global_round, dev, SPMD_T_END, spmd,
                 sparse_res, smi)
    attn_rows = timed("15 attention", phase_attention, dev)
    rows.update(attn_rows)
    serve_launches, lm_stats = timed("16 serve", phase_serve, dev, smi)
    launches.update(serve_launches)
    lm_vs_cpu = timed("17 lm-card-vs-cpu", phase_lm_card_vs_cpu, dev)
    f32 = lm_vs_cpu["float32"]
    launches["flash_attention_f32_decode"] = f32["launches"]
    launches["flash_attention_f32_prefill"] = f32["prefill_launches"]
    rows["flash_attention_f32_decode"] = f32.pop("row")
    rows["flash_attention_f32_prefill"] = f32.pop("prefill_row")
    plastic = timed("18 plastic-schur", phase_plastic_schur, dev, args.t_end,
                    main_stats, smi)
    spec = timed("19 speculative", phase_speculative, dev, SPEC_T_END,
                 main_stats, act["spike_cap"], smi)
    new_vs_cpu = timed("20 new-paths-card-vs-cpu",
                       phase_new_paths_card_vs_cpu, dev, smi)
    ckpt = timed("22 checkpoint", phase_checkpoint, dev, args.t_end,
                 main_stats, smi)
    service = timed("23 service", phase_service, dev, main_stats, smi)
    compact_service, compact_rows, cs_launches = timed(
        "31 compact-service", phase_compact_service, dev, service,
        act["spike_cap"], smi)
    rows.update(compact_rows)
    launches.update({k: cs_launches[k] for k in ("compact_ids_rows",
                                                 "compact_gather_rows")})
    robust_vs_cpu = timed("24 robust-card-vs-cpu", phase_robust_card_vs_cpu,
                          dev, smi)
    families = timed("25 families", phase_families, dev, smi)
    families_vs_cpu = timed("26 families-card-vs-cpu",
                            phase_families_card_vs_cpu, dev)
    bwd_rows = timed("27 flash-backward", phase_flash_backward, dev)
    rows["flash_attention_bwd"] = bwd_rows["smollm-135m training",
                                           "bfloat16"]
    train_launches, train_stats = timed("28 train", phase_train, dev, smi)
    launches.update(train_launches)
    train_vs_cpu = timed("29 train-card-vs-cpu", phase_train_card_vs_cpu,
                         dev, smi)
    dry = timed("32 dryrun", phase_dryrun, dev, smi)
    if args.profile:
        phase_profile(dev, args.profile, args.t_end)
        phase_profile(dev, args.profile, args.t_end, path="active",
                      wheel="auto", **dict(ACTIVE, batch_cap=act["batch_cap"],
                                           spike_cap=act["spike_cap"]))
        phase_profile_serve(dev, args.profile)
        for arch in FAMILY_ARCHS:
            phase_profile_serve(dev, args.profile, t_pos=16, arch=arch)
        phase_profile_train(dev, args.profile)
    launches.update({k: act_launches[k] for k in ACTIVE_PATH
                     if k not in DENSE_PATH})
    launches.update({k: base_launches[k] for k in BASELINE_PATH})
    kernels = [{"name": k, "route": "cuda", "source": SOURCE[k],
                "replaces": REPLACES[k], "launches": launches[k],
                **{key: rows[k][key] for key in ROW_KEYS}}
               for k in REPLACES]
    main_stats.pop("counts")
    main_stats.pop("ref")
    for k in ("mask", "keys"):
        act.pop(k)
    say("done", f"all phases passed in {time.perf_counter() - t_all:.1f} s;"
        f" walls {json.dumps({k: round(v, 1) for k, v in walls.items()})}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"gpu": smi, "kernels": kernels, "main": main_stats,
             "active": act, "active_launches": act_launches,
             "baseline_2a": base, "baseline_2a_launches": base_launches,
             "other_baselines": others, "spmd": spmd,
             "attention": attn_rows, "serve": lm_stats,
             "lm_card_vs_cpu": lm_vs_cpu, "plastic_schur": plastic,
             "speculative": spec, "new_paths_card_vs_cpu": new_vs_cpu,
             "checkpoint": ckpt, "service": service,
             "global_round": glob, "compact_service": compact_service,
             "walls": walls,
             "robust_card_vs_cpu": robust_vs_cpu, "families": families,
             "families_card_vs_cpu": families_vs_cpu,
             "flash_backward": {f"{n} {d}": r for (n, d), r in
                                bwd_rows.items()},
             "train": train_stats,
             "train_card_vs_cpu": train_vs_cpu, "dryrun": dry},
            indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
