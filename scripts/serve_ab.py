"""The port's LM serve path, two source trees in turns on one NVIDIA card.

    python3 scripts/serve_ab.py BASE_TREE [NEW_TREE] [--order ABBAAB]

Each tree (the root of a checkout; NEW_TREE defaults to this one) runs in
its own process with its own ``src/`` first on the path and builds its own
kernels.  Every run measures, for smollm-135m at full width with seeded
random weights:

* ``k10_host_us``: host time of one decode-step K10 call (bf16, B 4,
  H 9/3, kv_len 200 of a 256-slot cache): wall over 1000 calls back to
  back, median of 5 -- the card finishes each call sooner than the host
  issues the next;
* ``prefill_ms``: ``lm.prefill`` of 4 x 2048 tokens, median of 3;
* ``step_ms``: wall of ``lm.decode_step`` at batch 4 with the logits'
  argmax read back every step (as the serve loop does), median of three
  windows of 50 steps; ``step_device_ms`` and ``step_k10_device_ms``:
  ``torch.profiler``'s device time per step, all kernels and K10's;
* ``ms_step`` and ``tok_s``: ``launch.serve.lm_main`` at its CLI defaults,
  and inside it the host time of K10's calls per step (``k10_ms_step``).

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

WORKER = r'''
import functools, json, statistics, time
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels.attention import ops
from repro_torch.launch import serve
from repro_torch.models import attention, lm

build.build_all()
dev = torch.device("cuda")
g = torch.Generator().manual_seed(0)
q, k, v = (torch.randn((4, S, h, 64), generator=g).to(dev, torch.bfloat16)
           .transpose(1, 2) for S, h in ((1, 9), (256, 3), (256, 3)))
kw = dict(causal=True, offset=199, kv_len=200, out_dtype=torch.float32)
for _ in range(50):
    ops.flash_attention(q, k, v, **kw)
torch.cuda.synchronize()
host = []
for _ in range(5):
    t0 = time.perf_counter()
    for _ in range(1000):
        ops.flash_attention(q, k, v, **kw)
    host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()

cfg = get_config("smollm-135m")
params = lm.init_params(cfg, 0, device=dev)
toks = torch.randint(0, cfg.vocab, (4, 2048),
                     generator=torch.Generator().manual_seed(1))
lm.prefill(cfg, params, {"tokens": toks[:, :64]}, device=dev)
pre = []
for _ in range(3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm.prefill(cfg, params, {"tokens": toks}, device=dev)
    torch.cuda.synchronize()
    pre.append((time.perf_counter() - t0) * 1e3)

state = lm.make_decode_state(cfg, 4, 256, device=dev)
tok = torch.zeros((4, 1), dtype=torch.int64, device=dev)

def steps(t0, t1):
    global state
    for t in range(t0, t1):
        logits, state = lm.decode_step(cfg, params, tok, state, t, device=dev)
        logits.argmax(-1).cpu()

steps(0, 64)
step = []
for w in range(3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(64 + 50 * w, 114 + 50 * w)
    step.append((time.perf_counter() - t0) / 50 * 1e3)
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    steps(214, 224)
    torch.cuda.synchronize()
ev = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
dev_ms = sum(e.self_device_time_total for e in ev) / 10 / 1e3
k10_ms = sum(e.self_device_time_total for e in ev if "flash" in e.key) / 1e4
del params

k10 = {"s": 0.0}
call = ops.flash_attention

@functools.wraps(call)
def timed(*a, **kw):
    t0 = time.perf_counter()
    out = call(*a, **kw)
    k10["s"] += time.perf_counter() - t0
    return out

attention.ops.flash_attention = timed
res = serve.lm_main(serve.build_parser().parse_args([]))
n = res.decode_steps
print("RESULT " + json.dumps(dict(
    k10_host_us=statistics.median(host), prefill_ms=statistics.median(pre),
    step_ms=statistics.median(step), step_device_ms=dev_ms,
    step_k10_device_ms=k10_ms, ms_step=res.seconds / n * 1e3,
    tok_s=res.n_tokens / res.seconds, k10_ms_step=k10["s"] / n * 1e3)))
'''


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", help="root of the tree run as A")
    ap.add_argument("new", nargs="?", default=str(Path(__file__).parents[1]),
                    help="root of the tree run as B (default: this one)")
    ap.add_argument("--order", default="ABBAAB",
                    help="the runs, in turn (default ABBAAB)")
    args = ap.parse_args(argv)
    trees = {"A": args.base, "B": args.new}
    for name in args.order:
        env = dict(os.environ,
                   PYTHONPATH=str(Path(trees[name]).resolve() / "src"))
        r = subprocess.run([sys.executable, "-c", WORKER], env=env,
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
