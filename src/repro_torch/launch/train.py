"""Training launcher of the port (``repro/launch/train.py``)::

    python -m repro_torch.launch.train --arch smollm-135m --reduced \\
        --device cpu --steps 25 --batch 4 --seq 64
    python -m repro_torch.launch.train --arch smollm-135m   # on the card

Wires together the config registry, the synthetic data pipeline, AdamW
with the warmup-stable-decay schedule, checkpoints and the
``RestartManager`` (resume, NaN quarantine, straggler monitor), with
optional failure injection (``--inject-failure-at``: exit code 75, rerun
to resume from the last checkpoint).  On the card every attention call
is flash attention (K10) and its gradient K10's backward kernels.

The data cursor is stored in the checkpoint's extras, and the stream is
a pure function of (seed, step), so a killed and resumed run reproduces
the uninterrupted one's losses bitwise on the same device.
"""
from __future__ import annotations

import argparse
import os
import dataclasses
import sys
import tempfile
from typing import NamedTuple

import torch
from torch.utils._pytree import tree_flatten

from repro_torch import resolve_device
from repro_torch.checkpoint import RestartManager, SimulatedFailure
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataPipeline
from repro_torch.models import lm
from repro_torch.optim import adamw_init, wsd_schedule


def scale_config(cfg, d_model=None, n_layers=None, vocab=None):
    kw = {}
    if d_model:
        kw["d_model"] = d_model
        if cfg.n_heads:
            kw["head_dim"] = max(d_model // cfg.n_heads, 8)
    if n_layers:
        kw["n_layers"] = n_layers
    if vocab:
        kw["vocab"] = vocab
    return dataclasses.replace(cfg, **kw) if kw else cfg


class TrainResult(NamedTuple):
    """What a launcher run returns: its exit code (75 after an injected
    failure), the first step it ran, the parameter count and the
    ``RestartManager`` history (one dict per step: ``step``, ``loss``,
    ``time_s``)."""
    rc: int
    start: int
    n_params: int
    history: list


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def train(args) -> TrainResult:
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = scale_config(cfg, args.d_model, args.n_layers, args.vocab)
    shape = ShapeConfig("custom", args.seq, args.batch, "train")
    pipe = DataPipeline(cfg, shape, seed=args.seed, device=dev)
    mgr = RestartManager(args.ckpt_dir, save_every=args.save_every)

    def init_fn():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = lm.init_params(cfg, gen, device=dev)
        return {"params": params, "opt": adamw_init(params)}

    state, extras, start = mgr.resume_or_init(init_fn)
    if extras.get("data"):
        pipe.load_state_dict(extras["data"])
    pipe.step = start
    n_params = sum(p.numel() for p in tree_flatten(state["params"])[0])
    print(f"arch={cfg.name} params={n_params / 1e6:.2f}M start_step={start}",
          flush=True)

    def step_fn(state, step):
        batch = pipe.next_batch()
        lr = wsd_schedule(torch.tensor(step, device=dev), args.lr, warmup=20,
                          total=args.steps)
        params, opt, metrics = lm.train_step(cfg, state["params"],
                                             state["opt"], batch, lr,
                                             device=dev)
        return {"params": params, "opt": opt}, metrics

    try:
        state, history = mgr.run(
            state, start, args.steps, step_fn,
            data_state_fn=lambda: {"data": pipe.state_dict()},
            inject_failure_at=(args.inject_failure_at
                               if args.inject_failure_at >= 0 else None))
    except SimulatedFailure as e:
        print(f"[ft] {e} -- restart the launcher to resume from checkpoint")
        return TrainResult(75, start, n_params, [])
    final = history[-1]["loss"] if history else float("nan")
    first = history[0]["loss"] if history else float("nan")
    print(f"done: steps={len(history)} loss {first:.4f} -> {final:.4f}")
    return TrainResult(0, start, n_params, history)


def main(argv=None):
    return train(build_parser().parse_args(argv)).rc


if __name__ == "__main__":
    sys.exit(main())
