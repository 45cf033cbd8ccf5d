"""How far last-bit differences move each LM family's training on the
CPU: the conditioning behind ``chip_smoke.py`` phase 29's card-against-CPU
tolerances.

    PYTHONPATH=src python3 scripts/train_sensitivity.py [--steps 3] \\
        [--trials 3] [--lr 1e-3]

For each family's reduced config (float32), every parameter is scaled
by (1 + 2**-24 n), n standard normal -- a float32 last-bit perturbation
-- and both trees take ``--steps`` ``lm.train_step``s on the same
``data.make_batch`` batches (B 4, S 64, seed 0).  Printed per family, the
widest of ``--trials`` perturbations: each leaf's gradient change as a
share of that leaf's largest |g| (worst leaf named), and the relative
change of the loss and of the grad norm.  The card and the CPU differ by
such last bits (exp, the order of sums), so these set the scale of their
gaps.  CPU only; a few seconds a family.
"""
from __future__ import annotations

import argparse

import torch
from torch.utils._pytree import (keystr, tree_flatten,
                                 tree_flatten_with_path, tree_map)

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import make_batch
from repro_torch.models import lm
from repro_torch.optim import adamw_init

ARCHS = ("smollm-135m", "internvl2-1b", "qwen3-moe-30b-a3b", "rwkv6-7b",
         "zamba2-7b", "whisper-base")


def _grads(cfg, params, batch):
    return tree_flatten(lm.loss_and_grad(cfg, params, batch,
                                         device="cpu")[1])[0]


def sensitivity(arch, steps=3, trials=3, lr=1e-3, seed=0):
    """(widest gradient change of a leaf's largest |g|, its leaf, widest
    relative change of the loss or grad norm)."""
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(seed)
    base = lm.init_params(cfg, 0, device="cpu")
    paths = [keystr(k) for k, _ in tree_flatten_with_path(base)[0]]
    grad_gap, leaf, metric_gap = 0.0, "", 0.0
    for _ in range(trials):
        p = base
        q = tree_map(lambda x: x * (1 + 2.0 ** -24 * torch.randn(
            x.shape, generator=gen)), base)
        po, qo = adamw_init(p), adamw_init(q)
        for step in range(steps):
            batch = make_batch(cfg, ShapeConfig("t", 64, 4, "train"), 0,
                               step, device="cpu")
            for a, b, name in zip(_grads(cfg, q, batch),
                                  _grads(cfg, p, batch), paths):
                gap = float((a - b).abs().max() /
                            b.abs().max().clamp_min(1e-30))
                if gap > grad_gap:
                    grad_gap, leaf = gap, name
            p, po, mp = lm.train_step(cfg, p, po, batch, lr, device="cpu")
            q, qo, mq = lm.train_step(cfg, q, qo, batch, lr, device="cpu")
            for k in ("loss", "grad_norm"):
                metric_gap = max(metric_gap, abs(float(mq[k] - mp[k])) /
                                 abs(float(mp[k])))
    return grad_gap, leaf, metric_gap


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-3)
    args = ap.parse_args(argv)
    for arch in ARCHS:
        g, leaf, m = sensitivity(arch, args.steps, args.trials, args.lr)
        print(f"{arch}: gradient {g:.3e} of its leaf's largest ({leaf}); "
              f"loss or grad norm {m:.3e} relative", flush=True)


if __name__ == "__main__":
    main()
