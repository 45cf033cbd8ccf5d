"""Deterministic synthetic data pipeline (``repro/data/pipeline.py``).

* deterministic as a pure function of (seed, step): a restart or resume
  reproduces the exact token stream with no stored state beyond the
  cursor;
* checkpointable: the cursor is one integer in the train checkpoint.

Tokens follow a Zipf-like unigram draw, ``clip((u ** -0.6 - 1) * V / 50,
0, V - 1)`` with u uniform in [1e-6, 1), with Markov structure: with
probability 0.3 a token copies its predecessor (row-wise roll, the first
copying the last), so losses are non-degenerate and learnable; labels
are the tokens shifted by one.  The vlm family gets ``patches`` [B,
n_patches, d] and audio ``frames`` [B, enc_frames, d], normal * 0.02.

Every draw comes from a CPU ``torch.Generator`` seeded from (seed, step)
(numpy's ``SeedSequence``), so the stream is the same on every device;
the batch is then moved to ``device``.  It is the reference's
distribution, not its threefry stream: a parity test feeds JAX's own
batch to both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, ShapeConfig


def _generator(seed: int, step: int, stream: int) -> torch.Generator:
    """The CPU generator of draw ``stream`` at (seed, step)."""
    state = np.random.SeedSequence([seed, step, stream]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) & (2 ** 63 - 1))


def _tokens_for_step(seed: int, step: int, batch: int, seq: int, vocab: int):
    g = _generator(seed, step, 0)
    # zipf-ish unigram via a power of a uniform
    u = torch.rand((batch, seq), generator=g) * (1.0 - 1e-6) + 1e-6
    zipf = torch.clamp((u ** (-0.6) - 1.0) * vocab / 50.0, 0, vocab - 1)
    toks = zipf.to(torch.int64)
    # markov structure: with p=0.3 copy the previous token (learnable signal)
    copy = torch.rand((batch, seq), generator=g) < 0.3
    return torch.where(copy, torch.roll(toks, 1, dims=1), toks)


@dataclass
class DataPipeline:
    cfg: ArchConfig
    shape: ShapeConfig
    seed: int = 0
    step: int = 0                      # cursor -- checkpointed
    device: str = "cuda"

    def next_batch(self) -> dict:
        b = make_batch(self.cfg, self.shape, self.seed, self.step,
                       device=self.device)
        self.step += 1
        return b

    def state_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, d: dict):
        self.seed = int(d["seed"])
        self.step = int(d["step"])


def make_batch(cfg: ArchConfig, shape: ShapeConfig, seed: int, step: int,
               batch_override: Optional[int] = None, device="cuda") -> dict:
    """{"tokens", "labels"} int64 [B, S] (+ "patches" / "frames" float32)
    on ``device``."""
    dev = resolve_device(device)
    B = batch_override or shape.global_batch
    S = shape.seq_len
    toks = _tokens_for_step(seed, step, B, S + 1, cfg.vocab)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    g = _generator(seed + 7919, step, 1)
    if cfg.family == "audio":
        batch["frames"] = torch.randn((B, cfg.enc_frames, cfg.d_model),
                                      generator=g) * 0.02
    if cfg.family == "vlm":
        batch["patches"] = torch.randn((B, cfg.n_patches, cfg.d_model),
                                       generator=g) * 0.02
    return {k: v.to(dev) for k, v in batch.items()}
