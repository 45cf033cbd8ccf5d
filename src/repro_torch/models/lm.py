"""Unified LM serving API over the ported families:

    init_params(cfg, key, device)                  -> params
    forward_hidden(cfg, params, batch, device)     -> final hidden states
    make_decode_state(cfg, B, S, device)           -> KV cache
    decode_step(cfg, params, token, state, t_pos, device) -> (logits, state)
    prefill(cfg, params, batch, device)            -> last-position logits

``batch`` is a dict with "tokens" (+ "patches" for vlm), tensors or numpy
arrays.  The dense and vlm families are ported; MoE, RWKV6, the Mamba2
hybrid and whisper raise ``NotImplementedError``, as do the training
entry points (``loss_fn``, ``train_step``, ``init_train_state``).
Every entry point takes ``device=``, default ``"cuda"``, which raises
without a card.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm

PORTED = ("dense", "vlm")


def _ported(cfg: ArchConfig):
    if cfg.family not in PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet "
            "(ROADMAP item 13: MoE, RWKV6, Zamba2 and whisper)")


def _training(*_a, **_k):
    raise NotImplementedError("LM training is not ported yet (ROADMAP item "
                              "13: optim/adamw, data/pipeline, launch/train)")


loss_fn = train_step = init_train_state = _training


def init_params(cfg: ArchConfig, key, device="cuda"):
    """``key``: an int seed or a CPU ``torch.Generator``."""
    _ported(cfg)
    dev = resolve_device(device)
    gen = key if isinstance(key, torch.Generator) else \
        torch.Generator().manual_seed(int(key))
    return tfm.init_params(cfg, gen, dev)


def forward_hidden(cfg: ArchConfig, params, batch, device="cuda"):
    """Returns (hidden [B, S, d] aligned with the tokens, aux_loss)."""
    _ported(cfg)
    dev = resolve_device(device)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    if cfg.family == "dense":
        x, _, aux = tfm.forward(cfg, params, tokens)
        return x, aux
    x, _, aux = tfm.forward(cfg, params, tokens,
                            patch_embeds=torch.as_tensor(batch["patches"],
                                                         device=dev))
    return x[:, cfg.n_patches:], aux              # text positions


def make_decode_state(cfg: ArchConfig, batch: int, seq_len: int,
                      device="cuda"):
    _ported(cfg)
    return tfm.make_cache(cfg, batch, seq_len, device=resolve_device(device))


def decode_step(cfg: ArchConfig, params, token, state, t_pos, device="cuda"):
    """token: [B, 1] int.  Returns (logits [B, 1, V], state); the state's
    cache is written at ``t_pos`` in place."""
    _ported(cfg)
    token = torch.as_tensor(token, device=resolve_device(device))
    return tfm.decode_step(cfg, params, token, state, int(t_pos))


def prefill(cfg: ArchConfig, params, batch, device="cuda"):
    """Prefill forward (logits for the last position only)."""
    x, _ = forward_hidden(cfg, params, batch, device=device)
    return cm.mm(x[:, -1:], params["emb"].T, cfg.cdtype())
