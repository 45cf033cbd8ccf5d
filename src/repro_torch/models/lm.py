"""Unified LM serving API over every family of the registry:

    init_params(cfg, key, device)                  -> params
    forward_hidden(cfg, params, batch, device)     -> (hidden, aux_loss)
    make_decode_state(cfg, B, S, device)           -> KV cache / recurrent state
    decode_step(cfg, params, token, state, t_pos, device) -> (logits, state)
    prefill(cfg, params, batch, device)            -> last-position logits

Families: dense and vlm (``transformer``), moe (``transformer`` with
``moe.moe_ffn_fn``), ssm (``rwkv6``), hybrid (``zamba2``) and audio
(``whisper``).  ``batch`` is a dict with "tokens" (+ "patches" for vlm,
"frames" for audio), tensors or numpy arrays.  The training entry points
(``loss_fn``, ``train_step``, ``init_train_state``) raise
``NotImplementedError``.  Every entry point takes ``device=``, default
``"cuda"``, which raises without a card.

Decode states: the attention caches (``k``/``v``, and zamba2's shared
block's) are written at ``t_pos`` in place; rwkv6's and zamba2's
recurrent leaves come back as new tensors.  A caller that needs the old
state clones it first.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_m
from repro_torch.models import rwkv6 as rwkv_m
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper as whisper_m
from repro_torch.models import zamba2 as zamba_m

_INIT = {"dense": tfm.init_params, "vlm": tfm.init_params,
         "moe": moe_m.init_params, "ssm": rwkv_m.init_params,
         "hybrid": zamba_m.init_params, "audio": whisper_m.init_params}


def _training(*_a, **_k):
    raise NotImplementedError("LM training is not ported yet (ROADMAP item "
                              "13: optim/adamw, data/pipeline, launch/train)")


loss_fn = train_step = init_train_state = _training


def _family(cfg: ArchConfig):
    if cfg.family not in _INIT:
        raise ValueError(cfg.family)
    return cfg.family


def init_params(cfg: ArchConfig, key, device="cuda"):
    """``key``: an int seed (a CPU ``torch.Generator`` seeded with it) or
    a ``torch.Generator``, whose own device draws the weights
    (``common.normal``)."""
    init = _INIT[_family(cfg)]
    dev = resolve_device(device)
    gen = key if isinstance(key, torch.Generator) else \
        torch.Generator().manual_seed(int(key))
    return init(cfg, gen, dev)


def forward_hidden(cfg: ArchConfig, params, batch, device="cuda"):
    """Returns (hidden [B, S, d] aligned with the tokens, aux_loss); the
    aux loss is the MoE layers' load-balance loss, else 0."""
    family = _family(cfg)
    dev = resolve_device(device)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    if family in ("dense", "moe"):
        x, _, aux = tfm.forward(
            cfg, params, tokens,
            ffn_fn=moe_m.moe_ffn_fn if family == "moe" else None)
        return x, aux
    zero = torch.zeros((), device=dev)
    if family == "vlm":
        x, _, aux = tfm.forward(cfg, params, tokens,
                                patch_embeds=torch.as_tensor(
                                    batch["patches"], device=dev))
        return x[:, cfg.n_patches:], aux          # text positions
    if family == "ssm":
        return rwkv_m.forward(cfg, params, tokens)[0], zero
    if family == "hybrid":
        return zamba_m.forward(cfg, params, tokens)[0], zero
    frames = torch.as_tensor(batch["frames"], device=dev)
    return whisper_m.forward(cfg, params, tokens, frames), zero


def make_decode_state(cfg: ArchConfig, batch: int, seq_len: int,
                      device="cuda"):
    family = _family(cfg)
    dev = resolve_device(device)
    if family == "ssm":
        return rwkv_m.make_state(cfg, batch, device=dev)
    if family == "hybrid":
        return zamba_m.make_state(cfg, batch, seq_len, device=dev)
    if family == "audio":
        return whisper_m.make_cache(cfg, batch, seq_len, device=dev)
    return tfm.make_cache(cfg, batch, seq_len, device=dev)


def decode_step(cfg: ArchConfig, params, token, state, t_pos, device="cuda"):
    """token: [B, 1] int.  Returns (logits [B, 1, V], state)."""
    family = _family(cfg)
    token = torch.as_tensor(token, device=resolve_device(device))
    t_pos = int(t_pos)
    if family == "ssm":
        return rwkv_m.decode_step(cfg, params, token, state, t_pos)
    if family == "hybrid":
        return zamba_m.decode_step(cfg, params, token, state, t_pos)
    if family == "audio":
        return whisper_m.decode_step(cfg, params, token, state, t_pos)
    return tfm.decode_step(
        cfg, params, token, state, t_pos,
        ffn_fn=moe_m.moe_ffn_fn if family == "moe" else None)


def prefill(cfg: ArchConfig, params, batch, device="cuda"):
    """Prefill forward (logits for the last position only)."""
    x, _ = forward_hidden(cfg, params, batch, device=device)
    return cm.mm(x[:, -1:], params["emb"].T, cfg.cdtype())
