"""Unified LM API over every family of the registry:

    init_params(cfg, key, device)                  -> params
    forward_hidden(cfg, params, batch, device)     -> (hidden, aux_loss)
    loss_fn(cfg, params, batch, device)            -> (loss, (lm, aux))
    loss_and_grad(cfg, params, batch, device)      -> ((loss, (lm, aux)), grads)
    train_step(cfg, params, opt, batch, lr, device) -> (params, opt, metrics)
    init_train_state(cfg, key, device)             -> (params, AdamWState)
    make_decode_state(cfg, B, S, device)           -> KV cache / recurrent state
    decode_step(cfg, params, token, state, t_pos, device) -> (logits, state)
    prefill(cfg, params, batch, device)            -> last-position logits

Families: dense and vlm (``transformer``), moe (``transformer`` with
``moe.moe_ffn_fn``), ssm (``rwkv6``), hybrid (``zamba2``) and audio
(``whisper``).  ``batch`` is a dict with "tokens" (+ "labels" for the
loss, "patches" for vlm, "frames" for audio), tensors or numpy arrays.
Every entry point takes ``device=``, default ``"cuda"``, which raises
without a card.

Parameters are a plain tree of tensors (dicts, per-layer lists) with no
``requires_grad``; ``loss_and_grad`` makes detached leaves that require
grad for its own pass only and takes the gradients with
``torch.autograd.grad`` over the flattened tree, so a trained tree serves
as it is.

Decode states: the attention caches (``k``/``v``, and zamba2's shared
block's) are written at ``t_pos`` in place; rwkv6's and zamba2's
recurrent leaves come back as new tensors.  A caller that needs the old
state clones it first.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_m
from repro_torch.models import rwkv6 as rwkv_m
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper as whisper_m
from repro_torch.models import zamba2 as zamba_m
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm

_INIT = {"dense": tfm.init_params, "vlm": tfm.init_params,
         "moe": moe_m.init_params, "ssm": rwkv_m.init_params,
         "hybrid": zamba_m.init_params, "audio": whisper_m.init_params}


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


def forward_hidden(cfg: ArchConfig, params, batch, attn_chunk=1024,
                   remat=False, device="cuda"):
    """Returns (hidden [B, S, d] aligned with the tokens, aux_loss); the
    aux loss is the MoE layers' load-balance loss, else 0.  ``remat``
    recomputes the transformer layers in the backward pass (dense, vlm,
    moe; the JAX package's families alike); ``attn_chunk`` is ignored
    (K10's tiles bound the score memory)."""
    family = _family(cfg)
    dev = resolve_device(device)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    kw = dict(attn_chunk=attn_chunk, remat=remat)
    if family in ("dense", "moe"):
        x, _, aux = tfm.forward(
            cfg, params, tokens,
            ffn_fn=moe_m.moe_ffn_fn if family == "moe" else None, **kw)
        return x, aux
    zero = torch.zeros((), device=dev)
    if family == "vlm":
        x, _, aux = tfm.forward(cfg, params, tokens,
                                patch_embeds=torch.as_tensor(
                                    batch["patches"], device=dev), **kw)
        return x[:, cfg.n_patches:], aux          # text positions
    if family == "ssm":
        return rwkv_m.forward(cfg, params, tokens)[0], zero
    if family == "hybrid":
        return zamba_m.forward(cfg, params, tokens)[0], zero
    frames = torch.as_tensor(batch["frames"], device=dev)
    return whisper_m.forward(cfg, params, tokens, frames), zero


def loss_fn(cfg: ArchConfig, params, batch, aux_weight=0.01, attn_chunk=1024,
            remat=False, device="cuda"):
    """(lm + aux_weight * aux, (lm, aux)): the chunked tied-embedding
    cross-entropy of the hidden states against ``batch["labels"]``."""
    x, aux = forward_hidden(cfg, params, batch, attn_chunk, remat,
                            device=device)
    labels = torch.as_tensor(batch["labels"], device=x.device)
    lm = cm.chunked_lm_loss(x, params["emb"], labels,
                            compute_dtype=cfg.cdtype())
    return lm + aux_weight * aux, (lm, aux)


def loss_and_grad(cfg: ArchConfig, params, batch, attn_chunk: int = 1024,
                  remat: bool = False, device="cuda"):
    """((loss, (lm, aux)), grads): ``loss_fn`` and its gradient with
    respect to every parameter (zeros where a leaf does not reach the
    loss), a tree like ``params``.  The parameters are detached leaves
    that require grad for this pass only; ``params`` stays as it was."""
    leaves, spec = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, (lm, aux) = loss_fn(cfg, tree_unflatten(live, spec), batch,
                                  attn_chunk=attn_chunk, remat=remat,
                                  device=device)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return (loss.detach(), (lm.detach(), aux.detach())), \
        tree_unflatten(grads, spec)


def train_step(cfg: ArchConfig, params, opt_state, batch, lr,
               max_grad_norm: float = 1.0, attn_chunk: int = 1024,
               remat: bool = False, device="cuda"):
    """One AdamW training step (gradients by ``loss_and_grad``, global-norm
    clipped).  Returns (params, opt_state, metrics) with ``loss``,
    ``lm_loss``, ``aux_loss`` and ``grad_norm`` as 0-d tensors."""
    (loss, (lm, aux)), grads = loss_and_grad(
        cfg, params, batch, attn_chunk, remat, device=resolve_device(device))
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    params, opt_state = adamw_update(grads, opt_state, params, lr)
    metrics = {"loss": loss, "lm_loss": lm, "aux_loss": aux,
               "grad_norm": gnorm}
    return params, opt_state, metrics


def init_train_state(cfg: ArchConfig, key, device="cuda"):
    """(params, AdamWState) of ``init_params``."""
    params = init_params(cfg, key, device=device)
    return params, adamw_init(params)


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
