"""Llama-family decoder-only transformer with GQA (+ optional QKV bias),
RMSNorm, RoPE and SwiGLU -- covers deepseek-7b, qwen2-72b, internlm2-20b,
smollm-135m and the internvl2-1b language backbone.

Parameters are a plain dict in the JAX package's layout, weights ``[in,
out]``: ``emb [V, d]``, ``ln_f``, optional ``patch_proj``, and
``layers``, a list of one dict per layer (``ln1, wq, wk, wv, wo, ln2,
w_gate, w_up, w_down`` and ``bq, bk, bv`` with ``qkv_bias``) -- the JAX
package stacks them ``[L, ...]`` and scans; here the scan is a Python
loop.  Attention is flash attention (K10) on the card.

``forward`` marks the embedded tokens ``tokens3d`` and each layer's
output ``residual`` for the dry run (``distributed/ctx.py::constrain``,
at the JAX version's places; outside a sharding context a no-op).

The training forward writes nothing in place (``remat`` recomputes a
layer from its inputs); ``decode_step`` writes each layer's new k/v into
the cache at ``t_pos`` in place (the JAX version returns an updated
copy); a caller that needs the old cache clones it first.

``ffn_fn(cfg, lp, h) -> (y, aux)`` replaces the SwiGLU FFN of every layer
(the MoE family's ``moe.moe_ffn_fn``); ``forward`` returns the sum of the
layers' ``aux``.  The SwiGLU FFN's aux is ``None`` (JAX's is a zero
scalar), so the dense path makes no per-layer tensor for it.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import ctx as dctx
from repro_torch.models import attention as attn
from repro_torch.models import common as cm


def init_layer_params(cfg: ArchConfig, gen, device="cpu") -> dict:
    d, hd = cfg.d_model, cfg.hd
    H, Hkv, ff = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    dt = cfg.pdtype()

    def dense(d_in, d_out):
        return cm.dense_init(gen, d_in, d_out, dt, device=device)

    def ones(n):
        return torch.ones((n,), dtype=dt, device=device)

    p = {"ln1": ones(d), "wq": dense(d, H * hd), "wk": dense(d, Hkv * hd),
         "wv": dense(d, Hkv * hd), "wo": dense(H * hd, d), "ln2": ones(d),
         "w_gate": dense(d, ff), "w_up": dense(d, ff), "w_down": dense(ff, d)}
    if cfg.qkv_bias:
        for name, n in (("bq", H * hd), ("bk", Hkv * hd), ("bv", Hkv * hd)):
            p[name] = torch.zeros((n,), dtype=dt, device=device)
    return p


def init_params(cfg: ArchConfig, gen, device="cpu") -> dict:
    """Random parameters at ``cfg``'s shapes, drawn from ``gen``
    (``common.normal``: on the generator's own device)."""
    params = {
        "emb": cm.dense_init(gen, cfg.vocab, cfg.d_model, cfg.pdtype(),
                             scale=0.02, device=device),
        "layers": [init_layer_params(cfg, gen, device)
                   for _ in range(cfg.n_layers)],
        "ln_f": torch.ones((cfg.d_model,), dtype=cfg.pdtype(), device=device),
    }
    if cfg.n_patches:
        params["patch_proj"] = cm.dense_init(gen, cfg.d_model, cfg.d_model,
                                             cfg.pdtype(), device=device)
    return params


def _qkv(cfg: ArchConfig, lp, x):
    cd = cfg.cdtype()
    q = cm.mm(x, lp["wq"], cd)
    k = cm.mm(x, lp["wk"], cd)
    v = cm.mm(x, lp["wv"], cd)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(torch.float32)
        k = k + lp["bk"].to(torch.float32)
        v = v + lp["bv"].to(torch.float32)
    B, S, _ = x.shape
    q = q.reshape(B, S, cfg.n_heads, cfg.hd)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.hd)
    return q, k, v


def _mlp(cfg: ArchConfig, lp, x):
    cd = cfg.cdtype()
    h = cm.swiglu(cm.mm(x, lp["w_gate"], cd), cm.mm(x, lp["w_up"], cd))
    return cm.mm(h, lp["w_down"], cd), None     # no aux: nothing to launch


def layer_forward(cfg: ArchConfig, lp, x, cos, sin, ffn_fn=None):
    """Full-sequence causal layer (prefill).  x: [B, S, d] float32.
    Returns (x', (k, v), aux) with k/v for cache construction; aux is
    ``None`` for the SwiGLU FFN."""
    h = cm.rms_norm(x, lp["ln1"])
    q, k, v = _qkv(cfg, lp, h)
    q = cm.apply_rope(q, cos, sin)
    k = cm.apply_rope(k, cos, sin)
    o = attn.chunked_causal_attention(q, k, v, compute_dtype=cfg.cdtype())
    B, S, _, _ = o.shape
    x = x + cm.mm(o.reshape(B, S, -1), lp["wo"], cfg.cdtype())
    h = cm.rms_norm(x, lp["ln2"])
    y, aux = (ffn_fn or _mlp)(cfg, lp, h)
    return x + y, (k, v), aux


def layer_decode(cfg: ArchConfig, lp, x, kc, vc, t_pos, cos, sin,
                 ffn_fn=None):
    """One-token decode.  x: [B, 1, d]; kc/vc: [B, S, Hkv, hd] caches,
    written at ``t_pos`` in place."""
    h = cm.rms_norm(x, lp["ln1"])
    q, k, v = _qkv(cfg, lp, h)
    q = cm.apply_rope(q, cos, sin)
    k = cm.apply_rope(k, cos, sin)
    kc[:, t_pos:t_pos + 1] = k.to(kc.dtype)
    vc[:, t_pos:t_pos + 1] = v.to(vc.dtype)
    o = attn.decode_attention(q, kc, vc, t_pos + 1, cfg.cdtype())
    B = x.shape[0]
    x = x + cm.mm(o.reshape(B, 1, -1), lp["wo"], cfg.cdtype())
    h = cm.rms_norm(x, lp["ln2"])
    y, _ = (ffn_fn or _mlp)(cfg, lp, h)
    return x + y, kc, vc


def embed_tokens(cfg: ArchConfig, params, tokens):
    return cm.embed(params["emb"], tokens)


def forward(cfg: ArchConfig, params, tokens, patch_embeds=None,
            return_cache: bool = False, ffn_fn=None, attn_chunk: int = 1024,
            remat: bool = False):
    """Full-sequence forward.  tokens: [B, S] (plus optional VLM patch
    embeddings [B, P, d] prepended).  Returns (hidden [B, S_tot, d],
    (k, v) stacked [L, B, S_tot, Hkv, hd] | None, aux_loss) -- the JAX
    layout; aux_loss sums the layers' ``ffn_fn`` aux (0 for SwiGLU).

    ``remat`` runs each layer under ``torch.utils.checkpoint`` (JAX's
    ``jax.checkpoint`` per layer): a backward pass recomputes the layer's
    activations, K10 included, instead of keeping them.  ``attn_chunk``
    is ignored (``attention.chunked_causal_attention``)."""
    del attn_chunk
    x = dctx.constrain(embed_tokens(cfg, params, tokens), "tokens3d")
    if cfg.n_patches and patch_embeds is not None:
        pe = cm.mm(patch_embeds.to(torch.float32), params["patch_proj"],
                   cfg.cdtype())
        x = torch.cat([pe, x], dim=1)
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    cos, sin = cm.rope_tables(pos, cfg.hd, cfg.rope_theta)
    ks, vs = [], []
    aux = torch.zeros((), device=x.device)
    def layer(lp, x):
        return layer_forward(cfg, lp, x, cos, sin, ffn_fn)

    for lp in params["layers"]:
        if remat:
            x, (k, v), a = checkpoint(layer, lp, x, use_reentrant=False)
        else:
            x, (k, v), a = layer(lp, x)
        x = dctx.constrain(x, "residual")
        if a is not None:
            aux = aux + a
        if return_cache:
            ks.append(k)
            vs.append(v)
    x = cm.rms_norm(x, params["ln_f"])
    caches = (torch.stack(ks), torch.stack(vs)) if return_cache else None
    return x, caches, aux


def decode_step(cfg: ArchConfig, params, token, cache, t_pos, ffn_fn=None):
    """token: [B, 1] int; cache: dict(k=[L,B,S,Hkv,hd], v=...), updated in
    place at ``t_pos``.  One step; returns (logits [B, 1, V], cache)."""
    x = embed_tokens(cfg, params, token)
    pos = torch.full((1,), int(t_pos), device=x.device)
    cos, sin = cm.rope_tables(pos, cfg.hd, cfg.rope_theta)
    for lp, kc, vc in zip(params["layers"], cache["k"], cache["v"]):
        x, _, _ = layer_decode(cfg, lp, x, kc, vc, t_pos, cos, sin, ffn_fn)
    x = cm.rms_norm(x, params["ln_f"])
    logits = cm.mm(x, params["emb"].T, cfg.cdtype())
    return logits, cache


def make_cache(cfg: ArchConfig, batch, seq_len, device="cpu"):
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.cdtype(), device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype(), device=device)}
