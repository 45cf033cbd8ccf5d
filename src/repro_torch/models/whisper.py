"""Whisper-style encoder-decoder (arXiv:2212.04356), the transformer
backbone only (``repro/models/whisper.py``): the conv/log-mel frontend is
a stub, and callers supply frame embeddings ``[B, enc_frames, d]``.

Encoder: bidirectional self-attention over the frames (+ learned
positions).  Decoder: causal self-attention + cross-attention to the
encoder output.  Every attention is K10: the encoder and the
cross-attention with ``causal=False`` (``attention.
bidirectional_attention``), the decoder's self-attention causal.  GELU is
``jax.nn.gelu``'s default, the tanh approximation.

Decode keeps a self-attention K/V cache, written at ``t_pos`` in place,
and cross K/V ``ek``/``ev``.  ``make_cache`` leaves the cross K/V zero,
as the JAX version's does (it takes ``frames`` and leaves them unused),
so the serve loop decodes against zero cross K/V; ``forward`` (prefill)
takes ``frames``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import common as cm


def _init_attn(gen, d, H, hd, dt, device):
    return {name: cm.dense_init(gen, *shape, dt, device=device)
            for name, shape in (("wq", (d, H * hd)), ("wk", (d, H * hd)),
                                ("wv", (d, H * hd)), ("wo", (H * hd, d)))}


def _init_mlp(gen, d, ff, dt, device):
    return {"w1": cm.dense_init(gen, d, ff, dt, device=device),
            "w2": cm.dense_init(gen, ff, d, dt, device=device)}


def _norm(cfg, device, v):
    return torch.full((cfg.d_model,), v, dtype=cfg.pdtype(), device=device)


def init_enc_layer(cfg: ArchConfig, gen, device="cpu") -> dict:
    dt, d = cfg.pdtype(), cfg.d_model
    return {
        "ln1": _norm(cfg, device, 1.0), "b1": _norm(cfg, device, 0.0),
        "attn": _init_attn(gen, d, cfg.n_heads, cfg.hd, dt, device),
        "ln2": _norm(cfg, device, 1.0), "b2": _norm(cfg, device, 0.0),
        "mlp": _init_mlp(gen, d, cfg.d_ff, dt, device),
    }


def init_dec_layer(cfg: ArchConfig, gen, device="cpu") -> dict:
    dt, d = cfg.pdtype(), cfg.d_model
    return {
        "ln1": _norm(cfg, device, 1.0), "b1": _norm(cfg, device, 0.0),
        "self": _init_attn(gen, d, cfg.n_heads, cfg.hd, dt, device),
        "lnx": _norm(cfg, device, 1.0), "bx": _norm(cfg, device, 0.0),
        "cross": _init_attn(gen, d, cfg.n_heads, cfg.hd, dt, device),
        "ln2": _norm(cfg, device, 1.0), "b2": _norm(cfg, device, 0.0),
        "mlp": _init_mlp(gen, d, cfg.d_ff, dt, device),
    }


def init_params(cfg: ArchConfig, gen, device="cpu") -> dict:
    """Random parameters at ``cfg``'s shapes, drawn from ``gen``."""
    dt = cfg.pdtype()
    return {
        "emb": cm.dense_init(gen, cfg.vocab, cfg.d_model, dt, scale=0.02,
                             device=device),
        "enc_pos": cm.dense_init(gen, cfg.enc_frames, cfg.d_model, dt,
                                 scale=0.02, device=device),
        "enc": [init_enc_layer(cfg, gen, device)
                for _ in range(cfg.enc_layers)],
        "dec": [init_dec_layer(cfg, gen, device)
                for _ in range(cfg.n_layers)],
        "ln_f": _norm(cfg, device, 1.0),
        "bn_f": _norm(cfg, device, 0.0),
    }


def _heads(cfg, y, B, S):
    return y.reshape(B, S, cfg.n_heads, cfg.hd)


def _gelu_mlp(cfg, mp, x):
    cd = cfg.cdtype()
    return cm.mm(F.gelu(cm.mm(x, mp["w1"], cd), approximate="tanh"),
                 mp["w2"], cd)


def encode(cfg: ArchConfig, params, frames):
    """frames: [B, F, d] (stub embeddings) -> encoder output [B, F, d]."""
    B, Fr, _ = frames.shape
    x = frames.to(torch.float32) + params["enc_pos"].to(torch.float32)[None]
    cd = cfg.cdtype()
    for lp in params["enc"]:
        h = cm.layer_norm(x, lp["ln1"], lp["b1"])
        q, k, v = (_heads(cfg, cm.mm(h, lp["attn"][w], cd), B, Fr)
                   for w in ("wq", "wk", "wv"))
        o = attn.bidirectional_attention(q, k, v, cd)
        x = x + cm.mm(o.reshape(B, Fr, -1), lp["attn"]["wo"], cd)
        h = cm.layer_norm(x, lp["ln2"], lp["b2"])
        x = x + _gelu_mlp(cfg, lp["mlp"], h)
    return x


def _dec_layer(cfg, lp, x, enc_kv, self_kv, t_pos, B, S):
    """One decoder layer; ``self_kv`` None -> full-sequence causal, else
    the layer's (k, v) caches, written at ``t_pos`` in place."""
    cd = cfg.cdtype()
    h = cm.layer_norm(x, lp["ln1"], lp["b1"])
    q, k, v = (_heads(cfg, cm.mm(h, lp["self"][w], cd), B, S)
               for w in ("wq", "wk", "wv"))
    if self_kv is None:
        o = attn.chunked_causal_attention(q, k, v, compute_dtype=cd)
    else:
        kc, vc = self_kv
        kc[:, t_pos:t_pos + 1] = k.to(kc.dtype)
        vc[:, t_pos:t_pos + 1] = v.to(vc.dtype)
        o = attn.decode_attention(q, kc, vc, t_pos + 1, cd)
    x = x + cm.mm(o.reshape(B, S, -1), lp["self"]["wo"], cd)
    # cross attention to the (precomputed) encoder K/V
    ek, ev = enc_kv
    h = cm.layer_norm(x, lp["lnx"], lp["bx"])
    q = _heads(cfg, cm.mm(h, lp["cross"]["wq"], cd), B, S)
    o = attn.bidirectional_attention(q, ek, ev, cd)
    x = x + cm.mm(o.reshape(B, S, -1), lp["cross"]["wo"], cd)
    h = cm.layer_norm(x, lp["ln2"], lp["b2"])
    return x + _gelu_mlp(cfg, lp["mlp"], h)


def _enc_kv(cfg, params, enc_out):
    """Each decoder layer's cross (k, v) [B, F, H, hd] from the encoder
    output."""
    B, Fr, _ = enc_out.shape
    cd = cfg.cdtype()
    return [tuple(_heads(cfg, cm.mm(enc_out, lp["cross"][w], cd), B, Fr)
                  for w in ("wk", "wv")) for lp in params["dec"]]


def forward(cfg: ArchConfig, params, tokens, frames):
    """Prefill forward: the decoder's hidden states [B, S, d]."""
    B, S = tokens.shape
    enc_kv = _enc_kv(cfg, params, encode(cfg, params, frames))
    x = cm.embed(params["emb"], tokens)
    for lp, kv in zip(params["dec"], enc_kv):
        x = _dec_layer(cfg, lp, x, kv, None, 0, B, S)
    return cm.layer_norm(x, params["ln_f"], params["bn_f"])


def decode_step(cfg: ArchConfig, params, token, cache, t_pos):
    """cache: dict(k, v: [L, B, S, H, hd] self caches, written at
    ``t_pos`` in place; ek, ev: [L, B, F, H, hd] cross K/V).  Returns
    (logits [B, 1, V], cache)."""
    B = token.shape[0]
    x = cm.embed(params["emb"], token)
    for i, lp in enumerate(params["dec"]):
        x = _dec_layer(cfg, lp, x, (cache["ek"][i], cache["ev"][i]),
                       (cache["k"][i], cache["v"][i]), int(t_pos), B, 1)
    x = cm.layer_norm(x, params["ln_f"], params["bn_f"])
    return cm.mm(x, params["emb"].T, cfg.cdtype()), cache


def make_cache(cfg: ArchConfig, batch, seq_len, device="cpu"):
    """Zero self and cross K/V in the compute dtype (the JAX version takes
    ``frames`` and leaves them unused)."""
    L, H, hd = cfg.n_layers, cfg.n_heads, cfg.hd

    def zeros(S):
        return torch.zeros((L, batch, S, H, hd), dtype=cfg.cdtype(),
                           device=device)

    return {"k": zeros(seq_len), "v": zeros(seq_len),
            "ek": zeros(cfg.enc_frames), "ev": zeros(cfg.enc_frames)}
