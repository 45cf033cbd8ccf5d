"""RWKV6 "Finch" (arXiv:2404.05892): attention-free, data-dependent decay
(``repro/models/rwkv6.py``).

Per head (dk = dv = head size) the time-mix state S in R^{dk x dv} evolves

    S_t = diag(w_t) S_{t-1} + k_t v_t^T,      w_t = exp(-exp(wf(x_t)))
    y_t = (r_t)^T (diag(u) k_t v_t^T + S_{t-1})

with token-shift interpolation feeding the r/k/v/w/g projections and an
output gate g (SiLU).  Channel-mix is RWKV's square-ReLU two-layer FFN.

Prefill runs the recurrence step by step (``common.chunked_time_scan``);
decode is the same forward at T = 1 on the carried (S, token-shift)
state.  No TPU kernel is on this path: a step is GEMMs and elementwise
work.  The state comes back as new tensors; the input state is never
written.  The JAX version's ``distributed/ctx.py::constrain`` calls are
no-ops on one card and are not made.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as cm

HEAD_SIZE = 64


def _n_heads(cfg: ArchConfig) -> int:
    return cfg.d_model // HEAD_SIZE


def init_layer_params(cfg: ArchConfig, gen, device="cpu") -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    H = _n_heads(cfg)
    dt = cfg.pdtype()

    def di(d_in, d_out):
        return cm.dense_init(gen, d_in, d_out, dt, device=device)

    def full(v):
        return torch.full((d,), v, dtype=dt, device=device)

    return {
        "ln1": full(1.0),
        "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
        "mu_w": full(0.5), "mu_g": full(0.5),
        "wr": di(d, d), "wk": di(d, d), "wv": di(d, d), "wg": di(d, d),
        "wo": di(d, d),
        # data-dependent decay: low-rank lora + bias (the Finch signature)
        "w_lora_a": di(d, 64), "w_lora_b": di(64, d),
        "w_bias": full(-4.0),
        "bonus_u": cm.normal(gen, (H, HEAD_SIZE), 0.1, dt, device),
        "ln_x": full(1.0),
        "ln2": full(1.0),
        "cm_k": di(d, ff), "cm_v": di(ff, d), "cm_r": di(d, d),
        "mu_ck": full(0.5), "mu_cr": full(0.5),
    }


def init_params(cfg: ArchConfig, gen, device="cpu") -> dict:
    """Random parameters at ``cfg``'s shapes, drawn from ``gen``."""
    return {
        "emb": cm.dense_init(gen, cfg.vocab, cfg.d_model, cfg.pdtype(),
                             scale=0.02, device=device),
        "layers": [init_layer_params(cfg, gen, device)
                   for _ in range(cfg.n_layers)],
        "ln_f": torch.ones((cfg.d_model,), dtype=cfg.pdtype(), device=device),
    }


def _shift_mix(x, x_prev, mu):
    """Token shift: lerp between the current and the previous token,
    channel-wise.  x: [B, S, d]; x_prev: [B, d] (before this block)."""
    xs = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    return x + (xs - x) * mu.to(torch.float32)


def time_mix(cfg: ArchConfig, lp, x, x_prev, S0):
    """x: [B, T, d]; x_prev: [B, d]; S0: [B, H, dk, dv].
    Returns (y, x_last, S_T)."""
    B, T, d = x.shape
    H = _n_heads(cfg)
    cd = cfg.cdtype()
    r = cm.mm(_shift_mix(x, x_prev, lp["mu_r"]), lp["wr"], cd)
    k = cm.mm(_shift_mix(x, x_prev, lp["mu_k"]), lp["wk"], cd)
    v = cm.mm(_shift_mix(x, x_prev, lp["mu_v"]), lp["wv"], cd)
    g = cm.mm(_shift_mix(x, x_prev, lp["mu_g"]), lp["wg"], cd)
    xw = _shift_mix(x, x_prev, lp["mu_w"])
    w_raw = lp["w_bias"].to(torch.float32) + cm.mm(
        torch.tanh(cm.mm(xw, lp["w_lora_a"], cd)), lp["w_lora_b"], cd)
    w = torch.exp(-torch.exp(w_raw))                          # (0, 1)

    hs = (B, T, H, HEAD_SIZE)
    u = lp["bonus_u"].to(torch.float32)[None, :, :, None]

    def step(S, rkvw):
        rt, kt, vt, wt = rkvw                                  # [B, H, hs]
        kv = kt[..., :, None] * vt[..., None, :]
        yt = torch.einsum("bhk,bhkv->bhv", rt, S + u * kv)
        return S * wt[..., None] + kv, yt

    seq = tuple(a.reshape(hs).transpose(0, 1) for a in (r, k, v, w))
    S_T, y = cm.chunked_time_scan(step, S0, seq)
    y = y.transpose(0, 1).reshape(B, T, d)
    y = cm.rms_norm(y, lp["ln_x"]) * F.silu(g)
    return cm.mm(y, lp["wo"], cd), x[:, -1], S_T


def channel_mix(cfg: ArchConfig, lp, x, x_prev):
    cd = cfg.cdtype()
    xk = _shift_mix(x, x_prev, lp["mu_ck"])
    xr = _shift_mix(x, x_prev, lp["mu_cr"])
    k = torch.square(torch.relu(cm.mm(xk, lp["cm_k"], cd)))
    kv = cm.mm(k, lp["cm_v"], cd)
    return torch.sigmoid(cm.mm(xr, lp["cm_r"], cd)) * kv, x[:, -1]


def layer_forward(cfg: ArchConfig, lp, x, state):
    """state: dict(tm_x, cm_x: [B, d]; S: [B, H, dk, dv])."""
    h = cm.rms_norm(x, lp["ln1"])
    y, tm_x, S = time_mix(cfg, lp, h, state["tm_x"], state["S"])
    x = x + y
    h = cm.rms_norm(x, lp["ln2"])
    y, cm_x = channel_mix(cfg, lp, h, state["cm_x"])
    return x + y, {"tm_x": tm_x, "cm_x": cm_x, "S": S}


def make_state(cfg: ArchConfig, batch, device="cpu"):
    """Zero token-shift and time-mix states, float32."""
    L, d = cfg.n_layers, cfg.d_model
    return {
        "tm_x": torch.zeros((L, batch, d), device=device),
        "cm_x": torch.zeros((L, batch, d), device=device),
        "S": torch.zeros((L, batch, _n_heads(cfg), HEAD_SIZE, HEAD_SIZE),
                         device=device),
    }


def forward(cfg: ArchConfig, params, tokens, state=None):
    """Full-sequence forward; returns (hidden, state') with state' new
    tensors ``[L, B, ...]``."""
    B = tokens.shape[0]
    x = cm.embed(params["emb"], tokens)
    if state is None:
        state = make_state(cfg, B, device=x.device)
    new = {k: [] for k in state}
    for i, lp in enumerate(params["layers"]):
        x, st = layer_forward(cfg, lp, x, {k: v[i] for k, v in state.items()})
        for k in new:
            new[k].append(st[k])
    x = cm.rms_norm(x, params["ln_f"])
    return x, {k: torch.stack(v) for k, v in new.items()}


def decode_step(cfg: ArchConfig, params, token, state, t_pos=None):
    """One-token decode: the forward at T = 1 (the recurrence is the
    cache).  Returns (logits [B, 1, V], state')."""
    del t_pos
    x, state = forward(cfg, params, token, state)
    return cm.mm(x, params["emb"].T, cfg.cdtype()), state
