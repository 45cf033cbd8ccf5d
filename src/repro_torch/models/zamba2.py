"""Zamba2-style hybrid (arXiv:2411.15242): a backbone of Mamba2 blocks with
one *shared* attention+MLP block applied every ``shared_attn_every``
layers, the same weights at every application (``repro/models/zamba2.py``).

The Mamba2 block (arXiv:2405.21060, SSD): in-projection to (z, x, B, C,
dt), a depthwise causal conv on x, and a selective state update with a
scalar decay per head

    h_t = exp(-exp(A_log) * dt_t) * h_{t-1} + dt_t * (B_t x_t^T)
    y_t = C_t^T h_t + D * x_t

with state h in R^{n_state x d_head} per head, stepped by
``common.chunked_time_scan``.  Decode carries (conv window, h) per layer,
and the shared block's K/V cache per application.

The shared block runs after every full segment of ``shared_attn_every``
layers; a trailing partial segment gets none (81 layers of 6: 13
applications).  Its attention is K10; zamba2-7b's head size is 3584 / 32
= 112.  ``decode_step`` returns new conv and h tensors and writes the
shared caches ``k``/``v`` ``[n_apps, B, S, Hkv, hd]`` at ``t_pos`` in
place, as the transformer's decode does (the JAX version returns updated
copies).  The JAX version's ``distributed/ctx.py::constrain`` calls are
no-ops on one card and are not made.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm


def _dims(cfg: ArchConfig):
    d_inner = 2 * cfg.d_model
    n_heads = d_inner // 64            # mamba2 head size 64
    return d_inner, n_heads


def init_mamba_params(cfg: ArchConfig, gen, device="cpu") -> dict:
    d = cfg.d_model
    d_inner, H = _dims(cfg)
    n = cfg.ssm_state
    dt = cfg.pdtype()

    def const(shape, v):
        return torch.full(shape, v, dtype=dt, device=device)

    return {
        "ln": const((d,), 1.0),
        # fused in-projection: z, x, B, C, dt
        "w_in": cm.dense_init(gen, d, 2 * d_inner + 2 * n + H, dt,
                              device=device),
        "conv_w": cm.normal(gen, (cfg.ssm_conv, d_inner), 0.2, dt, device),
        "conv_b": const((d_inner,), 0.0),
        "A_log": const((H,), 0.0),
        "D": const((H,), 1.0),
        "dt_bias": const((H,), 0.0),
        "w_out": cm.dense_init(gen, d_inner, d, dt, device=device),
        "ln_y": const((d_inner,), 1.0),
    }


def init_params(cfg: ArchConfig, gen, device="cpu") -> dict:
    """Random parameters at ``cfg``'s shapes, drawn from ``gen``."""
    return {
        "emb": cm.dense_init(gen, cfg.vocab, cfg.d_model, cfg.pdtype(),
                             scale=0.02, device=device),
        "layers": [init_mamba_params(cfg, gen, device)
                   for _ in range(cfg.n_layers)],
        "shared": tfm.init_layer_params(cfg, gen, device),  # ONE block
        "ln_f": torch.ones((cfg.d_model,), dtype=cfg.pdtype(), device=device),
    }


def _split_in(cfg, proj):
    d_inner, _ = _dims(cfg)
    n = cfg.ssm_state
    return (proj[..., :d_inner], proj[..., d_inner:2 * d_inner],
            proj[..., 2 * d_inner:2 * d_inner + n],
            proj[..., 2 * d_inner + n:2 * d_inner + 2 * n],
            proj[..., 2 * d_inner + 2 * n:])


def mamba_forward(cfg: ArchConfig, lp, x, conv_state, h0):
    """x: [B, T, d]; conv_state: [B, K-1, d_inner]; h0: [B, H, n, hd].
    Returns (x + y, conv_state', h_T)."""
    B, T, d = x.shape
    d_inner, H = _dims(cfg)
    K = cfg.ssm_conv
    hd = d_inner // H
    cd = cfg.cdtype()
    hn = cm.rms_norm(x, lp["ln"])
    proj = cm.mm(hn, lp["w_in"], cd)
    z, xs, Bm, Cm, dt_raw = _split_in(cfg, proj)

    # depthwise causal conv over time (window K) with carried state
    xc = torch.cat([conv_state, xs], dim=1)                   # [B, K-1+T, di]
    w = lp["conv_w"].to(torch.float32)
    xconv = sum(xc[:, i:i + T] * w[i][None, None] for i in range(K))
    xconv = F.silu(xconv + lp["conv_b"].to(torch.float32))
    conv_state_new = xc[:, -(K - 1):] if K > 1 else conv_state

    dt_t = F.softplus(dt_raw + lp["dt_bias"].to(torch.float32))  # [B, T, H]
    a = torch.exp(-torch.exp(lp["A_log"].to(torch.float32))[None, None]
                  * dt_t)
    xh = xconv.reshape(B, T, H, hd)

    def step(h, inp):
        xt, Bt, Ct, at, dtt = inp
        upd = Bt[:, None, :, None] * (xt * dtt[..., None])[:, :, None, :]
        h = h * at[..., None, None] + upd                    # [B, H, n, hd]
        return h, torch.einsum("bn,bhnp->bhp", Ct, h)

    seq = (xh.transpose(0, 1), Bm.transpose(0, 1), Cm.transpose(0, 1),
           a.transpose(0, 1), dt_t.transpose(0, 1))
    hT, y = cm.chunked_time_scan(step, h0, seq)
    y = y.transpose(0, 1).reshape(B, T, d_inner)
    # D per head, repeated over its hd channels (jnp.repeat)
    y = y + xconv * lp["D"].to(torch.float32).repeat_interleave(hd)[None,
                                                                    None]
    y = cm.rms_norm(y, lp["ln_y"]) * F.silu(z)
    return x + cm.mm(y, lp["w_out"], cd), conv_state_new, hT


def _n_shared_apps(cfg: ArchConfig) -> int:
    e = max(cfg.shared_attn_every, 1)
    return max(1, cfg.n_layers // e)


def make_state(cfg: ArchConfig, batch, seq_len, device="cpu"):
    """Recurrent state of every layer (float32) + the K/V caches of the
    shared block's applications (compute dtype)."""
    d_inner, H = _dims(cfg)
    L = cfg.n_layers
    kv = (_n_shared_apps(cfg), batch, seq_len, cfg.n_kv_heads, cfg.hd)
    return {
        "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, d_inner),
                            device=device),
        "h": torch.zeros((L, batch, H, cfg.ssm_state, d_inner // H),
                         device=device),
        "k": torch.zeros(kv, dtype=cfg.cdtype(), device=device),
        "v": torch.zeros(kv, dtype=cfg.cdtype(), device=device),
    }


def _segments(cfg: ArchConfig):
    """(lo, hi, app): the mamba layers lo..hi-1 of each segment, and the
    shared block's application after it (None after a partial one)."""
    every = max(cfg.shared_attn_every, 1)
    n_apps, L = _n_shared_apps(cfg), cfg.n_layers
    for app in range(n_apps + 1):
        lo, hi = app * every, min((app + 1) * every, L)
        if lo >= L:
            break
        yield lo, hi, (app if hi == lo + every and app < n_apps else None)


def forward(cfg: ArchConfig, params, tokens, state=None):
    """Full-sequence forward; returns (hidden, state') -- state' with new
    conv and h, and the input's k/v (the forward fills no cache, as in
    the JAX version)."""
    B, T = tokens.shape
    x = cm.embed(params["emb"], tokens)
    if state is None:
        state = make_state(cfg, B, T, device=x.device)
    pos = torch.arange(T, device=x.device)
    cos, sin = cm.rope_tables(pos, cfg.hd, cfg.rope_theta)
    convs, hs = [], []
    for lo, hi, app in _segments(cfg):
        for i in range(lo, hi):
            x, conv, h = mamba_forward(cfg, params["layers"][i], x,
                                       state["conv"][i], state["h"][i])
            convs.append(conv)
            hs.append(h)
        if app is not None:
            x, _, _ = tfm.layer_forward(cfg, params["shared"], x, cos, sin)
    x = cm.rms_norm(x, params["ln_f"])
    return x, dict(state, conv=torch.stack(convs), h=torch.stack(hs))


def decode_step(cfg: ArchConfig, params, token, state, t_pos):
    """One-token decode: the mamba recurrences and the shared block's K/V
    caches (written at ``t_pos`` in place).  Returns (logits [B, 1, V],
    state')."""
    x = cm.embed(params["emb"], token)
    pos = torch.full((1,), int(t_pos), device=x.device)
    cos, sin = cm.rope_tables(pos, cfg.hd, cfg.rope_theta)
    convs, hs = [], []
    for lo, hi, app in _segments(cfg):
        for i in range(lo, hi):
            x, conv, h = mamba_forward(cfg, params["layers"][i], x,
                                       state["conv"][i], state["h"][i])
            convs.append(conv)
            hs.append(h)
        if app is not None:
            x, _, _ = tfm.layer_decode(cfg, params["shared"], x,
                                       state["k"][app], state["v"][app],
                                       int(t_pos), cos, sin)
    x = cm.rms_norm(x, params["ln_f"])
    logits = cm.mm(x, params["emb"].T, cfg.cdtype())
    return logits, dict(state, conv=torch.stack(convs), h=torch.stack(hs))
