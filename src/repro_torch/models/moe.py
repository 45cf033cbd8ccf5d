"""Mixture-of-Experts FFN with top-k routing and grouped, capacity-based
dispatch (``repro/models/moe.py``).

Covers arctic-480b (128 experts, top-2, plus a dense residual FFN) and
qwen3-moe-30b-a3b (128 experts, top-8).  Expert weights are stacked
``[E, ...]``.  Tokens are split into G groups, each routed with its own
capacity ``C``: a token's k experts are sorted by expert id (stable), an
entry's rank in its expert's run is its slot, and entries ranked past C
are dropped.  The dispatch buffer is ``[G, E, C, d]``, sharded G over
data and E over model: it and the experts' output are marked
``moe_buf`` (``distributed/ctx.py::constrain``, the MoE all-to-all of
the dry run's reckoning), as in the JAX version.  Every shape is fixed by
the config and the token count, none by the routing, so the layer runs
on the ``meta`` device too.

Where the port must not follow the obvious torch call:

* top-k: ``lax.top_k`` puts the lower expert index first among equal
  probabilities; ``torch.topk`` promises no order, so the first k of a
  stable descending sort are taken;
* the combine: JAX scatter-adds each kept entry into its token's row.  A
  float ``index_add_`` on the card adds with atomics, in an order that
  changes from run to run, and greedy picks would follow the last bits.
  Every token has exactly k entries, so they are put back in token order
  through the inverse of the sort and summed over k in a fixed order;
  dropped entries add 0.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import ctx as dctx
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm

# default group count ~= data-parallel degree of the JAX package's
# production mesh.
DEFAULT_GROUPS = 32


def init_moe_params(cfg: ArchConfig, gen, device="cpu") -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.pdtype()
    return {
        "router": cm.dense_init(gen, d, E, dt, scale=0.02, device=device),
        "w_gate": cm.normal(gen, (E, d, ff), d ** -0.5, dt, device),
        "w_up": cm.normal(gen, (E, d, ff), d ** -0.5, dt, device),
        "w_down": cm.normal(gen, (E, ff, d), ff ** -0.5, dt, device),
    }


def groups(T: int) -> int:
    """The group count G of ``T`` tokens: ``DEFAULT_GROUPS``, at most
    T // 64 (at least 1), lowered until it divides T."""
    G = min(DEFAULT_GROUPS, max(1, T // 64))
    while T % G:
        G -= 1
    return G


def capacity(cfg: ArchConfig, Tg: int) -> int:
    """Slots per expert and group: ``int(capacity_factor * Tg * k / E) + 1``."""
    return int(cfg.capacity_factor * Tg * cfg.top_k / cfg.n_experts) + 1


def top_k(probs, k: int):
    """(values, indices) of the k largest entries of the last axis, in
    descending order, the lower index first among equal values
    (``lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Routing(NamedTuple):
    """One MoE layer's routing of ``[G, Tg]`` tokens.  ``expert`` /
    ``gate`` ``[G, Tg, k]``: each token's experts and normalised gates.
    The dispatch entries ``[G, Tg*k]`` in expert order: ``order`` (the
    stable sort of the flat expert ids), ``e_s``, ``g_s``, ``t_s`` (expert,
    gate and token of each entry), ``rank`` (its place in its expert's
    run), ``keep`` (rank < capacity)."""
    probs: torch.Tensor
    expert: torch.Tensor
    gate: torch.Tensor
    order: torch.Tensor
    e_s: torch.Tensor
    g_s: torch.Tensor
    t_s: torch.Tensor
    rank: torch.Tensor
    keep: torch.Tensor
    cap: int


def route(cfg: ArchConfig, mp, xt) -> Routing:
    """Routes the grouped tokens ``xt [G, Tg, d]`` (float32)."""
    G, Tg, _ = xt.shape
    k = cfg.top_k
    logits = cm.mm(xt, mp["router"], cfg.cdtype())           # [G, Tg, E]
    probs = torch.softmax(logits, dim=-1)
    gate, expert = top_k(probs, k)
    gate = gate / torch.clamp_min(gate.sum(dim=-1, keepdim=True), 1e-9)
    flat_e = expert.reshape(G, Tg * k)
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    e_s = torch.gather(flat_e, 1, order)
    g_s = torch.gather(gate.reshape(G, Tg * k), 1, order)
    t_s = torch.div(order, k, rounding_mode="floor")         # token of entry
    seg_start = torch.searchsorted(e_s, e_s, side="left")
    rank = torch.arange(Tg * k, device=xt.device) - seg_start
    cap = capacity(cfg, Tg)
    return Routing(probs, expert, gate, order, e_s, g_s, t_s, rank,
                   rank < cap, cap)


def _expert_mm(a, w, cd):
    """``einsum("gecd,edf->gecf")`` with ``mm``'s policy: operands rounded
    to ``cd``, float32 products."""
    return torch.einsum("gecd,edf->gecf", a.to(cd).to(torch.float32),
                        w.to(cd).to(torch.float32))


def moe_ffn(cfg: ArchConfig, mp, x):
    """x: [B, S, d] float32 -> ([B, S, d] float32, the Switch-style
    load-balance loss)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    G = groups(T)
    Tg = T // G
    xt = x.reshape(G, Tg, d)
    r = route(cfg, mp, xt)

    # aux load-balancing loss (Switch-style, over all groups)
    me = r.probs.mean(dim=(0, 1))                              # [E]
    flat_e = r.expert.reshape(-1)
    ce = torch.zeros((E,), dtype=torch.int64, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e)).to(torch.float32) / (T * k)
    aux = E * torch.sum(me * ce)

    # dispatch: kept entries into [G, E, C, d]; dropped ones go to a dump
    # row past the end of the flat buffer, which is sliced off
    gi = torch.arange(G, device=x.device)[:, None].expand(G, Tg * k)
    n_slots = G * E * r.cap
    slot = torch.where(r.keep, (gi * E + r.e_s) * r.cap + r.rank, n_slots)
    buf = torch.zeros((n_slots + 1, d), dtype=x.dtype, device=x.device)
    buf[slot.reshape(-1)] = xt[gi, r.t_s].reshape(-1, d)
    buf = dctx.constrain(buf[:n_slots].view(G, E, r.cap, d), "moe_buf")

    cd = cfg.cdtype()
    h = cm.swiglu(_expert_mm(buf, mp["w_gate"], cd),
                  _expert_mm(buf, mp["w_up"], cd))
    y = _expert_mm(h, mp["w_down"], cd)                        # [G, E, C, d]
    y = dctx.constrain(y, "moe_buf")           # the all-to-all back

    # combine: each entry's gated output (0 if dropped), back in token
    # order through the inverse permutation, summed over a token's k
    contrib = y[gi, r.e_s, r.rank.clamp(0, r.cap - 1)] * r.g_s[..., None]
    contrib = torch.where(r.keep[..., None], contrib, 0.0)
    inv = torch.empty_like(r.order).scatter_(
        1, r.order, torch.arange(Tg * k, device=x.device).expand(G, -1))
    contrib = torch.gather(contrib, 1, inv[..., None].expand(-1, -1, d))
    out = contrib.reshape(G, Tg, k, d).sum(dim=2)
    return out.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# integration with the transformer stack (pluggable FFN)
# ---------------------------------------------------------------------------
def init_layer_params(cfg: ArchConfig, gen, device="cpu") -> dict:
    """Attention params + MoE params (+ the dense residual FFN of arctic)."""
    p = tfm.init_layer_params(cfg, gen, device)
    if not cfg.dense_residual:
        for name in ("w_gate", "w_up", "w_down"):
            del p[name]
    p["moe"] = init_moe_params(cfg, gen, device)
    return p


def init_params(cfg: ArchConfig, gen, device="cpu") -> dict:
    """Random parameters at ``cfg``'s shapes, drawn from ``gen``."""
    return {
        "emb": cm.dense_init(gen, cfg.vocab, cfg.d_model, cfg.pdtype(),
                             scale=0.02, device=device),
        "layers": [init_layer_params(cfg, gen, device)
                   for _ in range(cfg.n_layers)],
        "ln_f": torch.ones((cfg.d_model,), dtype=cfg.pdtype(), device=device),
    }


def moe_ffn_fn(cfg: ArchConfig, lp, h):
    """FFN hook of ``transformer.layer_forward``: MoE (+ dense residual)."""
    y, aux = moe_ffn(cfg, lp["moe"], h)
    if cfg.dense_residual:
        cd = cfg.cdtype()
        dense = cm.mm(
            cm.swiglu(cm.mm(h, lp["w_gate"], cd), cm.mm(h, lp["w_up"], cd)),
            lp["w_down"], cd)
        y = y + dense
    return y, aux
