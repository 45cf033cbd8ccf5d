"""AdamW with global-norm clipping, a warmup-stable-decay schedule and the
stochastic int8 gradient-compression hooks (``repro/optim/adamw.py``).

The JAX package's formulas, written out rather than ``torch.optim.AdamW``
(whose weight decay is applied before the moment update and whose bias
correction is folded into the step size, so its last bits differ).  As
in JAX, the step count is an int32 tensor and ``b1 ** t``, ``b2 ** t``,
the schedule and the learning rate are float32 tensors: Python doubles
would round otherwise.  Trees are ``torch.utils._pytree`` trees (the
port's parameter dicts with their per-layer lists); the moments mirror
the parameters' structure in float32, and each updated parameter is cast
back to its own dtype.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor            # int32 scalar
    mu: Any
    nu: Any


def _f32(x, device):
    return torch.as_tensor(x, dtype=F32, device=device)


def adamw_init(params) -> AdamWState:
    leaves = tree_flatten(params)[0]
    device = leaves[0].device if leaves else "cpu"

    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def clip_by_global_norm(grads, max_norm: float):
    """(grads * min(1, max_norm / max(|g|, 1e-9)), |g|): the global norm
    over every leaf in float32, each leaf's sum of squares added in the
    tree's order."""
    leaves, spec = tree_flatten(grads)
    sq = _f32(0.0, leaves[0].device)
    for g in leaves:
        sq = sq + torch.sum(torch.square(g.to(F32)))
    gn = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp_min(gn, 1e-9), max=1.0)
    return tree_unflatten([g * scale for g in leaves], spec), gn


def wsd_schedule(step, peak_lr: float, warmup: int = 100,
                 total: int = 10000, decay_frac: float = 0.1):
    """Warmup -> stable -> linear decay, a float32 tensor of ``step`` (an
    int, or a tensor whose device it keeps)."""
    step = torch.as_tensor(step).to(F32)
    w = torch.clamp(step / max(warmup, 1), max=1.0)
    decay_start = total * (1.0 - decay_frac)
    d = torch.clamp((total - step) / max(total - decay_start, 1.0), 0.0, 1.0)
    return peak_lr * w * d


def adamw_update(grads, state: AdamWState, params, lr,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    """One AdamW step: (new params, new state).  ``lr`` a float or a float32
    tensor."""
    step = state.step + 1
    t = step.to(F32)
    bc1 = 1.0 - torch.pow(_f32(b1, t.device), t)
    bc2 = 1.0 - torch.pow(_f32(b2, t.device), t)
    lr = _f32(lr, t.device)

    def upd(g, m, v, p):
        g = g.to(F32)
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        p32 = p.to(F32)
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32
        return m, v, (p32 - lr * delta).to(p.dtype)

    flat_g, spec = tree_flatten(grads)
    out = [upd(g, m, v, p) for g, m, v, p in
           zip(flat_g, tree_flatten(state.mu)[0], tree_flatten(state.nu)[0],
               tree_flatten(params)[0])]
    mu, nu, new_p = (tree_unflatten([o[i] for o in out], spec)
                     for i in range(3))
    return new_p, AdamWState(step=step, mu=mu, nu=nu)


# ---------------------------------------------------------------------------
# gradient compression (cross-pod DCN payload reduction)
# ---------------------------------------------------------------------------
def compress_stochastic_int8(g, generator=None):
    """Stochastic-rounding int8 quantisation: returns (q, scale).  The
    rounding noise is uniform in [-0.5, 0.5), drawn from ``generator`` (a
    ``torch.Generator`` on g's device) where JAX takes a key."""
    scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
    x = g / scale
    noise = torch.rand(g.shape, generator=generator, dtype=F32,
                       device=g.device) - 0.5
    q = torch.clamp(torch.round(x + noise), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale):
    return q.to(F32) * scale
