"""Activation-sharding context (``repro/distributed/ctx.py``).

Model code calls ``constrain(x, "residual")`` etc. at the JAX package's
places.  Outside a sharding context this returns ``x`` and does nothing
else.  Inside ``sharding_ctx(mesh)`` it still returns ``x`` unchanged --
a torch program runs on one device, there is no ``with_sharding_constraint``
to apply -- and records ``Constraint(kind, shape, dtype, spec,
in_backward)`` with the spec fitted to ``x``'s shape, for the dry run's
collective reckoning (``launch/comm_analysis.py``): sequence parallelism
on the residual stream, batch sharding on token streams, expert sharding
on the MoE buffers.  ``in_backward`` marks a record made while autograd
runs a backward pass (a forward recomputed under ``remat``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch

from repro_torch.distributed.sharding import P, _fit_one, mesh_axes

_state = threading.local()


def _specs(dp, tp) -> dict:
    """dp: the tuple of data axes (('pod', 'data') or ('data',)); tp:
    'model'."""
    return {
        # [B, S, d] residual stream: batch over dp, sequence over tp (SP)
        "residual": P(dp, tp, None),
        # [B, S, d] without SP (pre-attention gathered form)
        "tokens3d": P(dp, None, None),
        # [B, S] token ids
        "tokens": P(dp, None),
        # [B, 1, d] decode hidden
        "decode_hidden": P(dp, None, None),
        # MoE dispatch buffer [G, E, C, d]: groups over data, experts over
        # model -- the transition between the two is the MoE all-to-all
        "moe_buf": P(dp, tp, None, None),
        # attention heads [B, S, H, hd]
        "heads": P(dp, None, tp, None),
    }


class Constraint(NamedTuple):
    kind: str
    shape: tuple
    dtype: torch.dtype
    spec: P                  # fitted to ``shape``
    in_backward: bool


class _Ctx(NamedTuple):
    mesh: object
    specs: dict
    records: list


@contextlib.contextmanager
def sharding_ctx(mesh):
    """Record activation constraints for a (pod,) data, model mesh
    (``launch.mesh.Mesh``); yields the list the records go to."""
    dp, tp = mesh_axes(mesh)
    prev = getattr(_state, "ctx", None)
    _state.ctx = _Ctx(mesh, _specs(dp, tp), [])
    try:
        yield _state.ctx.records
    finally:
        _state.ctx = prev


def constrain(x, kind: str):
    """``x``, unchanged; inside ``sharding_ctx`` the constraint is
    recorded (a spec longer than ``x.dim()`` is skipped, as in JAX)."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None or kind not in ctx.specs:
        return x
    spec = ctx.specs[kind]
    if len(spec) > x.dim():
        return x
    shape = tuple(x.shape)
    ctx.records.append(Constraint(
        kind, shape, x.dtype, _fit_one(spec, shape, ctx.mesh),
        torch._C._current_graph_task_id() != -1))
    return x
