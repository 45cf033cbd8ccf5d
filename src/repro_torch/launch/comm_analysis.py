"""Collective bytes of one step of a dry-run cell, reckoned per device
(the counterpart of ``repro/launch/hlo_analysis.py``).

The JAX package compiles each cell for its mesh and reads the collectives
XLA inserted out of the HLO text.  A torch program has no HLO and no
compiler choosing collectives, so nothing is parsed here: the bytes are
reckoned from the fitted sharding specs (``distributed/sharding.py``),
the activation constraints the models record (``distributed/ctx.py``)
and the parameter products the dry run observes, under
``hlo_analysis``'s convention -- each collective counts the bytes of its
result on one device.  A collective over mesh axes of total size 1 moves
nothing and counts 0.  The terms, each under its own key:

  fsdp_all_gather        every parameter leaf sharded over the data axes,
                         gathered to its model-axis shard once a forward;
  fsdp_all_gather_remat  the same again for the leaves of layers that a
                         training step recomputes under ``remat``;
  grad_reduce_scatter    (train) each such leaf's gradient, to its shard;
  grad_all_reduce        (train) the gradients of the leaves replicated
                         over the data axes;
  sp_all_gather,         at each change between the ``residual`` (sequence
  sp_reduce_scatter      over ``model``) and ``tokens3d`` records of a
                         forward, and its transpose in the backward;
  tp_all_reduce          each product that contracts a parameter dim
                         sharded over ``model`` (row-parallel outputs, and
                         the column-parallel inputs' gradients), forward,
                         recomputed forward and backward alike, the
                         output's batch share;
  moe_all_to_all         each ``moe_buf`` record (forward and recomputed),
                         and one in the backward per forward record.

``collective_breakdown_flat`` sums the terms by opcode, under
``hlo_analysis``'s keys.  XLA picks its own collectives, so these are a
reckoning of what the specs imply, not a prediction of XLA's bytes.

The per-channel attribution of the paper's round (``hlo_analysis.
collective_channel_bytes``) has its counterpart in the counters of
``distributed/group.py``, which count the bytes each collective delivers
to a rank in a real run; :func:`paper_round_bytes` reckons the same
bytes for one round from the transport's buffer shapes.
"""
from __future__ import annotations

import math

from torch.utils._pytree import tree_flatten_with_path

from repro_torch.distributed import ctx as dctx
from repro_torch.distributed.sharding import (P, _axes, _fit_one,
                                              mesh_axes, shard_shape)

OPCODES = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")
TERMS = {"fsdp_all_gather": "all-gather",
         "fsdp_all_gather_remat": "all-gather",
         "grad_reduce_scatter": "reduce-scatter",
         "grad_all_reduce": "all-reduce",
         "sp_all_gather": "all-gather",
         "sp_reduce_scatter": "reduce-scatter",
         "tp_all_reduce": "all-reduce",
         "moe_all_to_all": "all-to-all"}


def _size(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def _spec_axes(spec) -> set:
    return {a for e in spec for a in _axes(e)}


def _drop(spec, axes) -> P:
    """``spec`` without the mesh axes ``axes``."""
    out = []
    for e in spec:
        kept = tuple(a for a in _axes(e) if a not in axes)
        out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
    return P(*out)


def _bytes(shape, dtype, spec, mesh) -> int:
    return math.prod(shard_shape(tuple(shape), spec, mesh)) * dtype.itemsize


def param_terms(kind: str, params, p_specs, mesh, remat_prefix=None) -> dict:
    """The parameter terms: FSDP gathers and gradient reductions.
    ``p_specs`` are fitted; ``remat_prefix`` names the subtree whose
    leaves a training step recomputes (``"layers"`` under ``remat``)."""
    dp, _ = mesh_axes(mesh)
    out = dict.fromkeys(("fsdp_all_gather", "fsdp_all_gather_remat",
                         "grad_reduce_scatter", "grad_all_reduce"), 0)
    leaves = tree_flatten_with_path(params)[0]
    specs = [s for _, s in tree_flatten_with_path(
        p_specs, is_leaf=lambda x: isinstance(x, P))[0]]
    for (path, x), spec in zip(leaves, specs):
        data = [a for a in _spec_axes(spec) if a in dp]
        shard = _bytes(x.shape, x.dtype, spec, mesh)
        if _size(mesh, data) > 1:
            gathered = _bytes(x.shape, x.dtype, _drop(spec, data), mesh)
            out["fsdp_all_gather"] += gathered
            if kind == "train":
                out["grad_reduce_scatter"] += shard
                head = getattr(path[0], "key", None)
                if remat_prefix is not None and head == remat_prefix:
                    out["fsdp_all_gather_remat"] += gathered
        elif kind == "train" and _size(mesh, dp) > 1:
            out["grad_all_reduce"] += shard
    return out


def _fitted(rec, mesh):
    dp, tp = mesh_axes(mesh)
    return _fit_one(dctx._specs(dp, tp)[rec.kind], rec.shape, mesh)


def activation_terms(kind: str, records, tp_uses, mesh) -> dict:
    """The activation terms from a step's constraint records
    (``ctx.Constraint``, fitted here for ``mesh``) and its parameter
    products: ``tp_uses`` is ``[(spec, dim, out_bytes)]`` -- the fitted
    spec of the parameter, the contracted dim of it and the product's
    bytes on one device (its batch share)."""
    _, tp = mesh_axes(mesh)
    out = dict.fromkeys(("sp_all_gather", "sp_reduce_scatter",
                         "tp_all_reduce", "moe_all_to_all"), 0)
    if mesh.shape[tp] <= 1:
        return out
    fwd = [r for r in records if not r.in_backward]

    def nbytes(r):
        return _bytes(r.shape, r.dtype, _fitted(r, mesh), mesh)

    sp = {"residual", "tokens3d"}
    for a, b in zip(fwd, fwd[1:]):
        if a.kind != b.kind and {a.kind, b.kind} == sp:
            into = "sp_reduce_scatter" if b.kind == "residual" \
                else "sp_all_gather"
            out[into] += nbytes(b)
            if kind == "train":            # the transpose in the backward
                back = "sp_all_gather" if into == "sp_reduce_scatter" \
                    else "sp_reduce_scatter"
                out[back] += nbytes(a)
    for r in records:
        if r.kind == "moe_buf":
            out["moe_all_to_all"] += nbytes(r) * (
                2 if kind == "train" and not r.in_backward else 1)
    for spec, dim, out_bytes in tp_uses:
        if dim < len(spec) and tp in _axes(spec[dim]):
            out["tp_all_reduce"] += out_bytes
    return out


def breakdown(terms: dict) -> dict:
    """The terms summed by opcode (``collective_breakdown_flat``'s keys;
    an opcode with no bytes is left out, as in JAX's)."""
    flat = {}
    for name, b in terms.items():
        if b:
            flat[TERMS[name]] = flat.get(TERMS[name], 0) + b
    return flat


# ---------------------------------------------------------------------------
# the paper's round: bytes a rank receives per channel
# ---------------------------------------------------------------------------
def paper_round_bytes(n_neurons: int, n_shards: int, optimized: bool,
                      transport: str = "allgather", parcel_cap: int = 64,
                      frontier: int = 0) -> dict:
    """Bytes each rank receives in one call of ``distributed.fap_spmd``'s
    round, by channel tag -- what ``Group.counters()`` counts: the global
    round gathers every clock (f64) and every (spiked, t_spike) pair (1 + 8
    bytes); the shard-local round's ``allgather`` transport the same under
    its own tags; ``sparse`` gathers ``n_shards * frontier`` boundary
    clocks and exchanges ``n_shards * parcel_cap`` (id i32, time f64)
    parcel slots.  Each round also sums three int64 counts (``other``).
    ``sparse_ragged`` sizes its parcels per round from the activity and is
    not reckoned here."""
    from repro_torch.distributed.exchange import (NOTIFY_TAG, PARCEL_TAG)
    from repro_torch.distributed.fap_spmd import (CLOCKS_TAG, OTHER_TAG,
                                                  SPIKES_TAG)
    n = int(n_neurons)
    out = {OTHER_TAG: 3 * 8}
    if not optimized:
        out.update({CLOCKS_TAG: n * 8, SPIKES_TAG: n * (1 + 8)})
    elif transport == "allgather":
        out.update({NOTIFY_TAG: n * 8, PARCEL_TAG: n * (1 + 8)})
    elif transport == "sparse":
        out.update({NOTIFY_TAG: n_shards * int(frontier) * 8,
                    PARCEL_TAG: n_shards * int(parcel_cap) * (4 + 8)})
    else:
        raise ValueError(f"transport {transport!r} is not reckoned")
    return out
