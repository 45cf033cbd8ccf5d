"""Dry run of every (architecture x input shape) cell on the production
meshes, and of the paper's simulation round (``repro/launch/dryrun.py``)::

  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k \\
      --mesh single

Each cell's step (an AdamW training step under ``remat`` at lr 1e-4, a
prefill, or a decode step at ``t_pos = seq_len - 1``) runs on the
``meta`` device: shapes and dtypes only, nothing allocated or computed,
so a 480B model at full width runs on a laptop's CPU.  Per cell the
record (``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``) has:

  * ``model_flops``: 6 N D (train) / 2 N D (inference) over the active
    parameters, JAX's formula;
  * ``counted_flops``: the step's matmul operations as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them on ``meta``,
    plus flash attention's (K10's ``meta`` branch adds its products by
    formula, ``attention_flops``), for the whole step on one device;
    ``counted_flops_per_device_even_split`` divides by the chips;
  * ``argument_bytes_per_device``: the step's arguments (parameters, AdamW
    state, batch or token and decode state) under the fitted specs of
    ``distributed/sharding.py``;
  * ``peak_bytes_one_device``: the most bytes the step holds at once on
    one device (arguments included), tracked over the storages it creates
    and frees -- no per-device share is claimed: XLA's temporaries have no
    counterpart;
  * ``collective_bytes_per_device`` and ``collective_breakdown_flat``,
    reckoned by ``comm_analysis.py``.

These are counts of the program, not measurements of a device.

**Depth.**  The layer loops are plain Python, so the JAX package's
``unroll_scans`` has no counterpart; the delta method stays, because the
RWKV6 and Zamba2 time loops at 32k steps make full-depth runs slow.  The
step runs at depths La and Lb (``_depth_pair``) and every count is scaled
to L: ``c_a + (L - La) / (Lb - La) * (c_b - c_a)``.  For the hybrid
family the pair keeps L's remainder modulo the shared block's period, so
the number of shared applications scales exactly too.  Families without
a time loop, and every decode cell, also run at full depth, and then the
full-depth counts are the record's (``method: "full"``); otherwise the
scaled ones are (``method: "delta"``; the peak is then exact only where
one phase of the step holds it at every depth).

Nothing is ever written under ``experiments/dryrun/``: that directory is
the JAX package's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.ctx import sharding_ctx
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.launch import comm_analysis as ca
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.optim import adamw_init

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
META = torch.device("meta")
LR = 1e-4
PAPER_CELLS = ("paper-neuro", "paper-neuro-opt")


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """``meta`` stand-ins for every model input of this cell, in JAX's
    dtypes (int32 ids, bf16 frame and patch stubs)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": meta((B, S), torch.int32)}
        if shape.kind == "train":
            batch["labels"] = meta((B, S), torch.int32)
        if cfg.family == "audio":
            batch["frames"] = meta((B, cfg.enc_frames, cfg.d_model),
                                   torch.bfloat16)
        if cfg.family == "vlm":
            batch["patches"] = meta((B, cfg.n_patches, cfg.d_model),
                                    torch.bfloat16)
        return batch
    return {"token": meta((B, 1), torch.int32),
            "state": lm.make_decode_state(cfg, B, S, device=META)}


def params_meta(cfg: ArchConfig):
    return lm.init_params(cfg, 0, device=META)


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (inference), N = active params."""
    n_total = sum(x.numel() for x in tree_flatten(params_meta(cfg))[0])
    if cfg.n_experts:
        moe_per_layer = 3 * cfg.d_model * cfg.d_ff * cfg.n_experts
        active_moe = 3 * cfg.d_model * cfg.d_ff * cfg.top_k
        n_active = n_total - cfg.n_layers * (moe_per_layer - active_moe)
    else:
        n_active = n_total
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch          # decode: 1 token/seq


def build(cfg: ArchConfig, shape: ShapeConfig, mesh):
    """(fn, args, fitted specs parallel to args) of the cell's step."""
    params = params_meta(cfg)
    fit = lambda spec, tree: shd.fit_specs(spec, tree, mesh)  # noqa: E731
    p_specs = fit(shd.param_specs(cfg, params, mesh), params)
    if shape.kind in ("train", "prefill"):
        batch = input_specs(cfg, shape)
        b_raw = shd.batch_specs(cfg, shape, mesh)
        b_specs = fit({k: b_raw[k] for k in batch}, batch)
        if shape.kind == "prefill":
            return (lambda p, b: lm.prefill(cfg, p, b, device=META),
                    (params, batch), (p_specs, b_specs))
        opt = adamw_init(params)
        o_specs = fit(shd.opt_specs(cfg, opt, mesh), opt)

        def step(p, o, b):
            return lm.train_step(cfg, p, o, b, LR, remat=True, device=META)

        return step, (params, opt, batch), (p_specs, o_specs, b_specs)
    spec = input_specs(cfg, shape)
    s_specs = fit(shd.decode_state_specs(cfg, shape, mesh), spec["state"])
    t_specs = fit(shd.token_spec(cfg, shape, mesh), spec["token"])

    def decode(p, token, state):
        return lm.decode_step(cfg, p, token, state, shape.seq_len - 1,
                              device=META)

    return decode, (params, spec["token"], spec["state"]), \
        (p_specs, t_specs, s_specs)


ARG_NAMES = {"train": ("params", "opt_state", "batch"),
             "prefill": ("params", "batch"),
             "decode": ("params", "token", "state")}


def argument_bytes(kind: str, args, specs, mesh) -> dict:
    """One device's bytes of each argument of ``build``."""
    return {n: shd.shard_bytes(a, s, mesh)
            for n, a, s in zip(ARG_NAMES[kind], args, specs)}


# ---------------------------------------------------------------------------
# one step on meta: operations, live bytes, parameter products
# ---------------------------------------------------------------------------
_MM = {torch.ops.aten.mm.default: 1, torch.ops.aten.bmm.default: 1,
       torch.ops.aten.addmm.default: 2, torch.ops.aten.baddbmm.default: 2}
_COPIES = {torch.ops.aten._to_copy.default, torch.ops.aten.clone.default}


def _key(t) -> int:
    return t.untyped_storage()._cdata


class StepTracker(TorchDispatchMode):
    """Follows the storages a step creates and frees (``peak`` / ``live``
    bytes, starting from the ``held`` tensors), and which 2-d parameter
    leaf feeds the second operand of each matrix product: ``uses`` is
    ``[(leaf index, contracted dim of the leaf, output bytes)]``."""

    def __init__(self, params, held=()):
        super().__init__()
        self.live = self.peak = 0
        self.sizes, self.fins, self.origin, self.uses = {}, {}, {}, []
        for i, p in enumerate(tree_flatten(params)[0]):
            if p.dim() == 2:
                self.origin[_key(p)] = (i, tuple(p.shape))
        for t in tree_flatten(held)[0]:
            if isinstance(t, torch.Tensor):
                self._add(t)

    def _add(self, t):
        s = t.untyped_storage()
        k = s._cdata
        if k in self.sizes:
            return
        self.sizes[k] = s.nbytes()
        self.live += self.sizes[k]
        self.peak = max(self.peak, self.live)
        self.fins[k] = weakref.finalize(s, self._free, k)

    def _free(self, k):
        self.live -= self.sizes.pop(k)
        self.fins.pop(k, None)
        self.origin.pop(k, None)

    def close(self):
        for f in list(self.fins.values()):
            f.detach()
        self.fins.clear()

    def _use(self, mat2, out):
        o = self.origin.get(_key(mat2))
        if o is None:
            return
        i, (a, b) = o
        K, N = mat2.shape[-2:]
        if (K, N) == (a, b) and (a != b or mat2.stride(-1) == 1):
            dim = 0
        elif (K, N) == (b, a):
            dim = 1
        else:
            return
        self.uses.append((i, dim, out.numel() * out.element_size()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _MM:
            self._use(args[_MM[func]], out)
        elif func in _COPIES and isinstance(out, torch.Tensor):
            o = self.origin.get(_key(args[0]))
            if o is not None:
                self.origin[_key(out)] = o
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.device.type == "meta":
                self._add(t)
        return out


def count_step(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """Runs the cell's step once at ``cfg``'s depth: counted operations
    (K10's apart), peak bytes, constraint records and parameter products
    (``uses`` against the flattened parameter leaves ``params``)."""
    fn, args, _ = build(cfg, shape, mesh)
    t0 = time.time()
    tracker = StepTracker(args[0], held=args)
    try:
        with sharding_ctx(mesh) as records, \
                FlopCounterMode(display=False) as fc, \
                attn_ops.count_meta_flops() as k10, tracker:
            out = fn(*args)
            del out
    finally:
        tracker.close()
    attention = k10["forward"] + k10["backward"]
    return {"flops": int(fc.get_total_flops()) + attention,
            "attention_flops": attention, "peak_bytes": tracker.peak,
            "records": list(records), "uses": tracker.uses,
            "params": args[0], "seconds": time.time() - t0}


def _depth_pair(cfg: ArchConfig):
    """(La, Lb): one and two periods of the layer pattern, plus L's
    remainder modulo the period (the hybrid family's shared block)."""
    period = max(cfg.shared_attn_every, 1) if cfg.family == "hybrid" else 1
    r = cfg.n_layers % period
    return period + r, 2 * period + r


def _full_depth(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    """Whether the full-depth step is cheap: no time loop over the
    sequence (recurrent families' train and prefill)."""
    return cfg.family not in ("ssm", "hybrid") or shape.kind == "decode"


def _bdiv(kind: str, args, specs, mesh) -> int:
    """The batch share of a step's products: the devices its token ids
    are split over."""
    tok, spec = (args[1], specs[1]) if kind == "decode" else \
        (args[-1]["tokens"], specs[-1]["tokens"])
    return tok.shape[0] // shd.shard_shape(tuple(tok.shape), spec, mesh)[0]


def collectives(cfg, shape, mesh, count, args, specs) -> dict:
    """The activation terms of one counted step (``count_step``) on
    ``mesh``."""
    p_specs = tree_flatten(shd.fit_specs(shd.param_specs(
        cfg, count["params"], mesh), count["params"], mesh))[0]
    bdiv = _bdiv(shape.kind, args, specs, mesh)
    uses = [(p_specs[i], dim, nb // bdiv) for i, dim, nb in count["uses"]]
    return ca.activation_terms(shape.kind, count["records"], uses, mesh)


def _scale(a, b, La, Lb, L):
    return a + (L - La) * (b - a) / (Lb - La)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             skip_delta: bool = False, cache: dict | None = None) -> dict:
    """One cell's record.  ``cache`` (keyed by arch, shape and depth)
    shares the mesh-free counts between the single and multi meshes."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "kind": shape.kind, "device": "meta",
           "time": time.strftime("%Y-%m-%d %H:%M:%S")}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        rec.update(count_cell(cfg, shape, mesh, skip_delta, cache))
    except Exception as e:                                   # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def count_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
               skip_delta: bool = False, cache: dict | None = None) -> dict:
    """The counted part of a cell's record (``status`` "ok")."""
    cache = {} if cache is None else cache

    def counted(depth):
        key = (cfg.name, shape.name, depth)
        if key not in cache:
            cfg_x = dataclasses.replace(cfg, n_layers=depth)
            cache[key] = count_step(cfg_x, shape, mesh)
        cfg_x = dataclasses.replace(cfg, n_layers=depth)
        _, args, specs = build(cfg_x, shape, mesh)
        c = cache[key]
        return c, collectives(cfg_x, shape, mesh, c, args, specs)

    L = cfg.n_layers
    _, args, specs = build(cfg, shape, mesh)
    arg_bytes = argument_bytes(shape.kind, args, specs, mesh)
    remat = "layers" if shape.kind == "train" and \
        cfg.family in ("dense", "vlm", "moe") else None
    terms = ca.param_terms(shape.kind, args[0], specs[0], mesh, remat)
    out = {"status": "ok", "n_chips": mesh.size,
           "model_flops": model_flops(cfg, shape)}
    full = None
    if skip_delta or _full_depth(cfg, shape):
        full, act = counted(L)
        out.update(method="full", counted_flops=full["flops"],
                   attention_flops=full["attention_flops"],
                   peak_bytes_one_device=full["peak_bytes"])
    if not skip_delta:
        La, Lb = _depth_pair(cfg)
        (ca_, act_a), (cb, act_b) = counted(La), counted(Lb)
        keys = ("flops", "attention_flops", "peak_bytes")
        scaled = {k: _scale(ca_[k], cb[k], La, Lb, L) for k in keys}
        out.update(delta_depths=[La, Lb], delta_raw={
            str(La): {**{k: ca_[k] for k in keys}, "collectives": act_a},
            str(Lb): {**{k: cb[k] for k in keys}, "collectives": act_b}},
            delta_flops=scaled["flops"])
        if full is None:
            act = {k: round(_scale(act_a[k], act_b[k], La, Lb, L))
                   for k in act_a}
            out.update(method="delta", counted_flops=round(scaled["flops"]),
                       attention_flops=round(scaled["attention_flops"]),
                       peak_bytes_one_device=round(scaled["peak_bytes"]))
    terms.update(act)
    out.update(
        counted_flops_per_device_even_split=out["counted_flops"] / mesh.size,
        argument_bytes_per_device=sum(arg_bytes.values()),
        argument_bytes=arg_bytes,
        collective_bytes_per_device=sum(terms.values()),
        collective_breakdown_flat=ca.breakdown(terms),
        collective_terms=terms,
        count_seconds=sum(c["seconds"] for k, c in cache.items()
                          if k[:2] == (cfg.name, shape.name)))
    return out


# ---------------------------------------------------------------------------
# the paper's own workload: one FAP round, 2^20 neurons over every axis
# ---------------------------------------------------------------------------
def paper_round_arguments(model, spec, n_shards: int) -> dict:
    """{name: (shape, dtype)} of the arrays JAX's ``build_fap_round``
    takes, all sharded over every mesh axis (``P(flat)`` on dim 0): the
    BDF state, the dense queue (t, AMPA and GABA weights ``[N, ev_cap]``),
    the edge arrays (pre, post, delay, weights ``[E]``) and the current;
    the allgather transport adds none.  The state's shapes come from one
    lane built on the CPU."""
    from repro_torch.core import bdf
    from repro_torch.core import exec_common as xc
    n, E = spec.n_neurons, spec.n_neurons * spec.k_in
    if n % n_shards or E % n_shards:
        raise ValueError(f"{n} neurons do not split over {n_shards} shards")
    one = bdf.reinit(model, 0.0, xc.batch_init(model, 1),
                     torch.zeros((1,), dtype=torch.float64), bdf.BDFOptions())
    f8, i4 = torch.float64, torch.int32
    out = {f"sts.{k}": ((n,) + tuple(v.shape[1:]), v.dtype)
           for k, v in one._asdict().items()}
    out.update({"eq_t": ((n, spec.ev_cap), f8), "eq_a": ((n, spec.ev_cap), f8),
                "eq_g": ((n, spec.ev_cap), f8), "pre": ((E,), i4),
                "post": ((E,), i4), "delay": ((E,), f8),
                "w_ampa": ((E,), f8), "w_gaba": ((E,), f8),
                "iinj": ((n,), f8)})
    return out


def paper_argument_bytes(model, spec, n_shards: int) -> int:
    """One rank's bytes of :func:`paper_round_arguments`."""
    return sum(math.prod(s) // n_shards * d.itemsize
               for s, d in paper_round_arguments(model, spec,
                                                 n_shards).values())


def run_paper_cell(mesh_kind: str, optimized: bool = False) -> dict:
    """The paper's round (``PaperNeuroSpec``: 2^20 neurons, the
    ``branched_tree(depth=3, seg_per_branch=2)`` cell): each rank's
    argument bytes and the bytes it receives per round and channel.
    ``optimized`` is the shard-local round with the allgather transport,
    else the global round."""
    from repro_torch.core.cell import CellModel
    from repro_torch.core.morphology import branched_tree
    from repro_torch.distributed.fap_spmd import PaperNeuroSpec

    name = PAPER_CELLS[1] if optimized else PAPER_CELLS[0]
    rec = {"arch": name, "shape": "sim_round", "mesh": mesh_kind,
           "kind": "simulation", "time": time.strftime("%Y-%m-%d %H:%M:%S")}
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        model = CellModel(branched_tree(depth=3, seg_per_branch=2),
                          device="cpu")
        spec = PaperNeuroSpec()
        per_round = ca.paper_round_bytes(spec.n_neurons, mesh.size,
                                         optimized)
        rec.update(status="ok", n_chips=mesh.size,
                   argument_bytes_per_device=paper_argument_bytes(
                       model, spec, mesh.size),
                   collective_bytes_per_device=sum(per_round.values()),
                   collective_channel_bytes=per_round,
                   n_neurons=spec.n_neurons, k_in=spec.k_in,
                   n_comp=spec.n_comp)
    except Exception as e:                                   # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def save(rec: dict, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=2)


def run_delta_only(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
                   cache: dict):
    """Recount a cell and merge its depth-delta fields into the record
    on disk (an ``ok`` one)."""
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
    if not os.path.exists(path):
        return
    with open(path) as f:
        rec = json.load(f)
    if rec.get("status") != "ok":
        return
    new = run_cell(arch, shape_name, mesh_kind, cache=cache)
    rec.update({k: v for k, v in new.items()
                if k.startswith("delta") or k == "status"})
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    print(f"[delta] {arch} {shape_name} {mesh_kind} "
          f"flops={rec.get('delta_flops', float('nan')):.3e}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--skip-delta", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--delta-only", action="store_true",
                    help="recount only the depth-delta fields and merge "
                         "them into existing records")
    args = ap.parse_args(argv)
    if os.path.basename(os.path.normpath(args.out)) == "dryrun":
        raise SystemExit("experiments/dryrun/ holds the JAX package's "
                         "records; write elsewhere")

    archs = sorted(ARCHS) + list(PAPER_CELLS) if args.arch == "all" \
        else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cache: dict = {}
    for mesh_kind in meshes:
        for arch in archs:
            if arch in PAPER_CELLS:
                path = os.path.join(args.out,
                                    f"{arch}__sim_round__{mesh_kind}.json")
                if args.skip_existing and os.path.exists(path):
                    continue
                rec = run_paper_cell(mesh_kind,
                                     optimized=arch.endswith("-opt"))
                save(rec, args.out)
                print(f"[{rec['status']}] {arch} sim_round {mesh_kind} "
                      f"{rec.get('error', '')[:80]}", flush=True)
                continue
            for shape_name in shapes:
                if args.delta_only:
                    run_delta_only(arch, shape_name, mesh_kind, args.out,
                                   cache)
                    continue
                path = os.path.join(
                    args.out, f"{arch}__{shape_name}__{mesh_kind}.json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") in ("ok", "skipped"):
                            print(f"[skip existing] {arch} {shape_name} "
                                  f"{mesh_kind}")
                            continue
                t0 = time.time()
                rec = run_cell(arch, shape_name, mesh_kind,
                               skip_delta=args.skip_delta, cache=cache)
                save(rec, args.out)
                extra = rec.get("reason", rec.get("error", ""))[:80]
                print(f"[{rec['status']}] {arch} {shape_name} {mesh_kind} "
                      f"({time.time() - t0:.0f}s) {extra}", flush=True)


if __name__ == "__main__":
    main()
