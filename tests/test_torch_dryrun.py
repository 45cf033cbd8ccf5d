"""The port's dry run (``repro_torch.launch.dryrun``), activation
constraints (``distributed/ctx.py``) and collective reckoning
(``launch/comm_analysis.py``) against the JAX package, on the CPU.

* counted operations: outside attention, the port's ``counted_flops`` of
  the six reduced archs of ``tests/test_dryrun_small.py`` in the train,
  prefill and decode cells equal the ``dot_general`` operations of
  ``jax.make_jaxpr`` of JAX's step, exactly (scan bodies times their
  length, ``checkpoint`` and ``custom_vjp`` sub-jaxprs followed).  The
  attention products are named on each side: JAX's are the dots issued
  from ``repro/models/attention.py`` (its jnp path, every chunk against
  all S columns, the checkpointed chunk recomputed in the backward), the
  port's K10's ``meta`` formula; in the prefill and decode cells they are
  equal too, in the train cells both go to the junit record;
* K10's ``meta`` formula equals ``FlopCounterMode``'s count of its plain
  version on the CPU at ragged and GQA shapes, forward and backward;
* the delta method, scaled from depths La and Lb, equals a full-depth
  count exactly on a small config of each family;
* the constraint records of a reduced forward of each family are JAX's
  kinds at JAX's places and shapes (JAX traced under ``jax.disable_jit``,
  where its scans loop, with its ``constrain`` recording); outside a
  context the calls change no output bit, and the MoE dispatch and the
  RWKV6 / Mamba2 outer products (rewritten so that the ``meta`` device
  and the counter see them) give the bits of the forms they replaced;
* collectives: 0 on a (1, 1) mesh, above 0 in every train cell on (4, 2),
  every FSDP and gradient term the sum of its leaves' shards; JAX's
  compiled ``collective_bytes`` on (4, 2) of three reduced train cells go
  to the junit record beside the port's (``record_property``), unbounded.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.utils._pytree import tree_flatten_with_path  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.distributed import ctx as j_ctx  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import ctx as t_ctx  # noqa: E402
from repro_torch.distributed import sharding as t_shd  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.attention import ref as attn_ref  # noqa: E402
from repro_torch.launch import comm_analysis as ca  # noqa: E402
from repro_torch.launch import dryrun as t_dry  # noqa: E402
from repro_torch.launch.mesh import make_mesh_compat  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models import zamba2  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ["smollm-135m", "qwen3-moe-30b-a3b", "rwkv6-7b", "zamba2-7b",
         "whisper-base", "internvl2-1b"]          # tests/test_dryrun_small.py
SHAPES = {k: ShapeConfig(k[0], 64, 8, k) for k in
          ("train", "prefill", "decode")}
MESH42 = make_mesh_compat((4, 2), ("data", "model"))
MESH11 = make_mesh_compat((1, 1), ("data", "model"))
COMPILED = ["smollm-135m", "qwen3-moe-30b-a3b", "whisper-base"]

JAX_COMPILE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.distributed.ctx import sharding_ctx
from repro.launch import dryrun
from repro.launch.hlo_analysis import collective_bytes
from repro.launch.mesh import make_mesh_compat

mesh = make_mesh_compat((4, 2), ("data", "model"))
out = {}
for arch in ARCHS:
    cfg = get_config(arch).reduced()
    fn, args, sh = dryrun.build(cfg, ShapeConfig("t", 64, 8, "train"), mesh)
    with sharding_ctx(mesh):
        compiled = jax.jit(fn, in_shardings=sh).lower(*args).compile()
    out[arch] = int(collective_bytes(compiled.as_text())[0])
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_compiled():
    """JAX's compiled train cells on eight host devices, started first so
    that it runs beside the module's other tests."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    script = JAX_COMPILE.replace("ARCHS", repr(COMPILED))
    p = subprocess.Popen([sys.executable, "-c", script], env=env, cwd=ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    yield p
    if p.poll() is None:
        p.kill()


@pytest.fixture(scope="module")
def counts(jax_compiled):
    """The port's counted cells (full depth) on the (4, 2) and (1, 1)
    meshes, sharing the mesh-free counts."""
    cache, out = {}, {}
    for arch in ARCHS:
        cfg = t_configs.get_config(arch).reduced()
        for kind, shape in SHAPES.items():
            for name, mesh in (("4x2", MESH42), ("1x1", MESH11)):
                out[arch, kind, name] = t_dry.count_cell(
                    cfg, shape, mesh, skip_delta=True, cache=cache)
    return out


# ---------------------------------------------------------------------------
# JAX's dot operations, from the jaxpr
# ---------------------------------------------------------------------------
def _sub_jaxprs(v):
    for x in (v if isinstance(v, (tuple, list)) else (v,)):
        if hasattr(x, "eqns"):
            yield x
        elif hasattr(getattr(x, "jaxpr", None), "eqns"):
            yield x.jaxpr


def _dots(jaxpr, mult=1):
    """(all dot_general operations, those issued from
    ``repro/models/attention.py``): 2 x output size x contracted size,
    scan bodies counted ``length`` times."""
    total = attn = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            ls = eqn.invars[0].aval.shape
            f = mult * 2 * math.prod(eqn.outvars[0].aval.shape) * \
                math.prod(ls[i] for i in lc)
            total += f
            tb = eqn.source_info.traceback
            if tb is not None and any("models/attention.py" in fr.file_name
                                      for fr in tb.frames):
                attn += f
        m = mult * (eqn.params["length"] if eqn.primitive.name == "scan"
                    else 1)
        for v in eqn.params.values():
            for sub in _sub_jaxprs(v):
                a, b = _dots(sub, m)
                total, attn = total + a, attn + b
    return total, attn


def _jax_step_dots(arch, kind):
    from jax.sharding import AbstractMesh
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as j_dry     # sets XLA_FLAGS for itself
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    cfg = j_configs.get_config(arch).reduced()
    shape = j_configs.base.ShapeConfig(kind[0], 64, 8, kind)
    fn, args, _ = j_dry.build(cfg, shape, AbstractMesh((4, 2),
                                                       ("data", "model")))
    return _dots(jax.make_jaxpr(fn)(*args).jaxpr)


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_counted_flops_match_jax_dots(counts, arch, kind, record_property):
    jax.devices()
    j_total, j_attn = _jax_step_dots(arch, kind)
    rec = counts[arch, kind, "4x2"]
    t_attn = rec["attention_flops"]
    record_property("jax_attention_flops", j_attn)
    record_property("port_attention_flops", t_attn)
    assert rec["counted_flops"] - t_attn == j_total - j_attn, \
        (rec["counted_flops"] - t_attn, j_total - j_attn)
    if kind != "train":
        assert t_attn == j_attn
    assert (t_attn > 0) == (arch != "rwkv6-7b")


# ---------------------------------------------------------------------------
# K10's meta formula against its plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal", [
    (2, 4, 2, 37, 53, 16, True), (1, 6, 3, 29, 29, 64, True),
    (3, 4, 4, 1, 77, 16, True), (2, 8, 2, 21, 45, 16, False)])
def test_k10_meta_formula_counts_the_plain_version(B, H, Hkv, Sq, Skv, D,
                                                   causal):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g) for s in
               ((B, H, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))
    with FlopCounterMode(display=False) as fc:
        o = attn_ref.flash_attention_ref(q, k, v, causal)
    fwd = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        attn_ref.flash_attention_bwd_ref(q, k, v, o, torch.randn_like(o),
                                         causal)
    bwd = fc.get_total_flops()
    m = [x.to("meta") for x in (q, k, v)]
    with attn_ops.count_meta_flops() as c:
        om = attn_ops._forward(*m, causal, None, None, torch.float32)
        dq, dk, dv = attn_ops.flash_attention_bwd(*m, om, om, causal)
    assert c == {"forward": fwd, "backward": bwd}
    assert fwd == attn_ops.FWD_PRODUCTS * 2 * B * H * Sq * Skv * D
    # the kernels' shapes and layouts: [B, S, H, D] storage as [B, H, S, D]
    assert om.shape == q.shape and om.stride()[1] == D
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert dk.stride()[1] == D


# ---------------------------------------------------------------------------
# the delta method against full depth
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,n_layers", [
    ("smollm-135m", 5), ("qwen3-moe-30b-a3b", 4), ("rwkv6-7b", 4),
    ("zamba2-7b", 7), ("whisper-base", 4), ("internvl2-1b", 4)])
def test_delta_method_equals_full_depth(arch, n_layers):
    cfg = dataclasses.replace(t_configs.get_config(arch).reduced(),
                              n_layers=n_layers)
    La, Lb = t_dry._depth_pair(cfg)
    assert La < Lb < n_layers
    for kind in ("train", "decode"):
        shape = ShapeConfig(kind, 16, 4, kind)
        got = {}
        for depth in (La, Lb, n_layers):
            cfg_x = dataclasses.replace(cfg, n_layers=depth)
            c = t_dry.count_step(cfg_x, shape, MESH42)
            _, args, specs = t_dry.build(cfg_x, shape, MESH42)
            got[depth] = (c["flops"], c["attention_flops"],
                          t_dry.collectives(cfg_x, shape, MESH42, c, args,
                                            specs))
        for i in range(2):
            assert t_dry._scale(got[La][i], got[Lb][i], La, Lb, n_layers) \
                == got[n_layers][i], (kind, i)
        for term, v in got[n_layers][2].items():
            assert t_dry._scale(got[La][2][term], got[Lb][2][term], La, Lb,
                                n_layers) == v, (kind, term)


def test_depth_pair_keeps_the_shared_block_count():
    """zamba2-7b: 81 layers, a shared block every 6: JAX's pair (6, 12)
    would scale to 13.5 applications; (9, 15) scales to its 13."""
    cfg = t_configs.get_config("zamba2-7b")
    La, Lb = t_dry._depth_pair(cfg)
    assert (La, Lb) == (9, 15)
    apps = {L: sum(a is not None for *_, a in zamba2._segments(
        dataclasses.replace(cfg, n_layers=L))) for L in (La, Lb, 81)}
    assert t_dry._scale(apps[La], apps[Lb], La, Lb, 81) == apps[81] == 13
    assert t_dry._depth_pair(t_configs.get_config("qwen2-72b")) == (1, 2)


# ---------------------------------------------------------------------------
# constraint records at JAX's places
# ---------------------------------------------------------------------------
def _batch(cfg, B=2, S=8, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return b


@pytest.mark.parametrize("arch", ARCHS)
def test_constrain_records_match_jax(arch, monkeypatch):
    jcfg = j_configs.get_config(arch).reduced()
    tcfg = t_configs.get_config(arch).reduced()
    batch = _batch(jcfg)
    seen = []

    def record(x, kind):
        seen.append((kind, tuple(x.shape)))
        return x

    monkeypatch.setattr(j_ctx, "constrain", record)
    jp = jax.eval_shape(lambda: j_lm.init_params(jcfg, jax.random.PRNGKey(0)))
    with jax.disable_jit():                # scans loop: a record per layer
        jax.make_jaxpr(lambda p, b: j_lm.forward_hidden(jcfg, p, b))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = t_lm.init_params(tcfg, 0, device="cpu")
    tb = interop.batch_from_numpy(batch, "cpu")
    plain, _ = t_lm.forward_hidden(tcfg, tp, tb, device="cpu")
    with t_ctx.sharding_ctx(MESH42) as records:
        inside, _ = t_lm.forward_hidden(tcfg, tp, tb, device="cpu")
    assert [(r.kind, r.shape) for r in records] == seen
    assert not any(r.in_backward for r in records)
    assert torch.equal(plain, inside)
    if arch != "whisper-base":
        assert records


def test_constrain_outside_a_context_is_the_identity():
    x = torch.randn(4, 6, 3)
    assert getattr(t_ctx._state, "ctx", None) is None
    assert t_ctx.constrain(x, "residual") is x
    with t_ctx.sharding_ctx(MESH42) as records:
        assert t_ctx.constrain(x, "residual") is x
        t_ctx.constrain(x[0], "moe_buf")          # spec longer: skipped
    assert [(r.kind, tuple(r.spec)) for r in records] == \
        [("residual", ("data", "model", None))]
    assert getattr(t_ctx._state, "ctx", None) is None


def test_moe_dispatch_and_outer_products_keep_their_bits():
    """The fixed-shape MoE dispatch (a dump row for dropped entries) and
    the outer products as matmuls give the bits of the masked-index
    dispatch and of the broadcast products they replaced."""
    from repro_torch.models import moe
    cfg = dataclasses.replace(t_configs.get_config(
        "qwen3-moe-30b-a3b").reduced(), capacity_factor=0.5)
    mp = t_lm.init_params(cfg, 0, device="cpu")["layers"][0]["moe"]
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 32, cfg.d_model, generator=g)
    B, S, d = x.shape
    G = moe.groups(B * S)
    xt = x.reshape(G, -1, d)
    r = moe.route(cfg, mp, xt)
    assert not bool(r.keep.all())                 # some entries drop
    gi = torch.arange(G)[:, None].expand_as(r.e_s)
    gk, ek, sk, tk = (a[r.keep] for a in (gi, r.e_s, r.rank, r.t_s))
    old = torch.zeros((G, cfg.n_experts, r.cap, d))
    old[gk, ek, sk] = xt[gk, tk]
    with t_ctx.sharding_ctx(MESH42) as records:
        y, aux = moe.moe_ffn(cfg, mp, x)
    cd = cfg.cdtype()
    yo = moe._expert_mm(torch.nn.functional.silu(moe._expert_mm(
        old, mp["w_gate"], cd)) * moe._expert_mm(old, mp["w_up"], cd),
        mp["w_down"], cd)
    contrib = yo[gi, r.e_s, r.rank.clamp(0, r.cap - 1)] * r.g_s[..., None]
    contrib = torch.where(r.keep[..., None], contrib, 0.0)
    inv = torch.empty_like(r.order).scatter_(
        1, r.order, torch.arange(r.order.shape[1]).expand(G, -1))
    contrib = torch.gather(contrib, 1, inv[..., None].expand(-1, -1, d))
    want = contrib.reshape(G, -1, cfg.top_k, d).sum(dim=2).reshape(B, S, d)
    assert torch.equal(y, want)
    assert [rec.kind for rec in records] == ["moe_buf", "moe_buf"]
    assert records[0].shape == tuple(old.shape)
    ce = torch.bincount(r.expert.reshape(-1), minlength=cfg.n_experts)
    assert torch.equal(aux, cfg.n_experts * torch.sum(
        r.probs.mean(dim=(0, 1)) * (ce.to(torch.float32) /
                                    (B * S * cfg.top_k))))
    a, b = torch.randn(8, 3, 64, generator=g), torch.randn(8, 3, 64,
                                                           generator=g)
    assert torch.equal(torch.matmul(a[..., :, None], b[..., None, :]),
                       a[..., :, None] * b[..., None, :])
    c = torch.randn(8, 16, generator=g)
    assert torch.equal(torch.matmul(c[:, None, :, None], b[:, :, None, :]),
                       c[:, None, :, None] * b[:, :, None, :])


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def test_collectives_zero_on_one_device_and_positive_in_train(counts):
    for (arch, kind, mesh), rec in counts.items():
        if mesh == "1x1":
            assert rec["collective_bytes_per_device"] == 0, (arch, kind)
            assert rec["collective_breakdown_flat"] == {}
        elif kind == "train":
            assert rec["collective_bytes_per_device"] > 0, arch
            flat = rec["collective_breakdown_flat"]
            assert sum(flat.values()) == rec["collective_bytes_per_device"]
            assert set(flat) <= set(ca.OPCODES)


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_terms_sum_their_leaves_shards(counts, arch):
    cfg = t_configs.get_config(arch).reduced()
    _, args, specs = t_dry.build(cfg, SHAPES["train"], MESH42)
    data = gathered = grads = layers = 0
    for (path, x), (_, s) in zip(
            tree_flatten_with_path(args[0])[0],
            tree_flatten_with_path(specs[0],
                                   is_leaf=lambda v: isinstance(v, t_shd.P))
            [0]):
        axes = [a for e in s if e is not None
                for a in (e if isinstance(e, tuple) else (e,))]
        n_data = math.prod(MESH42.shape[a] for a in axes if a == "data")
        shard = math.prod(t_shd.shard_shape(tuple(x.shape), s, MESH42)) * \
            x.dtype.itemsize
        if n_data > 1:
            gathered += shard * n_data
            grads += shard
            if path[0].key == "layers" and cfg.family in ("dense", "vlm",
                                                          "moe"):
                layers += shard * n_data
        else:
            data += shard
    terms = counts[arch, "train", "4x2"]["collective_terms"]
    assert terms["fsdp_all_gather"] == gathered > 0
    assert terms["grad_reduce_scatter"] == grads
    assert terms["fsdp_all_gather_remat"] == layers
    assert terms["grad_all_reduce"] == data
    for kind in ("prefill", "decode"):
        t = counts[arch, kind, "4x2"]["collective_terms"]
        assert t["fsdp_all_gather"] == gathered
        assert t["grad_reduce_scatter"] == t["grad_all_reduce"] == 0


def test_compiled_jax_collectives_beside_the_port(counts, jax_compiled,
                                                  record_property):
    out, err = jax_compiled.communicate(timeout=600)
    assert jax_compiled.returncode == 0, err[-3000:]
    compiled = json.loads(out.strip().splitlines()[-1])
    for arch in COMPILED:
        port = counts[arch, "train", "4x2"]["collective_bytes_per_device"]
        record_property(f"{arch}_jax_compiled_collective_bytes",
                        compiled[arch])
        record_property(f"{arch}_port_reckoned_collective_bytes", port)
        assert compiled[arch] > 0 and port > 0


def test_paper_round_reckoning():
    from repro_torch.distributed.fap_spmd import PaperNeuroSpec
    rb = ca.paper_round_bytes(1 << 20, 256, optimized=False)
    assert rb == {"other": 24, "global_clocks": 8 << 20,
                  "global_spikes": 9 << 20}
    assert ca.paper_round_bytes(64, 4, True) == {
        "other": 24, "exchange_notify": 512, "exchange_parcel": 576}
    assert ca.paper_round_bytes(64, 4, True, "sparse", 8, 5) == {
        "other": 24, "exchange_notify": 4 * 5 * 8,
        "exchange_parcel": 4 * 8 * 12}
    with pytest.raises(ValueError):
        ca.paper_round_bytes(64, 4, True, "sparse_ragged")
    rec = t_dry.run_paper_cell("single", optimized=True)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_chips"] == 256 and rec["n_neurons"] == PaperNeuroSpec().n_neurons
    assert rec["argument_bytes_per_device"] > 0
    assert rec["collective_channel_bytes"]["exchange_notify"] == 8 << 20


def test_cli_writes_records_outside_the_jax_directory(tmp_path):
    t_dry.main(["--arch", "smollm-135m,paper-neuro", "--shape",
                "decode_32k,long_500k", "--mesh", "single", "--out",
                str(tmp_path), "--skip-delta"])
    names = sorted(os.listdir(tmp_path))
    assert names == ["paper-neuro__sim_round__single.json",
                     "smollm-135m__decode_32k__single.json",
                     "smollm-135m__long_500k__single.json"]
    recs = {n: json.load(open(tmp_path / n)) for n in names}
    assert recs[names[1]]["status"] == "ok"
    assert recs[names[2]]["status"] == "skipped"
    with pytest.raises(SystemExit):
        t_dry.main(["--out", str(tmp_path / "experiments" / "dryrun")])


def test_lm_step_path_has_no_host_reads():
    """``meta`` tensors hold no values: the models and the optimizer read
    none back to the host (the counted cells above run every family's
    steps on ``meta``)."""
    import re
    from pathlib import Path
    src = Path(ROOT) / "src" / "repro_torch"
    for path in sorted((src / "models").glob("*.py")) + \
            sorted((src / "optim").glob("*.py")):
        text = path.read_text()
        assert not re.search(r"\.item\(\)|\.tolist\(\)|\.numpy\(\)", text), \
            path
