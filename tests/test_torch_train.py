"""Parity of the port's LM training path (``optim/adamw.py``,
``data/pipeline.py``, ``models/common.py``'s loss, ``lm.loss_fn`` /
``train_step``) against the JAX package, on the CPU.

Parameters and AdamW states are initialised by the JAX package and
carried across with ``repro_torch.interop``; batches are JAX's own
``make_batch`` output, as numpy (the port's stream is its own, not
threefry).  Attention trains through ``FlashAttentionFn``'s plain
backward on the port's side and through ``jax.vjp`` of jnp on JAX's.

Tolerances:
* optimizer pieces fed the same numpy inputs: 1e-6 relative (float32
  rounding of ``b ** t``, ``sqrt`` and the division);
* float32 compute (the reduced configs): losses within 1e-5 relative,
  gradients within 5e-5 of each leaf's largest magnitude (float32 sum
  order over the layers and the recurrences' time loops; measured at
  most 1.2e-5, zamba2-7b);
* bf16 compute (dense): the loss within 2**-8 relative, gradients within
  2**-5 of each leaf's largest magnitude -- attention rounds p to bf16
  after normalising in jnp and before in K10 (ROADMAP §3, slice 5), and
  JAX rounds each dot's operand cotangent to bf16 where the port rounds
  the cast's (measured 2**-7);
* parameters after AdamW steps: AdamW moves a parameter by about
  lr * g / |g|, so a gradient entry that is zero up to the gradient
  tolerance tau may take the other sign in the two packages and move its
  parameter 2 lr apart.  An entry may differ by 1e-6 (1 + |p|) plus, per
  step, lr * min(2, 2 tau / |g|) -- the flip only where |g| <= tau, and
  the sign function's sensitivity tau / |g| elsewhere.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.utils._pytree import tree_flatten, tree_unflatten  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.data import pipeline as j_pipe  # noqa: E402
from repro.models import common as j_cm  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro import optim as j_optim  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import optim as t_optim  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import DataPipeline, make_batch  # noqa: E402
from repro_torch.models import common as t_cm  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402

OPT_REL = 1e-6
LOSS_REL = 1e-5
GRAD_REL = 5e-5
BF16_LOSS_REL = 2.0 ** -8
BF16_GRAD_REL = 2.0 ** -5
FAMILIES = ["smollm-135m", "internvl2-1b", "qwen3-moe-30b-a3b",
            "arctic-480b", "rwkv6-7b", "zamba2-7b", "whisper-base"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small tensors: as fast alone,
    and it spares the suite's other parallel workers an oversubscribed
    CPU (with a thread per core in every worker, each small op's thread
    team waits on the others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rel, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want) if scale is None else scale
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert (err <= rel * scale + 1e-30).all(), float((err / (scale + 1e-30))
                                                     .max())


# ---------------------------------------------------------------- AdamW --
def _opt_inputs(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"b": (7,), "layers": [(3, 4), (3, 4)], "w": (5, 7)}

    def draw(f):      # keys in sorted order: JAX's and torch's leaf order
        return {"b": f(shapes["b"]),
                "layers": [f(s) for s in shapes["layers"]],
                "w": f(shapes["w"])}

    p = draw(lambda s: rng.standard_normal(s).astype(np.float32))
    g = draw(lambda s: (rng.standard_normal(s) * 3).astype(np.float32))
    mu = draw(lambda s: (rng.standard_normal(s) * 0.1).astype(np.float32))
    nu = draw(lambda s: rng.random(s).astype(np.float32) * 0.01)
    return p, g, mu, nu


def _torch_tree(tree):
    return tree_unflatten([torch.tensor(x) for x in tree_flatten(tree)[0]],
                          tree_flatten(tree)[1])


@pytest.mark.parametrize("step,lr", [(0, 3e-4), (4, 1e-3), (999, 2e-5)])
def test_adamw_update_matches_jax(step, lr):
    p, g, mu, nu = _opt_inputs(step)
    jstate = j_optim.AdamWState(step=jnp.int32(step), mu=mu, nu=nu)
    jp, js = jax.jit(j_optim.adamw_update)(g, jstate, p, jnp.float32(lr))
    tstate = t_optim.AdamWState(step=torch.tensor(step, dtype=torch.int32),
                                mu=_torch_tree(mu), nu=_torch_tree(nu))
    tp, ts = t_optim.adamw_update(_torch_tree(g), tstate, _torch_tree(p), lr)
    assert int(ts.step) == int(js.step) == step + 1
    assert ts.step.dtype == torch.int32
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for a, b in zip(tree_flatten(got)[0], jax.tree_util.tree_leaves(
                _np(want))):
            assert a.dtype == torch.float32
            _close(a.numpy(), b, OPT_REL, np.abs(b) + 1e-6)


def test_adamw_keeps_parameter_dtypes_and_inits_float32_moments():
    params = {"a": torch.ones(3, dtype=torch.bfloat16), "b": [torch.ones(2)]}
    st = t_optim.adamw_init(params)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    assert st.mu["a"].dtype == torch.float32 and st.nu["b"][0].shape == (2,)
    grads = {"a": torch.full((3,), 0.5, dtype=torch.bfloat16),
             "b": [torch.ones(2)]}
    new, st = t_optim.adamw_update(grads, st, params, 1e-2)
    assert new["a"].dtype == torch.bfloat16 and new["b"][0].dtype == \
        torch.float32
    assert bool((new["b"][0] < 1).all())


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    _, g, _, _ = _opt_inputs(7)
    jg, jn = j_optim.clip_by_global_norm(g, max_norm)
    tg, tn = t_optim.clip_by_global_norm(_torch_tree(g), max_norm)
    _close(float(tn), float(jn), OPT_REL)
    for a, b in zip(tree_flatten(tg)[0], jax.tree_util.tree_leaves(_np(jg))):
        _close(a.numpy(), b, OPT_REL, np.abs(b) + 1e-7)


def test_wsd_schedule_matches_jax():
    steps = np.arange(0, 1200, 7, dtype=np.int32)
    for kw in (dict(warmup=20, total=30), dict(warmup=100, total=1000),
               dict(warmup=0, total=500, decay_frac=0.3)):
        want = np.asarray(jax.vmap(lambda s: j_optim.wsd_schedule(
            s, 3e-4, **kw))(jnp.asarray(steps)))
        got = t_optim.wsd_schedule(torch.tensor(steps), 3e-4, **kw)
        assert got.dtype == torch.float32
        _close(got.numpy(), want, OPT_REL, np.abs(want) + 1e-12)


def test_int8_compression_round_trip():
    """Stochastic rounding: every value within one quantum of the input,
    unbiased on average, the same bits from the same generator."""
    g = torch.randn((64, 64), generator=torch.Generator().manual_seed(0))
    q, scale = t_optim.compress_stochastic_int8(
        g, torch.Generator().manual_seed(1))
    q2, _ = t_optim.compress_stochastic_int8(
        g, torch.Generator().manual_seed(1))
    assert q.dtype == torch.int8 and torch.equal(q, q2)
    assert int(q.abs().max()) <= 127
    back = t_optim.decompress_int8(q, scale)
    assert float((back - g).abs().max()) <= float(scale) * (1 + 1e-6)
    assert abs(float((back - g).mean())) < 0.05 * float(scale)


# ----------------------------------------------------------------- loss --
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_chunked_lm_loss_and_grads_match_jax(cd):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    emb = (rng.standard_normal((50, 16)) * 0.5).astype(np.float32)
    labels = rng.integers(0, 50, (2, 24)).astype(np.int32)
    jdt = jnp.float32 if cd == "float32" else jnp.bfloat16
    want, (gx, ge) = jax.value_and_grad(
        lambda x, e: j_cm.chunked_lm_loss(x, e, labels, compute_dtype=jdt),
        argnums=(0, 1))(x, emb)
    tx, te = torch.tensor(x, requires_grad=True), \
        torch.tensor(emb, requires_grad=True)
    got = t_cm.chunked_lm_loss(tx, te, torch.tensor(labels),
                               compute_dtype=getattr(torch, cd))
    got.backward()
    rel = LOSS_REL if cd == "float32" else BF16_LOSS_REL
    _close(float(got.detach()), float(want), rel)
    grel = GRAD_REL if cd == "float32" else BF16_GRAD_REL
    for a, b in ((tx.grad, gx), (te.grad, ge)):
        b = np.asarray(b, np.float32)
        _close(a.numpy(), b, grel, np.abs(b).max())


def test_softmax_xent_matches_jax_and_stops_the_max_gradient():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((12, 30)) * 4).astype(np.float32)
    labels = rng.integers(0, 30, 12).astype(np.int32)
    want, gw = jax.value_and_grad(lambda z: j_cm.softmax_xent(z, labels, 30))(
        logits)
    z = torch.tensor(logits, requires_grad=True)
    got = t_cm.softmax_xent(z, torch.tensor(labels), 30)
    got.backward()
    _close(float(got.detach()), float(want), LOSS_REL)
    _close(z.grad.numpy(), np.asarray(gw), GRAD_REL, np.abs(gw).max())
    # the gradient is softmax - onehot over N: rows sum to zero
    assert float(z.grad.sum(dim=-1).abs().max()) < 1e-6


# ----------------------------------------------------------------- data --
@pytest.mark.parametrize("name", ["smollm-135m", "internvl2-1b",
                                  "whisper-base"])
def test_make_batch_structure_and_determinism(name):
    cfg = t_configs.get_config(name).reduced()
    shape = ShapeConfig("t", 48, 3, "train")
    b = make_batch(cfg, shape, 5, 2, device="cpu")
    assert b["tokens"].shape == b["labels"].shape == (3, 48)
    assert b["tokens"].dtype == torch.int64
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < cfg.vocab
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    again = make_batch(cfg, shape, 5, 2, device="cpu")
    other = make_batch(cfg, shape, 5, 3, device="cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)
    assert not torch.equal(b["tokens"], other["tokens"])
    stub = {"vlm": ("patches", cfg.n_patches),
            "audio": ("frames", cfg.enc_frames)}.get(cfg.family)
    assert set(b) == {"tokens", "labels"} | ({stub[0]} if stub else set())
    if stub:
        x = b[stub[0]]
        assert x.shape == (3, stub[1], cfg.d_model) and x.dtype == \
            torch.float32
        assert 0.01 < float(x.std()) < 0.04      # normal * 0.02
    assert make_batch(cfg, shape, 5, 2, batch_override=2,
                      device="cpu")["tokens"].shape == (2, 48)


def test_make_batch_follows_the_reference_distribution():
    """Zipf-like unigram with copies of the previous token at p = 0.3:
    token 0 (u near 1) is the most frequent, about 0.3 of the positions
    repeat their predecessor, as in JAX's stream."""
    cfg = t_configs.get_config("smollm-135m").reduced()
    jcfg = j_configs.get_config("smollm-135m").reduced()
    shape = ShapeConfig("t", 256, 8, "train")
    t = np.concatenate([make_batch(cfg, shape, 0, s, device="cpu")["tokens"]
                        .numpy() for s in range(4)])
    j = np.concatenate([np.asarray(j_pipe.make_batch(
        jcfg, JShape("t", 256, 8, "train"), 0, s)["tokens"])
        for s in range(4)])
    for x in (t, j):
        rep = float((x[:, 1:] == x[:, :-1]).mean())
        assert 0.3 < rep < 0.45                  # copies + equal draws
        counts = np.bincount(x.ravel(), minlength=cfg.vocab)
        assert counts.argmax() == 0
    ct, cj = (np.bincount(x.ravel(), minlength=cfg.vocab) / x.size
              for x in (t, j))
    assert np.abs(ct - cj).max() < 0.03


def test_pipeline_cursor_round_trips():
    cfg = t_configs.get_config("smollm-135m").reduced()
    pipe = DataPipeline(cfg, ShapeConfig("t", 16, 2, "train"), seed=3,
                        device="cpu")
    first = [pipe.next_batch()["tokens"] for _ in range(3)]
    state = pipe.state_dict()
    assert state == {"seed": 3, "step": 3}
    nxt = pipe.next_batch()["tokens"]
    again = DataPipeline(cfg, ShapeConfig("t", 16, 2, "train"), device="cpu")
    again.load_state_dict(state)
    assert torch.equal(again.next_batch()["tokens"], nxt)
    assert not torch.equal(first[0], first[1])


# ------------------------------------------------------------ lm, JAX --
def _cfgs(name, cd="float32"):
    return (dataclasses.replace(j_configs.get_config(name).reduced(),
                                compute_dtype=cd),
            dataclasses.replace(t_configs.get_config(name).reduced(),
                                compute_dtype=cd))


def _jax_batch(jc, step, B=2, S=32):
    return _np(j_pipe.make_batch(jc, JShape("t", S, B, "train"), 0, step))


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(name, cd="float32"):
    jc, _ = _cfgs(name, cd)
    return jax.jit(jax.value_and_grad(lambda p, b: j_lm.loss_fn(jc, p, b),
                                      has_aux=True))


def _port_value_and_grad(tc, params, batch, remat=False):
    (loss, (lm, aux)), grads = t_lm.loss_and_grad(tc, params, batch,
                                                  remat=remat, device="cpu")
    return (loss, lm, aux), grads


def _check_grads(tgrads, jgrads, rel):
    got = jax.tree_util.tree_leaves(interop.lm_tree_to_numpy(tgrads))
    want = jax.tree_util.tree_leaves(_np(jgrads))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b, np.float32)
        _close(a, b, rel, np.abs(b).max())


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_match_jax(name):
    """Every family's reduced config in float32: loss, its lm and aux
    parts, and the gradient of every parameter."""
    jc, tc = _cfgs(name)
    jp = j_lm.init_params(jc, jax.random.PRNGKey(0))
    tp = interop.lm_params_from_numpy(tc, _np(jp), "cpu")
    nb = _jax_batch(jc, 0)
    (jl, (jlm, jaux)), jg = _jax_value_and_grad(name)(jp, nb)
    (tl, tlm, taux), tg = _port_value_and_grad(
        tc, tp, interop.batch_from_numpy(nb, "cpu"))
    for got, want in ((tl, jl), (tlm, jlm), (taux, jaux)):
        _close(float(got), float(want), LOSS_REL, abs(float(want)) + 1e-6)
    _check_grads(tg, jg, GRAD_REL)


def test_loss_and_grads_match_jax_in_bf16_compute():
    jc, tc = _cfgs("smollm-135m", "bfloat16")
    jp = j_lm.init_params(jc, jax.random.PRNGKey(1))
    tp = interop.lm_params_from_numpy(tc, _np(jp), "cpu")
    nb = _jax_batch(jc, 1)
    (jl, _), jg = _jax_value_and_grad("smollm-135m", "bfloat16")(jp, nb)
    (tl, _, _), tg = _port_value_and_grad(tc, tp,
                                          interop.batch_from_numpy(nb, "cpu"))
    _close(float(tl), float(jl), BF16_LOSS_REL)
    _check_grads(tg, jg, BF16_GRAD_REL)


@pytest.mark.parametrize("name", ["smollm-135m", "qwen3-moe-30b-a3b"])
def test_three_train_steps_match_jax(name, lr=1e-3):
    """Three ``train_step``s from the same (params, AdamWState) and
    batches: losses and grad norms tightly, the parameters and moments
    under the sign-flip allowance of the module docstring."""
    jc, tc = _cfgs(name)
    jp, jo = j_lm.init_train_state(jc, jax.random.PRNGKey(2))
    tp = interop.lm_params_from_numpy(tc, _np(jp), "cpu")
    to = interop.adamw_state_from_numpy(_np(jo), "cpu")
    jstep = jax.jit(lambda p, o, b: j_lm.train_step(jc, p, o, b,
                                                    jnp.float32(lr)))
    allow = None
    for s in range(3):
        nb = _jax_batch(jc, s)
        (_, _), jg = _jax_value_and_grad(name)(jp, nb)
        jp, jo, jm = jstep(jp, jo, nb)
        tp, to, tm = t_lm.train_step(tc, tp, to,
                                     interop.batch_from_numpy(nb, "cpu"), lr,
                                     device="cpu")
        for k in ("loss", "lm_loss", "aux_loss", "grad_norm"):
            _close(float(tm[k]), float(jm[k]), LOSS_REL,
                   abs(float(jm[k])) + 1e-6)
        gs = jax.tree_util.tree_leaves(_np(jg))
        step_allow = [lr * np.minimum(2.0, 2 * GRAD_REL * np.abs(g).max() /
                                      np.maximum(np.abs(g), 1e-30))
                      for g in gs]
        allow = step_allow if allow is None else \
            [a + b for a, b in zip(allow, step_allow)]
        got = jax.tree_util.tree_leaves(interop.lm_tree_to_numpy(tp))
        for a, b, al in zip(got, jax.tree_util.tree_leaves(_np(jp)), allow):
            assert (np.abs(a - b) <= 1e-6 * (1 + np.abs(b)) + al).all()
    got = interop.adamw_state_to_numpy(to)
    assert got["step"] == int(jo.step) == 3
    for m in ("mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(got[m]),
                        jax.tree_util.tree_leaves(_np(getattr(jo, m)))):
            _close(a, b, 2 * GRAD_REL, np.abs(b).max() + 1e-30)


@pytest.mark.parametrize("name", ["smollm-135m", "qwen3-moe-30b-a3b"])
def test_remat_is_bitwise_the_plain_pass(name):
    """``remat=True`` recomputes each transformer layer in the backward
    pass: the loss and every gradient bitwise those of ``remat=False``."""
    _, tc = _cfgs(name)
    params = t_lm.init_params(tc, 0, device="cpu")
    batch = make_batch(tc, ShapeConfig("t", 32, 2, "train"), 0, 0,
                       device="cpu")
    (l0, _, _), g0 = _port_value_and_grad(tc, params, batch)
    (l1, _, _), g1 = _port_value_and_grad(tc, params, batch, remat=True)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_flatten(g0)[0], tree_flatten(g1)[0]):
        assert torch.equal(a, b)


def test_train_step_leaves_the_caller_tree_plain():
    """Params stay a plain tree of tensors without ``requires_grad``,
    before and after a step, and init_train_state pairs them with zero
    moments."""
    _, tc = _cfgs("smollm-135m")
    params, opt = t_lm.init_train_state(tc, 0, device="cpu")
    assert int(opt.step) == 0
    batch = make_batch(tc, ShapeConfig("t", 16, 2, "train"), 0, 0,
                       device="cpu")
    new, opt, m = t_lm.train_step(tc, params, opt, batch, 1e-3, device="cpu")
    leaves = tree_flatten(new)[0] + tree_flatten(params)[0]
    assert not any(p.requires_grad for p in leaves)
    assert set(m) == {"loss", "lm_loss", "aux_loss", "grad_norm"}
    assert all(v.dim() == 0 and bool(torch.isfinite(v)) for v in m.values())
    assert int(opt.step) == 1
