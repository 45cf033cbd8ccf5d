"""Parity of the port's MoE, RWKV6, Zamba2 and whisper serving paths, and
of their building blocks, against the JAX package on the CPU.

Parameters are initialised by the JAX package and carried across with
``repro_torch.interop.lm_params_from_numpy``; tokens, frames, states and
activations are made with numpy from a seed.  Attention runs K10's plain
version on the port's side and jnp on the JAX side; no JAX model here
reaches a Pallas kernel.

The JAX side runs under ``jax.jit``.  XLA's CPU backend has no bf16 x
bf16 -> f32 batched product, which the JAX MoE experts' einsums ask for in
bf16 compute; the ``exact_bf16_einsum`` fixture hands those einsums the
same bf16 operands as float32 instead.  A product of two bf16 values is
exact in float32 and the sum is float32 either way, so the function is
the same and only the order of the sums may differ.

Tolerances (those of ``tests/test_torch_lm.py``, for its reasons): 1e-4
on float32 compute; 2**-5 of the reference's largest magnitude on bf16
compute.  MoE routing (expert ids, their order, each entry's rank and
keep mask) and the serve loop's tokens are compared exactly.

MoE in bf16 compute: routing is a discontinuous function of the layer's
input, and the two packages' inputs differ by the bf16 rounding of
attention (``tests/test_torch_lm.py``).  So a token whose k-th and
(k+1)-th expert probabilities nearly tie may take another expert in each
(measured: 0.13740 against 0.13732).  The bf16 forward comparison routes
both packages layer by layer, requires every routing that differs to be
such a tie (within 2**-9 of the largest probability), and holds every
position that no differing routing can reach to the tolerance.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.launch import serve as j_serve  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import common as j_cm  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.kernels.attention import ref as a_ref  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import common as t_cm  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402

from test_torch_lm import (_cfgs, _close, _jax_serve, _params)  # noqa: E402

FAMILIES = ["qwen3-moe-30b-a3b", "arctic-480b", "rwkv6-7b", "zamba2-7b",
            "whisper-base"]
DTYPES = ["float32", "bfloat16"]
# bf16 MoE: two experts' probabilities count as a near-tie within 2**-9
# of the token's largest (the half-ulp of one bf16 rounding of the
# router's input), as in ``chip_smoke.py``'s card-vs-CPU phase
ROUTE_TIE = 2.0 ** -9


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch


def _numpy(x):
    return x.detach().float().numpy()


class _ExactBf16Einsum:
    """``jax.numpy`` with an ``einsum`` that widens bf16 operands to
    float32 first (see the module docstring)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, *ops, **kw):
        return jnp.einsum(spec, *(o.astype(jnp.float32)
                                  if o.dtype == jnp.bfloat16 else o
                                  for o in ops), **kw)


@pytest.fixture
def exact_bf16_einsum(monkeypatch):
    monkeypatch.setattr(j_moe, "jnp", _ExactBf16Einsum())


# ---------------------------------------------------------------- blocks --
@pytest.mark.parametrize("T", [5, 10, 12])
def test_chunked_time_scan_matches_jax(T):
    """chunk 4: T < 2 * chunk (one plain scan), T % chunk != 0 (the same),
    and chunked T; a pytree sequence and a carried product."""
    rng = np.random.default_rng(T)
    a = rng.uniform(0.5, 1.0, (T, 3, 4)).astype(np.float32)
    b = rng.standard_normal((T, 3, 4)).astype(np.float32)
    c0 = rng.standard_normal((3, 4)).astype(np.float32)

    def step(lib):
        def f(c, x):
            at, bt = x["a"], x["b"]
            c = c * at + bt
            return c, (c.sum(-1), lib.tanh(c))
        return f

    jc, (jy0, jy1) = j_cm.chunked_time_scan(
        step(jnp), jnp.asarray(c0), {"a": jnp.asarray(a), "b": jnp.asarray(b)},
        chunk=4)
    tc, (ty0, ty1) = t_cm.chunked_time_scan(
        step(torch), torch.tensor(c0),
        {"a": torch.tensor(a), "b": torch.tensor(b)})
    assert ty0.shape == (T, 3) and ty1.shape == (T, 3, 4)
    for got, want in ((tc, jc), (ty0, jy0), (ty1, jy1)):
        np.testing.assert_allclose(_numpy(got), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, g, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 5, 64), (64,), (64,)))
    np.testing.assert_allclose(
        _numpy(t_cm.layer_norm(*(torch.tensor(a) for a in (x, g, b)))),
        np.asarray(j_cm.layer_norm(*(jnp.asarray(a) for a in (x, g, b)))),
        rtol=1e-5, atol=1e-5)


def _qkv(B, Sq, Skv, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32))


def test_plain_k10_at_head_size_112_matches_jax():
    """zamba2-7b's head size: the causal prefill and a decode step of K10's
    plain version against JAX's jnp attention, float32."""
    q, k, v = _qkv(2, 24, 24, 4, 4, 112, 0)
    got = t_attn.chunked_causal_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        compute_dtype=torch.float32)
    want = j_attn.chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=8,
        compute_dtype=jnp.float32)
    np.testing.assert_allclose(_numpy(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    got = t_attn.decode_attention(torch.tensor(q[:, :1]), torch.tensor(k),
                                  torch.tensor(v), 17, torch.float32)
    want = j_attn.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k),
                                   jnp.asarray(v), 17, jnp.float32)
    np.testing.assert_allclose(_numpy(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("group", [1, 4])
def test_bidirectional_attention_matches_jax(group, dtype):
    """Non-causal, Sq != Skv (whisper's cross-attention), GQA groups 1 and
    4; bf16 within the bound of the documented rounding difference (flash
    divides after the P V product, jnp before the cast)."""
    H = 4
    q, k, v = _qkv(2, 7, 19, H, H // group, 16, group)
    cd = getattr(torch, dtype)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    got = t_attn.bidirectional_attention(tq, tk, tv, cd)
    want = np.asarray(j_attn.bidirectional_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), getattr(jnp, dtype)))
    assert got.shape == (2, 7, H, 16) and got.dtype == torch.float32
    lim = 1e-5 * (1 + np.abs(want))
    if dtype == "bfloat16":
        lim = lim + _numpy(a_ref.bf16_rounding_bound(
            *(a.to(cd).transpose(1, 2) for a in (tq, tk, tv)), causal=False,
            out_dtype=torch.float32).transpose(1, 2))
    assert np.all(np.abs(_numpy(got) - want) <= lim)


# ------------------------------------------------------------------- MoE --
def _jax_routing(cfg, mp, x):
    """``repro.models.moe.moe_ffn``'s routing, line for line: the group
    count, each token's top-k experts and gates, and per group the
    dispatch entries in expert order with their ranks and keep masks."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    G = min(j_moe._DEFAULT_GROUPS[0], max(1, T // 64))
    while T % G:
        G -= 1
    Tg = T // G
    xt = x.reshape(G, Tg, d)
    probs = jax.nn.softmax(j_cm.mm(xt, mp["router"], cfg.cdtype()), axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.maximum(
        gate_vals.sum(axis=-1, keepdims=True), 1e-9)
    cap = int(cfg.capacity_factor * Tg * k / E) + 1
    flat_e = expert_idx.reshape(G, -1)
    order = jnp.argsort(flat_e, axis=-1, stable=True)
    e_s = jnp.take_along_axis(flat_e, order, axis=-1)
    seg = jax.vmap(lambda e: jnp.searchsorted(e, e, side="left"))(e_s)
    rank = jnp.arange(Tg * k) - seg
    return dict(G=G, cap=cap, expert=expert_idx, gate=gate_vals, order=order,
                e_s=e_s, rank=rank, keep=rank < cap)


MOE_CASES = {  # name: (arch, config changes, B, S)
    "qwen3-moe": ("qwen3-moe-30b-a3b", {}, 2, 24),
    "arctic dense residual": ("arctic-480b", {}, 2, 24),
    "drops past capacity": ("qwen3-moe-30b-a3b", {"capacity_factor": 0.3},
                            2, 24),
    "four groups": ("qwen3-moe-30b-a3b", {}, 4, 64),
    "four groups, drops, bf16": ("qwen3-moe-30b-a3b",
                                 {"capacity_factor": 0.5,
                                  "compute_dtype": "bfloat16"}, 4, 64),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_routing_and_ffn_match_jax(case, exact_bf16_einsum):
    """Expert ids in top-k order, ranks and keep masks exactly equal to
    JAX's; the FFN output and aux loss within the tolerance."""
    name, changes, B, S = MOE_CASES[case]
    jc, tc = _cfgs(name)
    jc, tc = (dataclasses.replace(c, **changes) for c in (jc, tc))
    jp, tp = _params(jc, tc, seed=2)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    x = np.random.default_rng(3).standard_normal(
        (B, S, jc.d_model)).astype(np.float32)
    want = _jax_routing(jc, jl["moe"], jnp.asarray(x))
    G = t_moe.groups(B * S)
    assert G == want["G"] and t_moe.capacity(tc, B * S // G) == want["cap"]
    r = t_moe.route(tc, tp["layers"][0]["moe"],
                    torch.tensor(x).reshape(G, B * S // G, -1))
    for key in ("expert", "order", "e_s", "rank", "keep"):
        np.testing.assert_array_equal(getattr(r, key).numpy(),
                                      np.asarray(want[key]), err_msg=key)
    if "drops" in case:
        assert not bool(r.keep.all())
    _close(r.gate, want["gate"], "float32")
    jy, jaux = jax.jit(lambda lp, x: j_moe.moe_ffn_fn(jc, lp, x))(
        jl, jnp.asarray(x))
    ty, taux = t_moe.moe_ffn_fn(tc, tp["layers"][0], torch.tensor(x))
    _close(ty, jy, jc.compute_dtype)
    _close(taux, jaux, jc.compute_dtype)


def test_moe_top_k_breaks_ties_as_lax_top_k():
    """Equal probabilities: the lower expert index first, as
    ``lax.top_k`` returns them."""
    rng = np.random.default_rng(5)
    probs = rng.integers(0, 4, (6, 32, 8)).astype(np.float32) / 4
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = t_moe.top_k(torch.tensor(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _kept(expert, e_s, t_s, keep, E):
    """[G, Tg, E]: which experts each token reaches past the capacity."""
    G, Tg, _ = expert.shape
    m = np.zeros((G, Tg, E), bool)
    for g in range(G):
        m[g, t_s[g], e_s[g]] = keep[g]
    return m


def _moe_flips(jc, jp, tc, tp, tokens, monkeypatch):
    """Runs ``repro.models.transformer.forward``'s layers one by one (op
    by op, as the routing is read) and returns its hidden states, and the
    positions (b, s) where a layer's routing differs between the two
    packages, with every later position of that row if a later layer's
    attention can carry the difference there.  Each expert choice that
    differs must be a near-tie of the port's probabilities; tokens whose
    kept experts differ otherwise (a choice that differs moves the ranks
    behind it past or within the capacity) count only in a group that
    has such a tie."""
    seen = []
    real = t_moe.route
    monkeypatch.setattr(t_moe, "route", lambda cfg, mp, xt: seen.append(
        real(cfg, mp, xt)) or seen[-1])
    t_lm.forward_hidden(tc, tp, {"tokens": tokens}, device="cpu")
    jin = []

    def ffn(cfg, lp, h):
        jin.append(h)
        return j_moe.moe_ffn_fn(cfg, lp, h)

    B, S = tokens.shape
    x = j_tfm.embed_tokens(jc, jp, jnp.asarray(tokens))
    cos, sin = j_cm.rope_tables(jnp.arange(S), jc.hd, jc.rope_theta)
    layers = [jax.tree_util.tree_map(lambda a: a[i], jp["layers"])
              for i in range(jc.n_layers)]
    for lp in layers:
        x, _, _ = j_tfm.layer_forward(jc, lp, x, cos, sin, ffn_fn=ffn)
    out = np.zeros((B, S), bool)
    E = jc.n_experts
    for i, (r, h, lp) in enumerate(zip(seen, jin, layers)):
        want = {k: np.asarray(v) for k, v in
                _jax_routing(jc, lp["moe"], h).items()}
        got = r.expert.numpy()
        chose = (np.sort(got, -1) != np.sort(want["expert"], -1)).any(-1)
        for g, t in np.argwhere(chose):
            p = r.probs[g, t].numpy()
            gap = np.abs(np.sort(p[got[g, t]]) -
                         np.sort(p[want["expert"][g, t]]))
            assert np.all(gap <= ROUTE_TIE * p.max()), (i, g, t, gap)
        kept = (_kept(got, r.e_s.numpy(), r.t_s.numpy(), r.keep.numpy(), E)
                != _kept(want["expert"], want["e_s"],
                         np.asarray(want["order"]) // jc.top_k,
                         want["keep"], E)).any(-1)
        assert not (kept & ~chose.any(-1, keepdims=True)).any(), i
        for g, t in np.argwhere(chose | kept):
            b, s = divmod(g * got.shape[1] + t, S)
            out[b, s if i == jc.n_layers - 1 else slice(s, None)] = True
    return j_cm.rms_norm(x, jp["ln_f"]), out


# -------------------------------------------------------------- families --
@pytest.mark.parametrize("name", FAMILIES)
def test_init_params_has_the_jax_tree(name):
    """The port's own ``lm.init_params`` has the JAX tree's names and
    per-layer shapes (interop's conversion of it), in the param dtype."""
    jc, tc = _cfgs(name)
    _, carried = _params(jc, tc)
    own = t_lm.init_params(tc, 0, device="cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        assert t.dtype == tc.pdtype()
        return tuple(t.shape)

    assert shapes(own) == shapes(carried)


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("name", FAMILIES)
def test_forward_hidden_and_prefill_match_jax(name, compute_dtype,
                                              exact_bf16_einsum, monkeypatch):
    jc, tc = _cfgs(name, compute_dtype)
    jp, tp = _params(jc, tc)
    batch = _batch(jc, 2, 24, 1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jx, jaux = jax.jit(lambda p, b: j_lm.forward_hidden(jc, p, b))(jp, jbatch)
    tx, taux = t_lm.forward_hidden(tc, tp, batch, device="cpu")
    jl = jax.jit(lambda p, b: j_lm.prefill(jc, p, b))(jp, jbatch)
    logits = t_lm.prefill(tc, tp, batch, device="cpu")
    assert tx.shape == (2, 24, jc.d_model)
    assert logits.shape == (2, 1, jc.vocab) and logits.dtype == torch.float32
    _close(taux, jaux, compute_dtype)
    if jc.family == "moe":
        assert float(taux) > 0.0
    reached = np.zeros((2, 24), bool)
    if jc.family == "moe" and compute_dtype == "bfloat16":
        jx, reached = _moe_flips(jc, jp, tc, tp, batch["tokens"],
                                 monkeypatch)
        jl = j_cm.mm(jx[:, -1:], jp["emb"].T, jc.cdtype())
        assert reached.mean() < 0.25      # the comparison still covers most
    _close(tx[torch.tensor(~reached)], np.asarray(jx)[~reached],
           compute_dtype)
    rows = ~reached[:, -1]
    _close(logits[torch.tensor(rows)], np.asarray(jl)[rows], compute_dtype)


def _filled_states(jc, tc, B, S, seed):
    """The same random contents in JAX's decode state and the port's."""
    rng = np.random.default_rng(seed)
    jstate = j_lm.make_decode_state(jc, B, S)
    tstate = t_lm.make_decode_state(tc, B, S, device="cpu")
    assert set(tstate) == set(jstate)
    for key, leaf in jstate.items():
        assert tuple(tstate[key].shape) == leaf.shape
        assert str(tstate[key].dtype) == f"torch.{leaf.dtype.name}"
        fill = rng.standard_normal(leaf.shape).astype(np.float32)
        jstate[key] = jnp.asarray(fill).astype(leaf.dtype)
        tstate[key].copy_(torch.tensor(fill))
    return jstate, tstate


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("name", FAMILIES)
def test_decode_steps_from_a_jax_filled_state_match_jax(name, compute_dtype,
                                                        exact_bf16_einsum):
    jc, tc = _cfgs(name, compute_dtype)
    jp, tp = _params(jc, tc, seed=1)
    B, S = 2, 16
    jstate, tstate = _filled_states(jc, tc, B, S, 2)
    rng = np.random.default_rng(3)
    jdecode = jax.jit(lambda p, t, s, i: j_lm.decode_step(jc, p, t, s, i))
    for t_pos in (0, 5, S - 1):
        tok = rng.integers(0, jc.vocab, (B, 1)).astype(np.int32)
        jl, jstate = jdecode(jp, jnp.asarray(tok), jstate, jnp.int32(t_pos))
        tl, tstate = t_lm.decode_step(tc, tp, tok, tstate, t_pos,
                                      device="cpu")
        assert tl.shape == (B, 1, jc.vocab)
        _close(tl, jl, compute_dtype)
        for key in jstate:
            _close(tstate[key], jstate[key], compute_dtype)


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_loop_tokens_match_a_jax_driven_loop(name):
    """Six requests through three slots of a 48-slot cache, float32: the
    prefill break and the window rollover both run."""
    jc, tc = _cfgs(name)
    jp, tp = _params(jc, tc, seed=4)
    queue = t_serve.make_queue(tc, 6, 7)
    B, S, max_new = 3, 48, 8
    done, n_tokens, steps, tokens = _jax_serve(jc, jp, queue, B, S, max_new)
    res = t_serve.serve_requests(tc, tp, queue, B, max_new, S, device="cpu")
    assert (res.done, res.n_tokens, res.decode_steps) == \
        (done, n_tokens, steps)
    assert res.done == 6 and res.nonfinite_steps == 0
    assert res.tokens == tokens


@pytest.mark.parametrize("name", FAMILIES)
def test_merge_slot_state_isolates_each_familys_state(name):
    """Committing slot 2 of a decode step's state keeps that slot's update
    and every other slot of the old state bitwise, leaf by leaf, as the
    JAX function does."""
    jc, tc = _cfgs(name)
    B, S = 4, 8
    _, old = _filled_states(jc, tc, B, S, 5)
    _, new = _filled_states(jc, tc, B, S, 6)
    got = t_serve.merge_slot_state(new, old, 2, B)
    want = j_serve.merge_slot_state(
        {k: jnp.asarray(v.float().numpy()) for k, v in new.items()},
        {k: jnp.asarray(v.float().numpy()) for k, v in old.items()}, 2, B)
    for key in old:
        np.testing.assert_array_equal(_numpy(got[key]), np.asarray(want[key]))
        assert torch.equal(got[key][:, 2], new[key][:, 2])
        for b in (0, 1, 3):
            assert torch.equal(got[key][:, b], old[key][:, b])

