"""Parity of the port's LM serving path (configs, dense/vlm transformer,
``lm`` API, the ``launch/serve.py`` loop) against the JAX package, on the
CPU.

Parameters are initialised by the JAX package and carried across with
``repro_torch.interop.lm_params_from_numpy``; tokens, patches and cache
contents are made with numpy from a seed.  Attention runs K10's plain
version on the port's side and jnp on the JAX side.

Tolerances:
* float32 compute (the reduced configs): 1e-4 on logits and hidden
  states -- only the order of float32 sums differs (measured <= 3e-6).
* bf16 compute: 2**-5 of the reference's largest magnitude.  Attention
  alone differs by up to 2**-8 * max|v| (jnp rounds the normalised p to
  bf16, flash rounds p and divides after; tests/
  test_torch_flash_attention.py), and every bf16 rounding of an
  activation it perturbs can flip by one ulp (2**-8 relative); over two
  layers and the logit GEMM that stays within 2**-5 (measured about
  2**-7).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models import transformer as t_tfm  # noqa: E402

F32_TOL = 1e-4
BF16_REL = 2.0 ** -5


def _cfgs(name, compute_dtype="float32"):
    return (dataclasses.replace(j_configs.get_config(name).reduced(),
                                compute_dtype=compute_dtype),
            dataclasses.replace(t_configs.get_config(name).reduced(),
                                compute_dtype=compute_dtype))


def _params(jc, tc, seed=0):
    jp = j_lm.init_params(jc, jax.random.PRNGKey(seed))
    return jp, interop.lm_params_from_numpy(
        tc, jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _close(got, want, compute_dtype):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    atol = F32_TOL if compute_dtype == "float32" else \
        BF16_REL * float(np.abs(want).max())
    rtol = F32_TOL if compute_dtype == "float32" else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", sorted(j_configs.ARCHS))
def test_config_registry_matches_jax(name):
    jc, tc = j_configs.get_config(name), t_configs.get_config(name)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(jc.reduced())
    for c, d in ((tc, jc), (tc.reduced(), jc.reduced())):
        assert (c.hd, c.attention_free, c.sub_quadratic) == \
            (d.hd, d.attention_free, d.sub_quadratic)
        assert str(c.pdtype()) == f"torch.{d.pdtype().name}"
        assert str(c.cdtype()) == f"torch.{d.cdtype().name}"
    for shape in j_configs.SHAPES.values():
        assert t_configs.shape_applicable(tc, t_configs.SHAPES[shape.name]) \
            == j_configs.shape_applicable(jc, shape)
    assert {k: dataclasses.asdict(v) for k, v in t_configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in j_configs.SHAPES.items()}


def test_params_carry_across_at_the_jax_layout():
    jc, tc = _cfgs("qwen2-72b")
    jp, tp = _params(jc, tc, seed=3)
    assert len(tp["layers"]) == jc.n_layers
    for key, arr in jp["layers"].items():
        for i in range(jc.n_layers):
            np.testing.assert_array_equal(tp["layers"][i][key].numpy(),
                                          np.asarray(arr[i]))
    own = t_tfm.init_params(tc, torch.Generator().manual_seed(0))
    assert set(own) == set(tp) and set(own["layers"][0]) == \
        set(tp["layers"][0]) == set(jp["layers"])
    for key, arr in jp["layers"].items():
        assert tuple(own["layers"][0][key].shape) == arr.shape[1:]
    assert own["emb"].shape == tuple(jp["emb"].shape)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["smollm-135m", "internvl2-1b"])
def test_forward_hidden_and_prefill_match_jax(name, compute_dtype):
    jc, tc = _cfgs(name, compute_dtype)
    jp, tp = _params(jc, tc)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, jc.vocab, (2, 24)).astype(np.int32)}
    if jc.n_patches:
        batch["patches"] = rng.standard_normal(
            (2, jc.n_patches, jc.d_model)).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jx, _ = j_lm.forward_hidden(jc, jp, jbatch)
    tx, aux = t_lm.forward_hidden(tc, tp, batch, device="cpu")
    assert tx.shape == (2, 24, jc.d_model) and float(aux) == 0.0
    _close(tx, jx, compute_dtype)
    logits = t_lm.prefill(tc, tp, batch, device="cpu")
    assert logits.shape == (2, 1, jc.vocab) and logits.dtype == torch.float32
    _close(logits, j_lm.prefill(jc, jp, jbatch), compute_dtype)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_decode_steps_on_a_filled_cache_match_jax(compute_dtype):
    jc, tc = _cfgs("smollm-135m", compute_dtype)
    jp, tp = _params(jc, tc, seed=1)
    rng = np.random.default_rng(2)
    B, S = 2, 32
    shape = (jc.n_layers, B, S, jc.n_kv_heads, jc.hd)
    fill = {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("k", "v")}
    jcache = {k: jnp.asarray(v).astype(jc.cdtype()) for k, v in fill.items()}
    tcache = t_lm.make_decode_state(tc, B, S, device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in tcache.items()} == \
        {k: (shape, tc.cdtype()) for k in ("k", "v")}
    for k in tcache:
        tcache[k].copy_(torch.tensor(fill[k]).to(tc.cdtype()))
    for t_pos in (0, 5, 17, S - 1):
        tok = rng.integers(0, jc.vocab, (B, 1)).astype(np.int32)
        jl, jcache = j_lm.decode_step(jc, jp, jnp.asarray(tok), jcache, t_pos)
        tl, tcache = t_lm.decode_step(tc, tp, tok, tcache, t_pos, device="cpu")
        assert tl.shape == (B, 1, jc.vocab)
        _close(tl, jl, compute_dtype)
        if compute_dtype == "float32":
            for k in ("k", "v"):
                _close(tcache[k], jcache[k], compute_dtype)


def test_prefill_cache_matches_decode_built_cache():
    """``forward(return_cache=True)`` and S decode steps build the same
    cache and the same last-position hidden state (port only)."""
    _, tc = _cfgs("smollm-135m")
    tp = t_lm.init_params(tc, 5, device="cpu")
    toks = np.random.default_rng(3).integers(0, tc.vocab, (2, 9))
    x, (k, v), _ = t_tfm.forward(tc, tp, torch.tensor(toks),
                                 return_cache=True)
    cache = t_lm.make_decode_state(tc, 2, 12, device="cpu")
    for t in range(9):
        logits, cache = t_lm.decode_step(tc, tp, toks[:, t:t + 1], cache, t,
                                         device="cpu")
    torch.testing.assert_close(cache["k"][:, :, :9], k, rtol=F32_TOL,
                               atol=F32_TOL)
    torch.testing.assert_close(cache["v"][:, :, :9], v, rtol=F32_TOL,
                               atol=F32_TOL)
    assert not cache["k"][:, :, 9:].any()
    torch.testing.assert_close(
        logits, t_lm.prefill(tc, tp, {"tokens": toks}, device="cpu"),
        rtol=F32_TOL, atol=F32_TOL)


def test_merge_slot_state_isolates_prefill():
    """tests/test_serve.py::test_merge_slot_state_isolates_prefill on the
    port: committing one slot leaves every other slot bitwise untouched
    (batch axis 1 on every leaf, nested dicts and tuples)."""
    rng = np.random.default_rng(0)
    B = 4
    old = {"kv": rng.standard_normal((2, B, 8, 3)),
           "ssm": (rng.standard_normal((5, B, 7)),
                   rng.standard_normal((1, B, 2, 2, 2)))}
    new = {"kv": rng.standard_normal((2, B, 8, 3)),
           "ssm": (rng.standard_normal((5, B, 7)),
                   rng.standard_normal((1, B, 2, 2, 2)))}
    as_t = {"kv": torch.tensor(new["kv"]),
            "ssm": tuple(torch.tensor(a) for a in new["ssm"])}
    as_o = {"kv": torch.tensor(old["kv"]),
            "ssm": tuple(torch.tensor(a) for a in old["ssm"])}
    got = t_serve.merge_slot_state(as_t, as_o, 2, B)
    want = j_serve.merge_slot_state(new, old, 2, B)
    assert isinstance(got["ssm"], tuple)
    for kn, ko, kg, kw in ((new["kv"], old["kv"], got["kv"], want["kv"]),
                           (new["ssm"][0], old["ssm"][0], got["ssm"][0],
                            want["ssm"][0]),
                           (new["ssm"][1], old["ssm"][1], got["ssm"][1],
                            want["ssm"][1])):
        kg = kg.numpy()
        np.testing.assert_array_equal(kg, np.asarray(kw))
        assert np.array_equal(kg[:, 2], kn[:, 2])
        for b in (0, 1, 3):
            assert np.array_equal(kg[:, b], ko[:, b])


def _jax_serve(cfg, params, queue, B, S, max_new):
    """``repro.launch.serve.lm_main``'s loop, line for line, recording the
    tokens each request produced and the decode steps."""
    queue = list(queue)
    n_requests = len(queue)

    @jax.jit
    def jdecode(params, token, state, t_pos):
        return j_lm.decode_step(cfg, params, token, state, t_pos)

    state = j_lm.make_decode_state(cfg, B, S)
    slot_free, slot_req, slot_left = [True] * B, [None] * B, [0] * B
    cur_tok = np.zeros((B, 1), np.int32)
    tokens = {rid: [] for rid, _ in queue}
    done, n_tokens, t_pos, steps = 0, 0, 0, 0
    while done < n_requests or any(not f for f in slot_free):
        for b in range(B):
            if slot_free[b] and queue:
                rid, prompt = queue.pop(0)
                for tok in prompt[:-1]:
                    if t_pos >= S - max_new - 1:
                        break
                    logits, new_state = jdecode(
                        params, jnp.asarray(np.full((B, 1), tok, np.int32)),
                        state, jnp.int32(t_pos))
                    state = j_serve.merge_slot_state(new_state, state, b, B)
                    t_pos += 1
                    steps += 1
                cur_tok[b, 0] = prompt[-1]
                slot_free[b], slot_req[b], slot_left[b] = False, rid, max_new
        if all(slot_free):
            break
        logits, state = jdecode(params, jnp.asarray(cur_tok), state,
                                jnp.int32(t_pos))
        t_pos += 1
        steps += 1
        nxt = np.asarray(jnp.argmax(logits[:, 0], axis=-1), np.int32)
        for b in range(B):
            if slot_free[b]:
                continue
            cur_tok[b, 0] = nxt[b]
            tokens[slot_req[b]].append(int(nxt[b]))
            n_tokens += 1
            slot_left[b] -= 1
            if slot_left[b] <= 0 or t_pos >= S - 1:
                slot_free[b] = True
                done += 1
        if t_pos >= S - 2:
            state = j_lm.make_decode_state(cfg, B, S)
            t_pos = 0
    return done, n_tokens, steps, tokens


def test_serve_loop_tokens_match_a_jax_driven_loop():
    """Six requests through three slots of a 48-slot cache: the prefill
    break and the window rollover both run."""
    jc, tc = _cfgs("smollm-135m")
    jp, tp = _params(jc, tc, seed=4)
    rng = np.random.default_rng(7)
    queue = [(i, rng.integers(0, jc.vocab, rng.integers(4, 32)))
             for i in range(6)]
    port_queue = t_serve.make_queue(tc, 6, 7)
    for (i, p), (j, r) in zip(queue, port_queue):
        assert i == j and np.array_equal(p, r)
    B, S, max_new = 3, 48, 8
    done, n_tokens, steps, tokens = _jax_serve(jc, jp, queue, B, S, max_new)
    res = t_serve.serve_requests(tc, tp, port_queue, B, max_new, S,
                                 device="cpu")
    assert (res.done, res.n_tokens, res.decode_steps) == \
        (done, n_tokens, steps)
    assert res.done == 6 and res.nonfinite_steps == 0
    assert 0 < res.prefill_steps < res.decode_steps
    assert res.tokens == tokens


def test_lm_main_serves_every_request(capsys):
    res = t_serve.lm_main(t_serve.build_parser().parse_args(
        ["--reduced", "--requests", "5", "--slots", "2", "--max-new", "6",
         "--cache-len", "64", "--device", "cpu"]))
    assert res.done == 5 and res.n_tokens == 30 and res.nonfinite_steps == 0
    assert sorted(res.tokens) == list(range(5))
    assert all(len(t) == 6 for t in res.tokens.values())
    assert "served 5 requests, 30 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "rwkv6-7b",
                                  "zamba2-7b", "whisper-base"])
def test_other_families_decode_on_cpu_and_training_raises(name, monkeypatch):
    """The MoE, RWKV6, Zamba2 and whisper families initialise and decode
    on the CPU (their parity with JAX: tests/test_torch_lm_families.py);
    the training entry points still raise."""
    cfg = t_configs.get_config(name).reduced()
    params = t_lm.init_params(cfg, 0, device="cpu")
    state = t_lm.make_decode_state(cfg, 2, 8, device="cpu")
    logits, state = t_lm.decode_step(cfg, params, np.zeros((2, 1), np.int32),
                                     state, 0, device="cpu")
    assert logits.shape == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    for call in (lambda: t_lm.train_step(cfg, None, None, None, 1e-3),
                 lambda: t_lm.loss_fn(cfg, params, {}),
                 lambda: t_lm.init_train_state(cfg, 0)):
        with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
            call()
    # --sim is ported: it runs on the card unless asked for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_serve.main(["--sim"])
