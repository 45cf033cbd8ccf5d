"""The gradient of the port's flash attention (K10) on the CPU: the plain
version of its backward kernel (``kernels/attention/ref.py::
flash_attention_bwd_ref``), the ``FlashAttentionFn`` around K10, and the
model attention that trains through it, against autograd and against the
JAX package.

The JAX package has no backward kernel: it differentiates its jnp
attention (``repro.models.attention.chunked_causal_attention`` and
``bidirectional_attention``), so ``jax.vjp`` of those is the reference.
Inputs and cotangents are made with numpy from a seed.  The CUDA kernels
are held to the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 27).

Tolerances:
* float64, plain backward against ``torch.autograd`` of the plain
  forward: 1e-10 -- two ways of writing the same derivative, apart only
  in float64 rounding (measured about 1e-15).
* float32 compute against ``jax.vjp``: 2e-5 of the gradient's largest
  magnitude -- the order of float32 sums and the exp differ, and jnp
  normalises p before the product with v where the port divides after.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import attention as j_attn  # noqa: E402

from repro_torch.kernels.attention import ops as t_ops  # noqa: E402
from repro_torch.kernels.attention import ref as t_ref  # noqa: E402
from repro_torch.kernels.attention.flash_backward import \
    flash_attention_bwd_cuda  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402

F64_TOL = 1e-10
F32_REL = 2e-5


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


def _rand(seed, *shapes, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal", [
    (2, 4, 2, 37, 37, 16, True),         # ragged tile, GQA 2
    (1, 6, 2, 20, 50, 16, True),         # causal, queries at the end
    (1, 3, 1, 70, 20, 64, False),        # bidirectional, Sq > Skv
    (2, 8, 8, 9, 100, 112, False),       # cross-attention, Sq < Skv
    (1, 8, 1, 65, 65, 128, True),        # GQA 8
])
def test_plain_backward_is_autograd_of_plain_forward(B, H, Hkv, Sq, Skv, D,
                                                     causal):
    q, k, v, do = (torch.tensor(x) for x in _rand(
        0, (B, H, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D),
        (B, H, Sq, D)))
    q.requires_grad_(True)
    k.requires_grad_(True)
    v.requires_grad_(True)
    o = t_ref.flash_attention_ref(q, k, v, causal)
    assert o.dtype == torch.float64
    want = torch.autograd.grad(o, (q, k, v), do)
    got = t_ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                        o.detach(), do, causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        assert float((g - w).abs().max()) <= F64_TOL


@pytest.mark.parametrize("causal,Sq,Skv,H,Hkv", [
    (True, 5, 5, 2, 1), (True, 3, 6, 3, 1), (False, 5, 3, 2, 2),
    (False, 3, 5, 4, 2)])
def test_flash_attention_fn_gradcheck(causal, Sq, Skv, H, Hkv):
    """``torch.autograd.gradcheck`` of ``FlashAttentionFn`` in float64
    (finite differences against its backward, the plain version): GQA
    groups 1-3, queries at the end of the causal timeline, Sq above and
    below Skv."""
    q, k, v = (torch.tensor(x, requires_grad=True) for x in _rand(
        1, (1, H, Sq, 16), (1, Hkv, Skv, 16), (1, Hkv, Skv, 16)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: t_ops.FlashAttentionFn.apply(q, k, v, causal),
        (q, k, v))


@pytest.fixture(scope="module")
def jax_vjps():
    """jitted (primal, cotangent) -> gradients of the JAX package's
    attention functions in float32 compute, shape-polymorphic by
    retracing."""
    def causal(q, k, v, do):
        _, vjp = jax.vjp(lambda q, k, v: j_attn.chunked_causal_attention(
            q, k, v, chunk=16, compute_dtype=jnp.float32), q, k, v)
        return vjp(do)

    def bidir(q, k, v, do):
        _, vjp = jax.vjp(lambda q, k, v: j_attn.bidirectional_attention(
            q, k, v, compute_dtype=jnp.float32), q, k, v)
        return vjp(do)

    return {True: jax.jit(causal), False: jax.jit(bidir)}


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal", [
    (2, 4, 4, 48, 48, 16, True),         # group 1
    (1, 4, 2, 32, 32, 64, True),         # group 2
    (2, 6, 2, 16, 16, 112, True),        # group 3, zamba2's head size
    (1, 2, 1, 32, 32, 128, True),
    (2, 3, 1, 24, 40, 64, False),        # bidirectional, Sq < Skv
    (1, 4, 2, 40, 8, 16, False),         # Sq > Skv
    (2, 8, 8, 16, 48, 112, False),
    (1, 6, 3, 8, 24, 128, False),
])
def test_model_attention_gradients_match_jax(jax_vjps, B, H, Hkv, Sq, Skv,
                                             D, causal):
    """The port's model attention ([B, S, H, D] activations) trains
    through ``FlashAttentionFn`` -- the plain backward on the CPU -- and
    its gradients equal ``jax.vjp`` of the JAX functions'."""
    q, k, v, do = _rand(2, (B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D),
                        (B, Sq, H, D), dtype=np.float32)
    want = jax_vjps[causal](q, k, v, do)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    fn = t_attn.chunked_causal_attention if causal else \
        t_attn.bidirectional_attention
    o = fn(tq, tk, tv, compute_dtype=torch.float32)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.tensor(do))
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        err = float(np.abs(g.numpy() - w).max())
        assert err <= F32_REL * float(np.abs(w).max()), (name, err)


def test_training_calls_go_through_the_function_and_serving_calls_do_not():
    """A recorded call returns float32 with a backward node of
    ``FlashAttentionFn``; the same call without grad is the plain dispatch,
    with bitwise the same output."""
    q, k, v = (torch.tensor(x) for x in _rand(
        3, (1, 4, 10, 16), (1, 2, 10, 16), (1, 2, 10, 16), dtype=np.float32))
    plain = t_ops.flash_attention(q, k, v, out_dtype=torch.float32)
    assert plain.grad_fn is None
    rec = t_ops.flash_attention(q.requires_grad_(True), k, v,
                                out_dtype=torch.float32)
    assert type(rec.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert torch.equal(rec.detach(), plain)
    with torch.no_grad():
        assert t_ops.flash_attention(q, k, v, out_dtype=torch.float32) \
            .grad_fn is None


@pytest.mark.parametrize("shapes,kw,match", [
    (((1, 2, 4, 16), (1, 2, 8, 16)), dict(causal=True, kv_len=6), "kv_len"),
    (((1, 2, 4, 16), (1, 2, 8, 16)), dict(causal=True, offset=2), "offset"),
    (((1, 2, 1, 16), (1, 2, 8, 16)), dict(causal=True, offset=0,
                                          kv_len=1), "kv_len"),
    (((1, 16, 4, 16), (1, 1, 4, 16)), dict(causal=False), "groups up to 8"),
    (((1, 2, 8, 16), (1, 2, 4, 16)), dict(causal=True), "offset"),
])
def test_backward_refuses_other_geometries(shapes, kw, match):
    """The decode geometries (kv_len, offset), groups over 8 and a causal
    call with more queries than keys are refused before any launch: by the
    geometry check, the plain backward and a recorded call."""
    q, k = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match=match):
        t_ref.bwd_geometry(q, k, **kw)
    with pytest.raises(ValueError, match=match):
        t_ops.flash_attention(q.requires_grad_(True), k, k,
                              out_dtype=torch.float32, **kw)
    if "offset" not in kw and "kv_len" not in kw:
        with pytest.raises(ValueError, match=match):
            t_ref.flash_attention_bwd_ref(q.detach(), k, k, q.detach(),
                                          q.detach(), kw["causal"])


def test_recorded_call_refuses_a_non_float32_output():
    q = torch.zeros((1, 2, 4, 16), requires_grad=True)
    with pytest.raises(ValueError, match="returns torch.float32"):
        t_ops.flash_attention(q, q, q, out_dtype=torch.bfloat16)


def test_cuda_backward_wrapper_refuses_host_tensors_and_head_sizes():
    q = torch.zeros((1, 2, 4, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_bwd_cuda(q, q, q, q, q)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_bwd_cuda(q.double(), q, q, q, q)
