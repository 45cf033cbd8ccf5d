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


# The bf16 backward kernels (csrc/flash_backward.cu) multiply on the tensor
# cores: a float32 operand x (P, dS, dO) is split into three bf16 pieces,
# each piece times a bf16 operand is exact in float32, and the pieces'
# products are summed in float32.  These tests hold that arithmetic on the
# CPU; the kernels themselves are held to the plain version on the card.
DV_TERMS = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))   # P^T dO pieces


def _split(x, pieces=3):
    """x's bf16 pieces, as float32 tensors, the way the kernels split a
    float32 operand: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
    mid)."""
    out = []
    for _ in range(pieces):
        p = x.bfloat16().float()
        out.append(p)
        x = x - p
    return out


def _split_sums_bwd(q, k, v, o, do, causal, pieces=3, dv_terms=DV_TERMS):
    """(dq, dk, dv) in float32 as the bf16 kernels sum them: S = Q K^T of
    bf16 operands; dP from dO's pieces times V; dq and dk from dS's
    pieces times K and Q; dv from ``dv_terms`` (piece of P, piece of dO);
    every product of bf16 pieces summed in float32."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = H // Hkv
    offset = t_ref.bwd_geometry(q, k, causal)
    s, valid, kk = t_ref._scores(q, k, causal, offset, Skv)
    vv = v.repeat_interleave(g, dim=1).float()
    m = s.amax(dim=-1, keepdim=True)
    lse = m + torch.log(torch.exp(s - m).sum(dim=-1, keepdim=True))
    p = torch.where(valid, torch.exp(s - lse), torch.zeros_like(s))
    dsum = (do * o).sum(dim=-1, keepdim=True)
    dop = _split(do, pieces)
    ds = p * (sum(x @ vv.transpose(-1, -2) for x in dop) - dsum)
    dsp, pp = _split(ds, pieces), _split(p, pieces)
    scale = 1.0 / (D ** 0.5)
    dq = sum(x @ kk for x in dsp) * scale
    dk = sum(x.transpose(-1, -2) @ q.float() for x in dsp) * scale
    dv = sum(pp[a].transpose(-1, -2) @ dop[b] for a, b in dv_terms
             if a < pieces and b < pieces)

    def group_sum(x):
        return x.reshape(B, Hkv, g, Skv, D).sum(dim=2)

    return dq, group_sum(dk), group_sum(dv)


def test_three_bf16_pieces_rebuild_float32():
    """hi + mid + lo rebuilds float32 values to 2**-24 of themselves --
    random, next to powers of two, and at 1e-30 and 1e30 -- with each
    piece a bf16 value and each subtraction exact in float32; two pieces
    leave up to 2**-17."""
    rng = np.random.default_rng(4)
    ulp = np.float32(2.0 ** -23)
    twos = np.float32(2.0) ** np.arange(-20, 21, dtype=np.float32)
    near = np.concatenate([twos * (1 + ulp * j) for j in (-3, -1, 0, 1, 3)] +
                          [twos * (1 - ulp / 2 * j) for j in (1, 3)])
    x = np.concatenate([
        rng.standard_normal(20000).astype(np.float32),
        rng.uniform(-1, 1, 20000).astype(np.float32) *
        np.float32(10.0) ** rng.integers(-30, 31, 20000).astype(np.float32),
        near, -near, np.float32([1e-30, -1e-30, 1e30, -1e30, 3e-30, 7e29])])
    t = torch.from_numpy(x)
    hi, mid, lo = _split(t)
    for piece in (hi, mid, lo):
        assert torch.equal(piece.bfloat16().float(), piece)
    r = t.double() - hi.double()
    assert torch.equal((t - hi).double(), r)
    assert torch.equal((t - hi - mid).double(), r - mid.double())
    err = (hi.double() + mid.double() + lo.double() - t.double()).abs()
    assert bool((err <= 2.0 ** -24 * t.double().abs()).all())
    err2 = (hi.double() + mid.double() - t.double()).abs()
    assert float((err2 / t.double().abs()).max()) > 2.0 ** -24
    assert bool((err2 <= 2.0 ** -17 * t.double().abs()).all())


def _bf16_case(B, H, Hkv, Sq, Skv, D, causal, mode, seed=5):
    """bf16 q, k, v, the forward's float32 o and a float32 dO from numpy:
    ``mode`` "plain"; "bf16_do" (dO exactly bf16, as bf16 training hands
    it over); "scaled" (v and dO times 1e3: dO's pieces near 1e3, dS's
    near 1e6)."""
    q, k, v, do = _rand(seed, (B, H, Sq, D), (B, Hkv, Skv, D),
                        (B, Hkv, Skv, D), (B, H, Sq, D), dtype=np.float32)
    c = 1e3 if mode == "scaled" else 1.0
    q, k = (torch.from_numpy(x).bfloat16() for x in (q, k))
    v = (torch.from_numpy(v) * c).bfloat16()
    o = t_ref.flash_attention_ref(q, k, v, causal, out_dtype=torch.float32)
    do = torch.from_numpy(do) * c
    if mode == "bf16_do":
        do = do.bfloat16().float()
    return q, k, v, o, do, (c * c, c * c, c)


def _used(got, want, scales):
    """The largest share of the card test's float32 limit, 1e-5 (1 +
    |want|) in units of each gradient's scale, that an element uses."""
    return max(float(((g - w).abs() / (1e-5 * (c + w.abs()))).max())
               for g, w, c in zip(got, want, scales))


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal,mode", [
    (1, 3, 1, 256, 256, 64, True, "plain"),     # smollm training, one kv head
    (1, 3, 1, 256, 256, 64, True, "bf16_do"),
    (1, 3, 1, 256, 256, 64, True, "scaled"),
    (1, 2, 1, 300, 300, 16, True, "plain"),     # D 16 ragged
    (1, 4, 4, 128, 128, 112, True, "plain"),    # zamba2's head size
    (1, 8, 1, 130, 130, 128, True, "plain"),    # group 8 at D 128
    (1, 2, 2, 300, 300, 64, False, "plain"),    # whisper's encoder, cut
    (1, 2, 2, 128, 300, 64, False, "scaled"),   # cross-attention
])
def test_split_sums_hold_the_plain_backward(B, H, Hkv, Sq, Skv, D, causal,
                                            mode):
    """The bf16 kernels' sums, emulated in float32, hold
    ``ref.flash_attention_bwd_ref`` (float32 from the same bf16 inputs)
    within the card test's unchanged float32 limit: three pieces and the
    six P^T dO products.  At the causal Sq 256 shape, where column 0 sums
    the most P, two pieces, or three with only dv's hi-dO products, miss
    it: that is why the kernels split in three."""
    q, k, v, o, do, scales = _bf16_case(B, H, Hkv, Sq, Skv, D, causal, mode)
    want = t_ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                         o, do, causal)
    assert _used(_split_sums_bwd(q, k, v, o, do, causal), want, scales) <= 1
    if Sq == 256 and causal and mode == "plain":
        assert _used(_split_sums_bwd(q, k, v, o, do, causal, pieces=2),
                     want, scales) > 1
        assert _used(_split_sums_bwd(q, k, v, o, do, causal,
                                     dv_terms=DV_TERMS[:3]), want,
                     scales) > 1


def _round_toward_zero(x):
    """float64 x to float32, rounded toward zero."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def test_truncating_accumulation_stays_within_the_limit():
    """The tensor cores' float32 accumulation need not round to nearest.
    Even if every mma.sync rounded its sum toward zero, dq summed as the
    kernel orders it -- 16 kv columns a product, dS's three pieces in
    turn, 1024 columns -- holds the plain version within 0.5 of the card
    test's float32 limit."""
    B, H, S, D = 1, 1, 1024, 64
    q, k, v, o, do, _ = _bf16_case(B, H, H, S, S, D, True, "plain")
    want = t_ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                         o, do, True)[0][0, 0].double()
    s, valid, kk = t_ref._scores(q, k, True, 0, S)
    m = s.amax(dim=-1, keepdim=True)
    lse = m + torch.log(torch.exp(s - m).sum(dim=-1, keepdim=True))
    p = torch.where(valid, torch.exp(s - lse), torch.zeros_like(s))
    ds = p * (do @ v.float().transpose(-1, -2) - (do * o).sum(-1, True))
    pieces = [x[0, 0].double().numpy() for x in _split(ds)]
    kd = kk[0, 0].double().numpy()
    acc = np.zeros((S, D), np.float32)
    for c0 in range(0, S, 16):
        for x in pieces:
            acc = _round_toward_zero(acc.astype(np.float64) +
                                     x[:, c0:c0 + 16] @ kd[c0:c0 + 16])
    got = torch.from_numpy(acc.astype(np.float64)) * (1.0 / D ** 0.5)
    assert _used([got], [want], [1.0]) <= 0.5
