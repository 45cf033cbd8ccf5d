"""Parity of the port's flash attention (K10) and the LM zoo's attention
functions against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  On the
CPU the port runs K10's plain version (``kernels/attention/ref.py``); the
JAX side runs its Pallas kernel in interpret mode (``ops.flash_attention``
and, for the decode geometry it cannot pad to, ``flash_attention_pallas``
itself) and its jnp oracle.  The CUDA kernel is held to the plain version
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on the card.

Tolerances:
* float32: 2e-5 absolute and relative, as the JAX package's own
  kernel-vs-oracle test -- only the order of float32 sums differs.
* bf16: both sides compute in float32 from the same bf16 inputs and
  round each p to bf16 -- the Pallas kernel and the plain version p
  before dividing by l, jnp's model functions the normalised p / l --
  and, for a bf16 output, round the output.  Each rounding is within
  2**-8 of its value, so element by element the two sides differ by at
  most 2**-7 * sum_j (p_j / l) |v_j| (+ 2**-7 |o| for a bf16 output):
  ``ref.bf16_rounding_bound``, computed from the inputs.  The float32
  tolerance is added for the order of float32 sums.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.attention.flash import flash_attention_pallas  # noqa: E402
from repro.kernels.attention.ops import flash_attention as j_flash  # noqa: E402
from repro.kernels.attention.ref import attention_ref as j_ref  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402

from repro_torch.kernels.attention import ops as t_ops  # noqa: E402
from repro_torch.kernels.attention import ref as t_ref  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402

F32_TOL = 2e-5

# tests/test_kernels.py::ATTN_CASES: B, H, Hkv, Sq, Skv, D, causal
ATTN_CASES = [
    (1, 4, 4, 64, 64, 32, True),
    (2, 8, 2, 128, 128, 64, True),      # GQA
    (1, 4, 4, 1, 128, 64, True),        # decode
    (2, 6, 3, 37, 100, 16, True),       # ragged + GQA
    (1, 4, 2, 64, 64, 32, False),       # bidirectional
]
# decode against a longer cache: B, H, Hkv, Skv, D, kv_len (offset kv_len-1)
DECODE_CASES = [
    (2, 6, 3, 128, 16, 37),
    (1, 4, 2, 64, 32, 1),
    (2, 9, 3, 256, 64, 255),
]


def _qkv(seed, B, H, Hkv, Sq, Skv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32))


def _t(*xs, dtype=torch.float32):
    return [torch.tensor(x).to(dtype) for x in xs]


def _assert_bf16_close(got, want, bound):
    """|got - want| <= bound + the float32 tolerance, element by element."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    lim = np.asarray(bound, np.float32) + F32_TOL * (1.0 + np.abs(want))
    assert (err <= lim).all(), (
        f"max abs err {err.max():.3e}, {(err / lim).max():.3f} of the limit")


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal", ATTN_CASES)
def test_plain_k10_matches_pallas_and_oracle_f32(B, H, Hkv, Sq, Skv, D,
                                                 causal):
    q, k, v = _qkv(B * Sq + Skv, B, H, Hkv, Sq, Skv, D)
    got = t_ops.flash_attention(*_t(q, k, v), causal=causal).numpy()
    pallas = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, bq=64, bk=64)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(got, np.asarray(j_ref(q, k, v, causal=causal)),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal", ATTN_CASES)
def test_plain_k10_matches_pallas_bf16(B, H, Hkv, Sq, Skv, D, causal):
    q, k, v = _qkv(B * Sq + Skv, B, H, Hkv, Sq, Skv, D)
    tq, tk, tv = _t(q, k, v, dtype=torch.bfloat16)
    got = t_ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    pallas = j_flash(jq, jk, jv, causal=causal, bq=64, bk=64)
    _assert_bf16_close(got.float().numpy(), pallas,
                       t_ref.bf16_rounding_bound(tq, tk, tv, causal=causal))


@pytest.mark.parametrize("B,H,Hkv,Skv,D,kv_len", DECODE_CASES)
def test_plain_k10_decode_geometry(B, H, Hkv, Skv, D, kv_len):
    """One query at the end of a partly filled cache: offset = kv_len - 1
    with kv_len < Skv, against the Pallas kernel given that geometry, the
    JAX model's decode attention and the port's."""
    q, k, v = _qkv(kv_len, B, H, Hkv, 1, Skv, D)
    got = t_ops.flash_attention(*_t(q, k, v), causal=True,
                                offset=kv_len - 1, kv_len=kv_len).numpy()
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True, bq=1,
                                    bk=min(64, Skv), offset=kv_len - 1,
                                    kv_len=kv_len, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=F32_TOL,
                               atol=F32_TOL)
    # model layouts: q [B, 1, H, D], caches [B, S, Hkv, D]
    qm, km, vm = (x.transpose(0, 2, 1, 3) for x in (q, k, v))
    want = j_attn.decode_attention(jnp.asarray(qm), jnp.asarray(km),
                                   jnp.asarray(vm), kv_len, jnp.float32)
    port = t_attn.decode_attention(*_t(qm, km, vm), kv_len, torch.float32)
    assert port.shape == (B, 1, H, D) and port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(port.numpy(), got.transpose(0, 2, 1, 3),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", [(96, 32), (37, 1024)])
def test_model_attention_matches_jax(dtype, S, chunk):
    """``chunked_causal_attention`` and ``decode_attention`` of the port
    (K10) against the JAX model's jnp versions, float32 out."""
    rng = np.random.default_rng(S)
    B, H, Hkv, D = 2, 6, 2, 16
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    # the bound's inputs: q, k, v rounded to the compute dtype, [B, H, S, D]
    bq, bk, bv = (x.transpose(1, 2) for x in _t(q, k, v, dtype=td))

    def check(got, want, **geometry):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=F32_TOL, atol=F32_TOL)
        else:
            bound = t_ref.bf16_rounding_bound(bq[:, :, :got.shape[1]], bk,
                                              bv, out_dtype=torch.float32,
                                              **geometry)
            _assert_bf16_close(got.numpy(), want, bound.transpose(1, 2))

    want = j_attn.chunked_causal_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), chunk=chunk,
                                           compute_dtype=jd)
    got = t_attn.chunked_causal_attention(*_t(q, k, v), chunk=chunk,
                                          compute_dtype=td)
    assert got.shape == (B, S, H, D) and got.dtype == torch.float32
    check(got, want)
    for t_pos in (1, S // 2, S):
        want = j_attn.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k),
                                       jnp.asarray(v), t_pos, jd)
        got = t_attn.decode_attention(*_t(q[:, :1], k, v), t_pos, td)
        check(got, want, offset=t_pos - 1, kv_len=t_pos)


def test_repeat_kv_matches_jax():
    k = np.random.default_rng(0).standard_normal((2, 5, 3, 4)).astype(
        np.float32)
    for g in (1, 3):
        np.testing.assert_array_equal(
            t_attn.repeat_kv(torch.tensor(k), g).numpy(),
            np.asarray(j_attn.repeat_kv(jnp.asarray(k), g)))


def test_plain_k10_reads_strided_views():
    """The model hands K10 ``transpose(1, 2)`` views of [B, S, H, D]
    activations; the result equals that of contiguous copies."""
    q, k, v = _qkv(3, 2, 6, 3, 37, 100, 16)
    qs, ks, vs = (torch.tensor(x).transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    assert not qs.is_contiguous()
    np.testing.assert_array_equal(
        t_ops.flash_attention(qs, ks, vs, offset=63).numpy(),
        t_ops.flash_attention(*_t(q, k, v), offset=63).numpy())


@pytest.mark.parametrize("kw,match", [
    (dict(kv_len=0), "kv_len"),
    (dict(kv_len=101), "kv_len"),
    (dict(offset=-1), "offset"),
])
def test_geometry_without_a_valid_column_is_refused(kw, match):
    """Where a query row would see no column, the Pallas kernel averages
    its padded tiles and the oracle gives NaN: the port refuses it."""
    q, k, v = _qkv(0, 1, 2, 1, 4, 100, 16)
    with pytest.raises(ValueError, match=match):
        t_ops.flash_attention(*_t(q, k, v), causal=True, **kw)
    with pytest.raises(ValueError, match="GQA"):
        t_ref.flash_attention_ref(*_t(q, k[:, :, :, :8], v[:, :, :, :8]))
