"""The spike-parcel packer K9 on the CPU: the model of its kernel's schedule
(``ref.compact_rows_packed_ref``: 16-byte groups of the transport's [M, D]
mask bytes, per-row bit masks, warp counts and their scan) against the
plain version (``ref.compact_rows_ref``), JAX's ``compact_rows_ref`` and
its ``compact_rows_pallas`` in interpret mode, in the transposed and the
contiguous layout; and the CUDA wrapper's refusals.  Every output is an
integer or a copied float64, so every comparison is exact."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)

from repro.kernels.event_wheel import ref as jref  # noqa: E402
from repro.kernels.event_wheel.event_wheel import \
    compact_rows_pallas  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.event_wheel import event_wheel as tew_cuda  # noqa: E402,E501
from repro_torch.kernels.event_wheel import ops as ew_ops  # noqa: E402
from repro_torch.kernels.event_wheel import ref as tref  # noqa: E402

# (M, density, cap): M no multiple of 16 / D, sparse to full rows, caps
# below and above the row length
CASES = [(100, 0.05, 8), (100, 0.5, 64), (100, 1.0, 100), (333, 0.3, 400),
         (1000, 0.0, 16), (1000, 0.05, 1), (4096, 0.03, 2048)]


def _inputs(D, M, density, layout, seed):
    rng = np.random.default_rng(seed)
    stored = rng.random((M, D)) < density              # the transport's [M, D]
    mask = torch.from_numpy(stored).T
    if layout == "contiguous":
        mask = mask.contiguous()
    row = torch.from_numpy(rng.random(M) * 20.0)
    return mask, row[None, :].expand(D, M)


@pytest.mark.parametrize("D", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("layout", ["transposed", "contiguous"])
@pytest.mark.parametrize("M,density,cap", CASES)
def test_packed_schedule_matches_plain_and_jax(D, layout, M, density, cap):
    mask, vals = _inputs(D, M, density, layout, M + D + cap)
    over = D > 1 and cap < M
    if over:
        mask[D - 1, : cap + 3] = True                  # a row over its cap
    want = tref.compact_rows_ref(mask, vals, cap)
    for threads in (tref.PASS_THREADS, 32):            # one pass and many
        got = tref.compact_rows_packed_ref(mask, vals, cap, threads=threads)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    for g, w in zip(ew_ops.spike_compact(mask, vals, cap), want):
        assert torch.equal(g, w)
    m_np, v_np = jnp.asarray(mask.numpy()), jnp.asarray(vals.numpy())
    for jax_out in (jref.compact_rows_ref(m_np, v_np, cap=cap),
                    compact_rows_pallas(m_np, v_np, cap=cap, interpret=True)):
        for g, w in zip(want, jax_out):
            assert np.array_equal(g.numpy(), np.asarray(w))
    if over:
        assert int(want[2][D - 1]) > cap


def test_packed_schedule_reads_interleaved_rows():
    """Row d of a transposed [M, D] mask is every D-th stored byte from d:
    one set column per row lands in that row alone."""
    D, M = 4, 40
    stored = torch.zeros((M, D), dtype=torch.bool)
    for d in range(D):
        stored[3 + 7 * d, d] = True
    idx, _, cnt = tref.compact_rows_packed_ref(stored.T, torch.zeros(D, M), 2)
    assert cnt.tolist() == [1, 1, 1, 1]
    assert idx[:, 0].tolist() == [3, 10, 17, 24] and (idx[:, 1] == M).all()


def test_compact_rows_wrapper_refuses_cpu_and_bad_inputs():
    """The CUDA wrapper raises on what its kernel does not take, before
    any build or launch."""
    build.reset_launches()
    m = torch.ones((2, 5), dtype=torch.bool)
    v = torch.zeros((2, 5), dtype=torch.float64)
    for mask in (m, m.to(torch.int32), m[0]):
        with pytest.raises(ValueError, match=r"mask must be a bool\[D, M\]"):
            tew_cuda.compact_rows_cuda(mask, v, 3)
    assert all(x == 0 for x in build.launches().values())
