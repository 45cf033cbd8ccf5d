"""Parity of the port's compaction, compact-gather and segment-rank plain
versions (the functions kernels K6, K7 and K8 compute) against the JAX
package, on the CPU; the CPU models of K7's and K8's schedules
(``ref.compact_gather_sched_ref``, ``ref.segment_rank_split_ref``)
against both; the wrappers' refusals.

Inputs are made with numpy from a seed.  The JAX side runs as its own
tests run it (``tests/test_active_set.py``, ``tests/test_event_wheel.py``):
the jnp oracles of ``repro/kernels/event_wheel/ref.py`` and the Pallas
kernels in interpret mode.  Every output is an integer, so every
comparison is exact; segment ranks are compared on valid keys against
JAX's scatter ranking, which ranks invalid ones differently.  The CUDA
kernels are held to these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)

from repro.kernels.event_wheel import ops as jew_ops  # noqa: E402
from repro.kernels.event_wheel import ref as jew_ref  # noqa: E402
from repro.kernels.event_wheel.event_wheel import segment_rank_pallas  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.event_wheel import event_wheel as tew_cuda  # noqa: E402,E501
from repro_torch.kernels.event_wheel import ops as tew_ops  # noqa: E402
from repro_torch.kernels.event_wheel import ref as tew_ref  # noqa: E402

FRACS = (0.0, 0.1, 0.5, 1.0)     # empty, sparse, half and full masks


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n", [1, 255, 256, 700])
@pytest.mark.parametrize("cap", [1, 16, 256, 1000])
def test_compact_ids_plain_matches_jax(n, cap):
    rng = np.random.default_rng(n * 7 + cap)
    for frac in FRACS:
        m = rng.random(n) < frac
        ids, cnt = tew_ops.compact_ids(torch.from_numpy(m), cap)
        assert ids.dtype == cnt.dtype == torch.int32 and ids.shape == (cap,)
        ja, ca = jew_ref.compact_ids_ref(jnp.asarray(m), cap)
        jb, cb = jew_ops.compact_ids(jnp.asarray(m), cap, impl="pallas")
        _eq(ids, ja)
        _eq(ids, jb)
        assert int(cnt) == int(ca) == int(cb) == int(m.sum())
        want = np.flatnonzero(m)[:cap]
        assert np.array_equal(ids.numpy()[: len(want)], want)
        assert (ids.numpy()[len(want):] == n).all()


@pytest.mark.parametrize("n,mo", [(1, 3), (255, 5), (256, 4), (700, 9)])
@pytest.mark.parametrize("cap", [1, 16, 300])
def test_compact_gather_plain_matches_jax(n, mo, cap):
    rng = np.random.default_rng(n + mo + cap)
    table = rng.integers(0, 999, (n, mo)).astype(np.int32)
    for frac in FRACS:
        m = rng.random(n) < frac
        ids, rows, cnt = tew_ops.compact_gather(
            torch.from_numpy(m), torch.from_numpy(table), cap, fill=777)
        ja, ra, ca = jew_ref.compact_gather_ref(jnp.asarray(m),
                                                jnp.asarray(table), cap, 777)
        jb, rb, cb = jew_ops.compact_gather(jnp.asarray(m),
                                            jnp.asarray(table), cap,
                                            fill=777, impl="pallas")
        for port, a, b in ((ids, ja, jb), (rows, ra, rb)):
            _eq(port, a)
            _eq(port, b)
        assert rows.dtype == torch.int32 and rows.shape == (cap, mo)
        assert int(cnt) == int(ca) == int(cb) == int(m.sum())


def test_compact_gather_default_fill_is_n():
    m = torch.tensor([False, True, False])
    ids, rows, cnt = tew_ops.compact_gather(
        m, torch.arange(6, dtype=torch.int32).reshape(3, 2), 3)
    assert ids.tolist() == [1, 3, 3] and int(cnt) == 1
    assert rows.tolist() == [[2, 3], [3, 3], [3, 3]]


@pytest.mark.parametrize("n,mo", [(1, 1), (255, 5), (700, 33), (4097, 7)])
@pytest.mark.parametrize("cap", [1, 16, 300, 5000])
def test_compact_gather_schedule_matches_plain_and_jax(n, mo, cap):
    """K7's schedule (K6's pass, then the entries split over 1-32 blocks,
    each thread's (slot, column) advanced by adds, trips of 8 loads before
    their stores, every entry written once) gives the plain version's ids,
    rows and count and JAX's, at odd MO, with caps below and above the
    count."""
    rng = np.random.default_rng(n * 5 + mo + cap)
    table = rng.integers(-999, 999, (n, mo)).astype(np.int32)
    for frac in FRACS:
        m = rng.random(n) < frac
        want = tew_ref.compact_gather_ref(torch.from_numpy(m),
                                          torch.from_numpy(table), cap, -3)
        ja, ra, ca = jew_ops.compact_gather(jnp.asarray(m), jnp.asarray(table),
                                            cap, fill=-3)
        _eq(want[0], ja)
        _eq(want[1], ra)
        assert int(want[2]) == int(ca)
        for blocks in (1, 2, 3, 32):
            got = tew_ref.compact_gather_sched_ref(
                torch.from_numpy(m), torch.from_numpy(table), cap, -3,
                blocks=blocks)
            for g, w in zip(got, want):
                assert torch.equal(g, w)


def test_horizon_and_gather_wrappers_refuse_cpu_and_bad_inputs():
    """K5's and K7's CUDA wrappers raise the same ValueErrors as before on
    what their kernels do not take, before any build or launch."""
    build.reset_launches()
    tc = torch.zeros(6, dtype=torch.float64)
    pre = torch.zeros((2, 6), dtype=torch.int32)
    dly = torch.zeros((2, 6), dtype=torch.float64)
    kw = dict(t_end=1.0, horizon_cap=1.0)
    with pytest.raises(ValueError, match="t_clock must be"):
        tew_cuda.horizon_score_cuda(tc, pre, dly, **kw)
    m = torch.ones(6, dtype=torch.bool)
    with pytest.raises(ValueError, match="contiguous bool"):
        tew_cuda.compact_gather_cuda(m, pre.T.contiguous(), 2, 6)
    with pytest.raises(ValueError, match="contiguous bool"):
        tew_cuda.compact_gather_cuda(m[::2], pre, 2, 6)
    assert all(v == 0 for v in build.launches().values())


@pytest.mark.parametrize("E,n_keys,max_rank", [(1, 4, 3), (37, 12, 4),
                                               (255, 3, 17), (256, 50, 6),
                                               (700, 7, 3), (600, 600, 0)])
def test_segment_rank_plain_matches_jax(E, n_keys, max_rank):
    rng = np.random.default_rng(E + n_keys)
    key = rng.integers(0, n_keys + 1, E).astype(np.int32)   # n_keys: invalid
    rank = tew_ops.segment_rank(torch.from_numpy(key), max_rank)
    assert rank.dtype == torch.int32 and rank.shape == (E,)
    _eq(rank, jew_ref.segment_rank_ref(jnp.asarray(key), max_rank))
    # the pairwise Pallas kernel ranks every event the same way
    be = 128
    pad = (-E) % be
    kp = np.concatenate([key, np.full(pad, n_keys + 1, np.int32)])
    pal = segment_rank_pallas(jnp.asarray(kp), max_rank=max_rank, block_e=be,
                              interpret=True)[:E]
    _eq(rank, pal)
    # JAX's scatter ranking agrees on valid keys
    valid = key < n_keys
    sc = np.asarray(jew_ops.segment_rank(jnp.asarray(key), n_keys, max_rank,
                                         impl="scatter"))
    np.testing.assert_array_equal(rank.numpy()[valid], sc[valid])


def test_segment_rank_counts_earlier_equal_keys():
    key = torch.tensor([5, 5, 2, 5, 2, 5, 5], dtype=torch.int32)
    assert tew_ops.segment_rank(key, 3).tolist() == [0, 1, 0, 2, 1, 3, 3]


@pytest.mark.parametrize("k", [1, 5, 40, 64, 100])
def test_select_threshold_matches_select_earliest(k):
    rng = np.random.default_rng(k)
    score = rng.uniform(0.0, 5.0, 64)
    score[rng.random(64) < 0.3] = np.inf
    score[3] = score[7]                                      # a tie
    s = torch.from_numpy(score)
    tau = tew_ops.select_threshold(s, k)
    sel = torch.isfinite(s) & (s <= tau)
    want = tew_ref.select_earliest_ref(s, k)
    assert torch.equal(sel, want)
    _eq(want, jew_ref.select_earliest_ref(jnp.asarray(score), k))
    assert float(tau) == float(jew_ops.select_threshold(jnp.asarray(score),
                                                         k))


def test_plain_versions_launch_nothing():
    """CPU tensors take the plain versions: no kernel is launched."""
    build.reset_launches()
    m = torch.ones(10, dtype=torch.bool)
    tew_ops.compact_ids(m, 4)
    tew_ops.compact_gather(m, torch.zeros((10, 2), dtype=torch.int32), 4)
    tew_ops.segment_rank(torch.zeros(9, dtype=torch.int32), 2)
    assert all(v == 0 for v in build.launches().values())


def _rank_keys(kind, E, rng):
    """Key batches of the wheel's shape: ``target * B + bucket`` for valid
    events and the invalid key N * B (N = 64, B = 16) for the rest."""
    n_keys = 64 * 16
    if kind == "path":           # mostly distinct valid keys, then a tail
        key = rng.integers(0, n_keys, E)                # of empty slots
        key[E // 2:] = n_keys
    elif kind == "few":
        key = rng.integers(0, 5, E)
    elif kind == "equal":
        key = np.full(E, 7)
    else:                        # every event invalid
        key = np.full(E, n_keys)
    return key.astype(np.int32)


@pytest.mark.parametrize("E", [0, 1, 31, 33, 4225])
@pytest.mark.parametrize("kind", ["path", "few", "equal", "invalid"])
@pytest.mark.parametrize("max_rank", [0, 1, 19])
def test_segment_rank_split_schedule_matches_plain_and_jax(E, kind, max_rank):
    """K8's schedule (front/back events per block, lane-strided 16-byte
    words, chunked staging, early stop at max_rank) gives the plain
    version's ranks, JAX's pairwise oracle's and its Pallas kernel's."""
    key = _rank_keys(kind, E, np.random.default_rng(E + max_rank))
    want = tew_ref.segment_rank_ref(torch.from_numpy(key), max_rank)
    for chunk in (tew_ref.RANK_CHUNK, 256):
        got = tew_ref.segment_rank_split_ref(torch.from_numpy(key), max_rank,
                                             chunk=chunk)
        assert got.dtype == torch.int32 and got.shape == (E,)
        assert torch.equal(got, want)
    if E == 0:
        return
    _eq(want, jew_ref.segment_rank_ref(jnp.asarray(key), max_rank))
    be = 512
    kp = np.concatenate([key, np.full((-E) % be, -1, np.int32)])
    _eq(want, segment_rank_pallas(jnp.asarray(kp), max_rank=max_rank,
                                  block_e=be, interpret=True)[:E])


@pytest.mark.parametrize("E", [0, 1, 2, 15, 16, 17, 31, 32, 33, 63, 64, 65,
                               4223, 4224, 4225, 60000])
def test_segment_rank_blocks_serve_each_event_once(E):
    """Every event has exactly one warp, and a block's events compare only
    keys it stages (below the largest event it serves)."""
    ev = tew_ref.segment_rank_events(E)
    assert ev.shape == (-(-E // 32), 32)
    live = ev[ev >= 0]
    assert torch.equal(torch.sort(live).values, torch.arange(E))
    if E:          # the busiest block compares about half the pairs' keys
        work = torch.where(ev >= 0, ev, 0).sum(1)
        assert int(work.max()) <= 16 * E


def test_segment_rank_wrapper_refuses_cpu_and_bad_inputs():
    """The CUDA wrapper raises on what its kernel does not take, before
    any build or launch."""
    build.reset_launches()
    good = torch.zeros(8, dtype=torch.int32)
    for key in (good, good.to(torch.int64), good.reshape(2, 4), good[::2]):
        with pytest.raises(ValueError, match="contiguous int32"):
            tew_cuda.segment_rank_cuda(key, 3)
    with pytest.raises(ValueError, match="contiguous int32"):
        tew_cuda.segment_rank_cuda(good, -1)
    with pytest.raises(ValueError, match="contiguous bool"):
        tew_cuda.compact_ids_cuda(torch.ones(4, dtype=torch.bool), 2)
    assert all(v == 0 for v in build.launches().values())
