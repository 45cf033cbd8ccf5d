"""The port's CUDA kernels against their plain PyTorch versions, and the
card against the CPU, on a card.

Needs no JAX (the card's machine has none); every test skips without a
CUDA device.  Run there with ``PYTHONPATH=src python -m pytest
--noconftest -m cuda tests/test_torch_cuda.py`` (the suite's conftest
imports JAX).
The arithmetic of the neuron core is the same on the card as in the plain
versions (``repro_torch/core/detmath.py``, ``-fmad=false``), so those
comparisons are bitwise.  Flash attention (K10) and the LM path are held
to stated tolerances instead (``K10_TOL``, ``LM_TOL``).
"""
import numpy as np
import pytest
import torch

from repro_torch import sched
from repro_torch.core import morphology, network
from repro_torch.core.cell import CellModel
from repro_torch.core.exec_fap import make_fap_vardt_runner
from repro_torch.core.hines import hines_assemble
from repro_torch.kernels import build
from repro_torch.kernels.event_wheel import ops as ew_ops
from repro_torch.kernels.event_wheel import ref as ew_ref
from repro_torch.kernels.hh_rhs import ops as hh_ops
from repro_torch.kernels.hh_rhs import ref as hh_ref
from repro_torch.kernels.hines import ops as h_ops
from repro_torch.kernels.hines import ref as h_ref


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _eq(a, b):
    assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["soma", "ball_and_stick", "branched"])
def test_kernels_bitwise_equal_to_plain(dev, name):
    m = morphology.by_name(name)
    g = torch.Generator().manual_seed(m.n_comp)
    N, C = 777, m.n_comp
    par = torch.as_tensor(m.parent, dtype=torch.int32)
    gax = torch.as_tensor(m.g_axial)
    d = hines_assemble(m.parent, gax, torch.rand((N, C), generator=g,
                                                 dtype=torch.float64) + 0.5)
    b = torch.randn((N, C), generator=g, dtype=torch.float64)
    build.reset_launches()
    de = h_ops.hines_factor(par.to(dev), gax.to(dev), d.T.to(dev))
    _eq(de, h_ref.hines_factor_ref(par, gax, d.T))
    x = h_ops.hines_solve_factored(par.to(dev), gax.to(dev), de, b.T.to(dev))
    _eq(x, h_ref.hines_solve_factored_ref(par, gax, de.cpu(), b.T))
    area = torch.as_tensor(m.area)
    v = torch.rand((N, C), generator=g, dtype=torch.float64) * 140.0 - 90.0
    mhn = [torch.rand((N, C), generator=g, dtype=torch.float64)
           for _ in range(3)]
    for a, r in zip(hh_ops.hh_rhs(area.to(dev), v.to(dev),
                                  *[t.to(dev) for t in mhn]),
                    hh_ref.hh_rhs_ref(area, v, *mhn)):
        _eq(a, r)
    net = network.make_network(1000, k_in=16, seed=2)
    pre, dly = ew_ops.by_post_layout(net, "cpu")
    tc = torch.rand(1000, generator=g, dtype=torch.float64) * 3.0
    for a, r in zip(ew_ops.horizon_score(tc.to(dev), pre.to(dev), dly.to(dev),
                                         t_end=20.0, horizon_cap=2.0),
                    ew_ops.horizon_score(tc, pre, dly, t_end=20.0,
                                         horizon_cap=2.0)):
        _eq(a, r)
    assert build.launches() == {"hines_factor": 1, "hines_solve_factored": 1,
                                "hines_solve": 0, "hh_rhs": 1,
                                "horizon_score": 1, "compact_ids": 0,
                                "compact_gather": 0, "segment_rank": 0,
                                "compact_rows": 0, "flash_attention": 0,
                                "flash_attention_f32_decode": 0,
                                "flash_attention_f32_prefill": 0,
                                "flash_attention_prefill": 0,
                                "flash_attention_decode": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["soma", "ball_and_stick", "branched"])
@pytest.mark.parametrize("N", [1, 777, 16384])
def test_fused_solve_bitwise_equal_to_plain_and_factored(dev, name, N):
    """K3 against its plain version and against K2(K1(d), b), on [C, N]
    inputs and on transposed [N, C] rows; the inputs stay untouched."""
    m = morphology.by_name(name)
    g = torch.Generator().manual_seed(N + m.n_comp)
    C = m.n_comp
    par = torch.as_tensor(m.parent, dtype=torch.int32)
    gax = torch.as_tensor(m.g_axial)
    d = hines_assemble(m.parent, gax, torch.rand((N, C), generator=g,
                                                 dtype=torch.float64) + 0.5)
    b = torch.randn((N, C), generator=g, dtype=torch.float64)
    pd, gd, dT, bT = par.to(dev), gax.to(dev), d.T.to(dev), b.T.to(dev)
    build.reset_launches()
    x = h_ops.hines_solve(pd, gd, dT, bT)
    assert build.launches()["hines_solve"] == 1
    _eq(x, h_ref.hines_solve_ref(par, gax, d.T, b.T))
    _eq(x, h_ops.hines_solve_factored(pd, gd, h_ops.hines_factor(pd, gd, dT),
                                      bT))
    rows_d, rows_b = d.to(dev), b.to(dev)
    _eq(h_ops.hines_solve(pd, gd, rows_d.T, rows_b.T), x)
    _eq(rows_d, d)
    _eq(rows_b, b)


# K2's morphologies: C = 1, 11, 13 (the main path's cell), 29 and 61 (a
# tile above 48 KB of shared memory)
K2_MORPHS = {"soma": morphology.soma_only,
             "ball_and_stick": morphology.ball_and_stick,
             "branched_2_2": lambda: morphology.branched_tree(2, 2),
             "branched_3_2": lambda: morphology.branched_tree(depth=3),
             "branched_4_2": lambda: morphology.branched_tree(depth=4)}


def _k2_layout(layout, rows, n_factors):
    """The [C, N] operand of an [N, C] array in one of K2's three layouts:
    a contiguous [C, N] copy, the transposed rows, or the d_elim slice of
    [N, n_factors] factor rows (the main path's ``factors[:, :C].T``)."""
    N, C = rows.shape
    if layout == "cn":
        return rows.T.contiguous()
    if layout == "nc":
        return rows.T
    fac = torch.full((N, n_factors), float("nan"), dtype=torch.float64,
                     device=rows.device)
    fac[:, :C] = rows
    return fac[:, :C].T


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["cn", "nc", "factor_rows"])
@pytest.mark.parametrize("N", [1, 31, 777, 16384, 16421])
@pytest.mark.parametrize("name", list(K2_MORPHS))
def test_factored_solve_bitwise_in_every_layout(dev, name, N, layout):
    """K2 against its plain version and K3 == K2(K1), bitwise, with d_elim
    and b in a contiguous [C, N], a transposed [N, C] and the factor-row
    layout, for trees of 1, 11, 13, 29 and 61 compartments."""
    m = K2_MORPHS[name]()
    C = m.n_comp
    n_factors = CellModel(m, device="cpu").n_factors()
    g = torch.Generator().manual_seed(N * 31 + C)
    par = torch.as_tensor(m.parent, dtype=torch.int32)
    gax = torch.as_tensor(m.g_axial)
    d = hines_assemble(m.parent, gax, torch.rand((N, C), generator=g,
                                                 dtype=torch.float64) + 0.5)
    b = torch.randn((N, C), generator=g, dtype=torch.float64)
    pd, gd = par.to(dev), gax.to(dev)
    de_rows = h_ops.hines_factor(pd, gd, d.to(dev).T).T.contiguous()
    de = _k2_layout(layout, de_rows, n_factors)
    bv = _k2_layout(layout, b.to(dev), n_factors)
    build.reset_launches()
    x = h_ops.hines_solve_factored(pd, gd, de, bv)
    assert build.launches()["hines_solve_factored"] == 1
    _eq(x, h_ref.hines_solve_factored_ref(par, gax, de.cpu(), bv.cpu()))
    _eq(x, h_ops.hines_solve(pd, gd, _k2_layout(layout, d.to(dev),
                                                n_factors), bv))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["cn", "nc", "factor_rows"])
@pytest.mark.parametrize("N", [1, 31, 777, 16384, 16421])
@pytest.mark.parametrize("name", list(K2_MORPHS))
def test_factor_and_fused_solve_bitwise_in_every_layout(dev, name, N, layout):
    """K1 and K3, each against its plain version, bitwise, with d and b in
    K2's three layouts (a contiguous [C, N], a transposed [N, C] and the
    factor-row slice), for trees of 1, 11, 13, 29 and 61 compartments;
    the inputs stay untouched."""
    m = K2_MORPHS[name]()
    C = m.n_comp
    n_factors = CellModel(m, device="cpu").n_factors()
    g = torch.Generator().manual_seed(N * 37 + C)
    par = torch.as_tensor(m.parent, dtype=torch.int32)
    gax = torch.as_tensor(m.g_axial)
    d = hines_assemble(m.parent, gax, torch.rand((N, C), generator=g,
                                                 dtype=torch.float64) + 0.5)
    b = torch.randn((N, C), generator=g, dtype=torch.float64)
    pd, gd = par.to(dev), gax.to(dev)
    dv = _k2_layout(layout, d.to(dev), n_factors)
    bv = _k2_layout(layout, b.to(dev), n_factors)
    build.reset_launches()
    de = h_ops.hines_factor(pd, gd, dv)
    x = h_ops.hines_solve(pd, gd, dv, bv)
    n = build.launches()
    assert n["hines_factor"] == n["hines_solve"] == 1
    _eq(de, h_ref.hines_factor_ref(par, gax, d.T))
    _eq(x, h_ref.hines_solve_ref(par, gax, d.T, b.T))
    _eq(dv, d.T)
    _eq(bv, b.T)


@pytest.mark.cuda
@pytest.mark.parametrize("C,seed", [(2, 0), (17, 1), (64, 2), (64, 3),
                                    (200, 4), (282, 5)])
def test_factored_solve_bitwise_on_random_trees(dev, C, seed):
    """Each block derives its level schedule from parent: on seeded random
    Hines-ordered trees, from chains to bushes, up to K2's largest tile
    (C = 282), K1, K2 and K3 each bitwise against its plain version, and
    K3 == K2(K1)."""
    rng = np.random.default_rng(seed)
    span = int(rng.integers(1, C))
    parent = [-1] + [int(rng.integers(max(0, i - span), i))
                     for i in range(1, C)]
    N = 16421
    par = torch.as_tensor(parent, dtype=torch.int32)
    gax = torch.from_numpy(rng.uniform(0.1, 2.0, C))
    d = hines_assemble(parent, gax, torch.from_numpy(
        rng.uniform(0.5, 1.5, (N, C))))
    b = torch.from_numpy(rng.normal(size=(N, C)))
    pd, gd = par.to(dev), gax.to(dev)
    de = h_ops.hines_factor(pd, gd, d.to(dev).T)
    _eq(de, h_ref.hines_factor_ref(par, gax, d.T))
    x = h_ops.hines_solve_factored(pd, gd, de, b.to(dev).T)
    _eq(x, h_ref.hines_solve_factored_ref(par, gax, de.cpu(), b.T))
    x3 = h_ops.hines_solve(pd, gd, d.to(dev).T, b.to(dev).T)
    _eq(x3, h_ref.hines_solve_ref(par, gax, d.T, b.T))
    _eq(x, x3)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,C", [("hines_factor", 786),
                                      ("hines_solve_factored", 283),
                                      ("hines_solve", 416)])
def test_trees_over_a_kernel_tile_are_refused(dev, kernel, C):
    """A tree one compartment over a kernel's tile limit (K1 785, K2 282,
    K3 415) is refused with a ValueError naming the limit, and nothing is
    launched; at the limit it runs, bitwise equal to its plain version."""
    rng = np.random.default_rng(C)
    for c, refused in ((C, True), (C - 1, False)):
        parent = [-1] + [int(rng.integers(max(0, i - 8), i))
                         for i in range(1, c)]
        par = torch.as_tensor(parent, dtype=torch.int32)
        gax = torch.from_numpy(rng.uniform(0.1, 2.0, c))
        d = hines_assemble(parent, gax, torch.from_numpy(
            rng.uniform(0.5, 1.5, (40, c)))).T
        b = torch.from_numpy(rng.normal(size=(c, 40)))
        args = (d,) if kernel == "hines_factor" else (d, b)
        build.reset_launches()
        call = lambda: getattr(h_ops, kernel)(  # noqa: E731
            par.to(dev), gax.to(dev), *[a.to(dev) for a in args])
        if refused:
            with pytest.raises(ValueError, match="at most 232448"):
                call()
            assert build.launches()[kernel] == 0
        else:
            _eq(call(), getattr(h_ref, f"{kernel}_ref")(par, gax, *args))
            assert build.launches()[kernel] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 3, 8, 15])
@pytest.mark.parametrize("N", [1, 15, 16, 17, 255, 16384, 16385, 70000])
def test_compact_ids_bitwise_at_any_length_and_offset(dev, N, offset):
    """K6 against its plain version on a mask view ``offset`` bytes past
    an aligned buffer: caps 1, 16, 256, N and 2N at densities 0, 0.01,
    0.5 and 1 (counts below, at and above the cap)."""
    rng = np.random.default_rng(N * 16 + offset)
    build.reset_launches()
    calls = 0
    for frac in (0.0, 0.01, 0.5, 1.0):
        buf = torch.from_numpy(rng.random(N + 16) < frac)
        m = buf[offset:offset + N]
        card = buf.to(dev)[offset:offset + N]
        assert card.data_ptr() % 16 == offset
        for cap in sorted({1, 16, 256, N, 2 * N}):
            ids, cnt = ew_ops.compact_ids(card, cap)
            r_ids, r_cnt = ew_ref.compact_ids_ref(m, cap)
            assert ids.shape == (cap,) and cnt.shape == ()
            _eq(ids, r_ids)
            _eq(cnt, r_cnt)
            calls += 1
    _eq(card, m)                                   # the mask is untouched
    assert build.launches()["compact_ids"] == calls


@pytest.mark.cuda
def test_main_path_card_equals_cpu(dev):
    """A short network run: spike trains and final states bitwise equal."""
    out = []
    for d in (dev, torch.device("cpu")):
        model = CellModel(morphology.ball_and_stick(), device=d)
        net = network.make_network(24, k_in=4, seed=3)
        iinj = 0.3 * (1.0 + 0.2 * np.random.default_rng(0).random(24))
        res, rounds = make_fap_vardt_runner(model, net, iinj, 6.0,
                                            horizon_impl="fused", device=d)()
        out.append((res, rounds))
    (a, ra), (b, rb) = out
    assert ra == rb and int(a.rec.count.sum()) > 0
    _eq(a.rec.times, b.rec.times)
    _eq(a.y_final, b.y_final)
    assert int(a.n_steps) == int(b.n_steps)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 256, 700, 16384])
def test_compaction_kernels_bitwise_equal_to_plain(dev, n):
    """K6 and K7 against their plain versions: empty, sparse, half and
    full masks, caps below and above N."""
    rng = np.random.default_rng(n)
    table = torch.from_numpy(rng.integers(0, 10**6, (n, 9)).astype(np.int32))
    build.reset_launches()
    calls = 0
    for cap in (1, 16, 256, 1000):
        for frac in (0.0, 0.01, 0.5, 1.0):
            m = torch.from_numpy(rng.random(n) < frac)
            ids, cnt = ew_ops.compact_ids(m.to(dev), cap)
            r_ids, r_cnt = ew_ref.compact_ids_ref(m, cap)
            _eq(ids, r_ids)
            assert int(cnt) == int(r_cnt)
            for a, r in zip(ew_ops.compact_gather(m.to(dev), table.to(dev),
                                                  cap, fill=-3),
                            ew_ref.compact_gather_ref(m, table, cap, -3)):
                _eq(a, r)
            calls += 1
    torch.cuda.synchronize()
    launched = build.launches()
    assert launched["compact_ids"] == launched["compact_gather"] == calls


def _bits(x):
    """The bit patterns of a float64 tensor, so NaNs compare as bits."""
    return x.contiguous().view(torch.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 255, 16385])
@pytest.mark.parametrize("K", [1, 5, 16, 33])
def test_horizon_kernel_bitwise_at_any_k_and_edge_clocks(dev, K, N):
    """K5 against its plain version on the same card tensors, bit for bit
    (NaNs included): K of 1, 5, 33 (the generic body) and 16 (the main
    path's); clocks at t_end, at +-inf and NaN on a tenth of the neurons
    and neuron 0; horizon caps that put the clock within eps of its
    horizon, on both sides; candidates within eps of the clock."""
    rng = np.random.default_rng(K * 100003 + N)
    pre = torch.from_numpy(rng.integers(0, N, (K, N)).astype(np.int32))
    dly = rng.uniform(0.1, 3.0, (K, N))
    near = rng.random(N) < 0.2            # in-edges of ~0 delay
    dly[:, near] = rng.uniform(1e-13, 3e-12, (K, int(near.sum())))
    dly = torch.from_numpy(dly)
    pre_d, dly_d = pre.to(dev), dly.to(dev)
    build.reset_launches()
    calls = 0
    for special in (None, 20.0, np.inf, -np.inf, np.nan):
        tc = rng.uniform(0.0, 20.0, N)
        if special is not None:
            tc[rng.random(N) < 0.1] = special
            tc[0] = special
        tc_d = torch.from_numpy(tc).to(dev)
        for cap in (2.0, 0.5e-12, 1e-12, 2e-12):
            kw = dict(t_end=20.0, horizon_cap=cap)
            got = ew_ops.horizon_score(tc_d, pre_d, dly_d, **kw)
            want = ew_ref.horizon_gather_ref(tc_d, pre_d, dly_d, **kw)
            for g, w in zip(got, want):
                assert g.shape == (N,) and g.dtype == torch.float64
                _eq(_bits(g), _bits(w))
            calls += 1
            if special is None or not np.isnan(special):  # and the CPU's
                cpu = ew_ref.horizon_gather_ref(torch.from_numpy(tc), pre,
                                                dly, **kw)
                for g, w in zip(got, cpu):
                    _eq(_bits(g), _bits(w))
    torch.cuda.synchronize()
    assert build.launches()["horizon_score"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("mo", [1, 33, 64])
@pytest.mark.parametrize("cap", [1, 128, 16384, 60000])
def test_compact_gather_kernel_bitwise_at_any_cap_and_offset(dev, cap, mo):
    """K7 against its plain version: caps 1, 128 (the active path's spike
    cap), N = 16384 and 60000 (above N), MO 1, 33 (the path's out-edge
    table's) and 64, densities 0, 0.01, 0.5 and 1, mask views 0-15 bytes
    past an aligned buffer; the kernel's split of the entries over its 32
    blocks (ref.compact_gather_sched_ref models other splits on the
    CPU)."""
    N = 16384
    rng = np.random.default_rng(cap * 7 + mo)
    table = torch.from_numpy(rng.integers(-10**6, 10**6, (N, mo))
                             .astype(np.int32))
    table_d = table.to(dev)
    build.reset_launches()
    calls = 0
    for frac in (0.0, 0.01, 0.5, 1.0):
        for offset in range(16):
            buf = torch.from_numpy(rng.random(N + 16) < frac)
            m = buf[offset:offset + N]
            card = buf.to(dev)[offset:offset + N]
            assert card.data_ptr() % 16 == offset
            want = ew_ref.compact_gather_ref(m, table, cap, -7)
            got = ew_ops.compact_gather(card, table_d, cap, fill=-7)
            assert got[1].shape == (cap, mo)
            for a, r in zip(got, want):
                _eq(a, r)
            calls += 1
            _eq(card, m)                       # the mask is untouched
    torch.cuda.synchronize()
    assert build.launches()["compact_gather"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 31, 33, 255, 257, 4000, 4225, 18000, 60000])
def test_segment_rank_kernel_bitwise_equal_to_plain(dev, E):
    """K8 against its plain version on the same card: few, many and
    all-equal keys and the wheel's pattern (distinct keys, then the
    invalid key on every empty slot), max_rank 0 to 19, keys 16-byte
    aligned and one word off; E = 18000 stages its keys in one chunk past
    48 KB, E = 60000 in three."""
    rng = np.random.default_rng(E)
    wheel = rng.integers(0, 1024, E)
    wheel[E // 2:] = 1024
    cases = ((rng.integers(0, 4, E), 2), (rng.integers(0, 51, E), 6),
             (rng.integers(0, E + 6, E), 17), (rng.integers(0, 8, E), 0),
             (np.full(E, 7), 19), (wheel, 19))
    build.reset_launches()
    calls = 0
    for key, max_rank in cases:
        for offset in (0, 1):
            buf = np.concatenate([np.zeros(offset), key]).astype(np.int32)
            card = torch.from_numpy(buf).to(dev)[offset:]
            assert card.data_ptr() % 16 == 4 * offset
            _eq(ew_ops.segment_rank(card, max_rank),
                ew_ref.segment_rank_ref(card, max_rank))
            calls += 1
    torch.cuda.synchronize()
    assert build.launches()["segment_rank"] == calls


@pytest.mark.cuda
def test_active_path_card_equals_cpu_and_dense(dev):
    """The active-set path (binding batch cap, small spike cap, wheel,
    fused horizon) gives bitwise the same run on the card and the CPU;
    on the card batch_cap=0 equals the dense path exactly."""
    net = network.make_network(32, k_in=4, seed=3)
    iinj = 0.3 * (1.0 + 0.2 * np.random.default_rng(1).random(32))
    kw = dict(queue="wheel", wheel=sched.WheelSpec.auto(net),
              horizon_impl="fused")

    def go(d, **extra):
        model = CellModel(morphology.ball_and_stick(), device=d)
        return make_fap_vardt_runner(model, net, iinj, 6.0, device=d,
                                     **kw, **extra)()

    build.reset_launches()
    act = dict(batch="compact", batch_cap=8, fanout="compact", spike_cap=4)
    (a, ra), (b, rb) = go(dev, **act), go(torch.device("cpu"), **act)
    launched = build.launches()
    assert all(launched[k] > 0 for k in (
        "hines_factor", "hines_solve_factored", "hh_rhs", "horizon_score",
        "compact_ids", "compact_gather", "segment_rank"))
    assert ra == rb and int(a.rec.count.sum()) > 0
    _eq(a.rec.times, b.rec.times)
    _eq(a.y_final, b.y_final)
    assert int(a.n_steps) == int(b.n_steps) and int(a.dropped) == 0
    (c, rc), (d, rd) = go(dev, batch="compact", batch_cap=0,
                          fanout="compact"), go(dev)
    assert rc == rd
    _eq(c.rec.times, d.rec.times)
    _eq(c.y_final, d.y_final)
    assert int(c.n_events) == int(d.n_events)


@pytest.mark.cuda
def test_baselines_card_equal_cpu(dev):
    """Method 2a (BSP fixed, derivimplicit) and 2c under the iteration
    policy: bitwise the same run on the card and the CPU; the card's runs
    launch K3 (once per fixed step) and, under "iteration", never K1/K2."""
    from repro_torch.core.bdf import BDFOptions
    from repro_torch.core.exec_bsp import run_bsp_fixed
    net = network.make_network(24, k_in=4, seed=3)
    iinj = 0.3 * (1.0 + 0.2 * np.random.default_rng(0).random(24))
    out = {}
    for d in (dev, torch.device("cpu")):
        model = CellModel(morphology.ball_and_stick(), device=d)
        build.reset_launches()
        out[d.type, "2a"] = run_bsp_fixed(model, net, iinj, 6.0,
                                          method="derivimplicit", device=d)
        out[d.type, "2a-launches"] = build.launches()
        build.reset_launches()
        out[d.type, "2c"] = make_fap_vardt_runner(
            model, net, iinj, 6.0, opts=BDFOptions(jac_policy="iteration"),
            horizon_impl="fused", device=d)()[0]
        out[d.type, "2c-launches"] = build.launches()
    for k in ("2a", "2c"):
        a, b = out["cuda", k], out["cpu", k]
        assert int(a.rec.count.sum()) > 0
        _eq(a.rec.times, b.rec.times)
        _eq(a.y_final, b.y_final)
        assert int(a.n_steps) == int(b.n_steps)
        assert int(a.n_events) == int(b.n_events) and int(a.dropped) == 0
    assert out["cuda", "2a-launches"]["hines_solve"] == 240
    la = out["cuda", "2c-launches"]
    assert la["hines_solve"] > 0
    assert la["hines_factor"] == la["hines_solve_factored"] == 0
    assert int(out["cuda", "2c"].solver["nsetups"]) == \
        int(out["cuda", "2c"].solver["nni"])


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 255, 1024, 4096, 5000])
def test_row_compaction_kernel_bitwise_equal_to_plain(dev, M):
    """K9 against its plain version: empty, sparse, half and full rows,
    caps below and above M, a broadcast value row (the exchange's
    strides), D of 1, 3, 4 and 8, in the transport's transposed layout
    (strides (1, D)), in contiguous rows, and as a transposed view 1-15
    bytes past an aligned buffer."""
    rng = np.random.default_rng(M)
    build.reset_launches()
    calls = 0
    for layout in ("transposed", "contiguous", "offset"):
        for D in (1, 3, 4, 8):
            for cap in (1, 16, 1024, M + 3):
                for frac in (0.0, 0.05, 0.5, 1.0):
                    off = int(rng.integers(1, 16)) if layout == "offset" \
                        else 0
                    buf = torch.from_numpy(rng.random(M * D + off) < frac)
                    stored = buf.to(dev)[off:].view(M, D)
                    m = stored.T.contiguous() if layout == "contiguous" \
                        else stored.T
                    assert m.data_ptr() % 16 == off
                    row = torch.from_numpy(rng.random(M)).to(dev)
                    vals = row[None, :].expand(D, M)
                    got = ew_ops.spike_compact(m, vals, cap)
                    for a, r in zip(got,
                                    ew_ref.compact_rows_ref(m, vals, cap)):
                        _eq(a, r)
                    calls += 1
    torch.cuda.synchronize()
    assert build.launches()["compact_rows"] == calls


def _spmd_rank(group, transport):
    """One short SPMD run (N = 32 soma cells, 6 ms) on this rank; the
    launch counts of every rank."""
    from repro_torch.distributed.exchange import ExchangeSpec
    from repro_torch.distributed.fap_spmd import run_fap_spmd
    model = CellModel(morphology.soma_only(), device=group.device)
    net = network.make_network(32, k_in=4, seed=3)
    iinj = 0.16 + 0.004 * np.random.default_rng(1).standard_normal(32)
    build.reset_launches()
    res, rounds = run_fap_spmd(model, net, iinj, 6.0, group,
                               transport=transport,
                               exchange=ExchangeSpec(parcel_cap=8))
    counts = torch.tensor([list(build.launches().values())])
    return res, rounds, group.all_gather(counts, "other"), \
        list(build.launches())


@pytest.mark.cuda
@pytest.mark.parametrize("transport", ["sparse", "allgather"])
def test_spmd_four_ranks_on_one_card_equal_cpu(dev, transport):
    """Four ranks share cuda:0 over gloo: bitwise the same run as four
    CPU ranks; every rank launches K1, K2, K4 (and K9 on the sparse
    transport)."""
    from repro_torch.distributed.group import launch
    a, ra, counts, names = launch(4, _spmd_rank, transport, device=dev)
    b, rb, _, _ = launch(4, _spmd_rank, transport, device="cpu")
    assert ra == rb and int(a.rec.count.sum()) > 0 and int(a.dropped) == 0
    _eq(a.rec.times, b.rec.times)
    _eq(a.y_final, b.y_final)
    assert int(a.n_steps) == int(b.n_steps)
    per_rank = dict(zip(names, counts.T.tolist()))
    need = ["hines_factor", "hines_solve_factored", "hh_rhs"] + \
        (["compact_rows"] if transport == "sparse" else [])
    for k in need:
        assert min(per_rank[k]) > 0, k



def _gloo_collectives(group):
    """Each collective of the transports, on this rank's device, in every
    dtype the transports hand it; the results and the devices they are on."""
    r, w, d = group.rank, group.world, group.device
    out = {}
    for dt in (torch.float64, torch.int32, torch.bool):
        out["all_gather", dt] = group.all_gather(
            ((torch.arange(3) + 10 * r) % 4).to(dt).to(d), "a")
    for dt in (torch.float64, torch.int32):
        out["all_to_all", dt] = group.all_to_all(
            (torch.arange(w * 2).reshape(w, 2) + 100 * r).to(dt).to(d), "b")
    for dt in (torch.float64, torch.int64, torch.int32):
        for op in ("sum", "min", "max"):
            out[op, dt] = group.all_reduce(
                torch.tensor([r, -r], dtype=dt, device=d), op, "c")
    return {k: (v.device.type, v.cpu()) for k, v in out.items()}


@pytest.mark.cuda
def test_gloo_takes_card_tensors_for_every_transport_collective(dev):
    """Four ranks on cuda:0 over gloo: all-gather, the row all-to-all and
    all-reduce sum/min/max take card tensors and return them on the card,
    with the values four CPU ranks get."""
    from repro_torch.distributed.group import launch
    card = launch(4, _gloo_collectives, device=dev)
    cpu = launch(4, _gloo_collectives, device="cpu")
    assert card.keys() == cpu.keys()
    for k, (where, v) in card.items():
        assert where == "cuda" and cpu[k][0] == "cpu", k
        assert v.dtype == cpu[k][1].dtype and torch.equal(v, cpu[k][1]), k
    assert card["all_to_all", torch.int32][1][:, 0].tolist() == \
        [0, 100, 200, 300]
    assert card["max", torch.int32][1].tolist() == [3, 0]


# K10 against its plain version on the same card tensors: within 1e-5
# absolute and relative for the order of float32 sums and the exp, plus,
# for bf16 inputs, the bound two bf16 roundings of each p (and of a bf16
# output) allow, element by element (``ref.bf16_rounding_bound``).
K10_TOL = 1e-5


def _k10_case(dev, dtype, B, H, Hkv, Sq, Skv, D, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((B, S, h, D), generator=g).to(dtype).to(dev)
               .transpose(1, 2) for S, h in ((Sq, H), (Skv, Hkv), (Skv, Hkv)))
    return q, k, v


def _k10_check(q, k, v, causal, offset, kv_len, out_dtype, got):
    from repro_torch.kernels.attention import ref as a_ref
    B, H, Sq, D = q.shape
    want = a_ref.flash_attention_ref(q, k, v, causal, offset, kv_len,
                                     out_dtype).float()
    assert got.dtype == out_dtype and got.shape == (B, H, Sq, D)
    lim = K10_TOL * (1 + want.abs())
    if q.dtype == torch.bfloat16:
        lim += a_ref.bf16_rounding_bound(q, k, v, causal, offset, kv_len,
                                         out_dtype)
    assert bool(((got.float() - want).abs() <= lim).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal,kv_len", [
    (2, 9, 3, 300, 300, 64, True, None),        # prefill, ragged tile
    (4, 9, 3, 1, 256, 64, True, 1),             # decode, first step
    (4, 9, 3, 1, 256, 64, True, 37),
    (4, 9, 3, 1, 256, 64, True, 256),
    (2, 6, 3, 37, 100, 16, True, None),         # ragged + GQA
    (1, 4, 2, 64, 64, 16, False, None),         # bidirectional
    (1, 8, 8, 200, 200, 128, True, None),       # D = 128
    (1, 4, 2, 8, 100, 128, False, 77),          # masked kv tail
    (2, 8, 8, 130, 130, 16, True, None),        # group 1, D = 16
    (1, 16, 2, 100, 333, 128, True, None),      # group 8, ragged Skv
    (2, 3, 1, 70, 70, 64, False, None),         # group 3, bidirectional
    (2, 16, 2, 1, 4096, 128, True, 4096),       # decode, group 8, split
    (4, 9, 3, 1, 2048, 64, True, 2048),         # decode, split
    (1, 9, 3, 5, 600, 64, True, 555),           # decode rows Sq * group 15
    (1, 8, 1, 8, 64, 16, True, None),           # decode, 64 rows
    (1, 3, 1, 20, 200, 64, False, 150),         # decode, 60 rows, bidir.
    (2, 6, 2, 150, 300, 64, False, 211),        # prefill, masked kv tail
    (1, 4, 1, 100, 400, 128, True, 350),        # prefill, causal, kv tail
    (2, 32, 32, 128, 128, 112, True, None),     # zamba2-7b: D = 112
    (4, 32, 32, 1, 256, 112, True, 37),         # ... its decode step
    (2, 4, 2, 1, 4096, 112, True, 4096),        # decode, D = 112, split
    (1, 8, 2, 70, 90, 112, False, 80),          # D = 112, bidir., kv tail
    (1, 32, 4, 1, 320, 112, True, 300),         # decode, D = 112, 8 rows
    (1, 32, 4, 4, 600, 112, True, 555),         # ... 32 rows, split
])
def test_flash_attention_kernel_matches_plain(dev, dtype, B, H, Hkv, Sq, Skv,
                                              D, causal, kv_len):
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.attention import ops as a_ops
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _k10_case(dev, dtype, B, H, Hkv, Sq, Skv, D)
    offset = None if kv_len is None else kv_len - Sq
    build.reset_launches()
    for out_dtype in {dtype, torch.float32}:
        got = a_ops.flash_attention(q, k, v, causal=causal, offset=offset,
                                    kv_len=kv_len, out_dtype=out_dtype)
        torch.cuda.synchronize()
        _k10_check(q, k, v, causal, offset, kv_len, out_dtype, got)
    calls = 1 if dtype == torch.float32 else 2
    kind = flash.variant(dtype, Sq, H // Hkv, D)
    rows = "decode" if Sq * H // Hkv <= 64 else "prefill"
    assert kind == (f"f32_{rows}" if dtype == torch.float32 else rows)
    counts = build.launches()
    assert counts["flash_attention"] == calls
    kinds = ("f32_decode", "f32_prefill", "prefill", "decode")
    assert {n: counts[f"flash_attention_{n}"] for n in kinds} == {
        n: calls if n == kind else 0 for n in kinds}


@pytest.mark.cuda
@pytest.mark.parametrize("kv_len", [1, 255, 700, 4096])
@pytest.mark.parametrize("splits", [1, 2, 7, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_splits_agree(dev, kv_len, splits, dtype):
    """The decode kernels (bf16 and float32) with their kv tiles split over
    1-64 blocks (the second pass merging them) against the plain
    version."""
    from repro_torch.kernels.attention import flash
    q, k, v = _k10_case(dev, dtype, 2, 8, 2, 1, 4096, 64, seed=3)
    build.reset_launches()
    for out_dtype in dict.fromkeys((dtype, torch.float32)):
        got = flash.flash_attention_cuda(q, k, v, offset=kv_len - 1,
                                         kv_len=kv_len, out_dtype=out_dtype,
                                         splits=splits)
        torch.cuda.synchronize()
        _k10_check(q, k, v, True, kv_len - 1, kv_len, out_dtype, got)
    kind = "f32_decode" if dtype == torch.float32 else "decode"
    assert build.launches()[f"flash_attention_{kind}"] == \
        build.launches()["flash_attention"] > 0


@pytest.mark.cuda
def test_flash_attention_refused_launch_raises(dev):
    """A launch the kernels refuse returns its CUDA error and the wrapper
    raises; a misaligned bf16 or float32 view is refused before any
    launch."""
    import ctypes

    from repro_torch.kernels.attention import flash
    q, k, v = _k10_case(dev, torch.bfloat16, 1, 2, 1, 80, 80, 64)
    stream = build.stream_ptr(q.device)
    args = []
    for x in (q, k, v, q):
        args += [build.ptr(x), x.stride(0), x.stride(1), x.stride(2)]
    # head size 32 has no instantiation
    err = flash._launcher("prefill")(
        *args, 1, 2, 1, 80, 80, 32, 80, 0, 1, 0, stream)
    with pytest.raises(RuntimeError, match="flash_attention_prefill"):
        build.check(err, "flash_attention_prefill")
    # 66 query rows are more than the decode kernel takes
    err = flash._launcher("decode")(
        *args, ctypes.c_void_p(None), 1, 66, 1, 1, 80, 64, 80, 79, 1, 1, 2, 0,
        stream)
    assert err != 0
    err = flash._launcher("f32_decode")(
        *args, ctypes.c_void_p(None), 1, 66, 1, 1, 80, 64, 80, 79, 1, 1, 2, 0,
        stream)
    assert err != 0
    err = flash._launcher("f32_prefill")(
        *args, 1, 2, 1, 80, 80, 32, 80, 0, 1, stream)
    assert err != 0
    wide = torch.zeros((1, 80, 2, 72), dtype=torch.bfloat16, device=dev)
    build.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        flash.flash_attention_cuda(wide[..., 1:65].transpose(1, 2), k, v)
    # float32 views: a row 4 bytes off alignment, and rows 66 floats apart,
    # at a decode step (f32_decode) and at a prefill (f32_prefill)
    _, k32, v32 = _k10_case(dev, torch.float32, 1, 2, 1, 80, 80, 64)
    for wide in (torch.zeros((1, 80, 2, 72), device=dev)[..., 1:65],
                 torch.zeros((1, 80, 2, 66), device=dev)[..., :64]):
        for Sq in (1, 80):
            with pytest.raises(ValueError, match="16-byte"):
                flash.flash_attention_cuda(
                    wide[:, :Sq].transpose(1, 2), k32, v32)
    assert build.launches()["flash_attention"] == 0


LM_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -5}


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_lm_path_card_matches_cpu(dev, compute_dtype):
    """Reduced smollm-135m with the same weights: prefill logits and a few
    decode steps' logits, card (K10) against CPU (plain), within 1e-4
    (float32) or 2**-5 of the logit scale (bf16 compute, where one flip
    of a bf16 rounding moves an activation by 2**-8 of itself)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              compute_dtype=compute_dtype)
    cpu = lm.init_params(cfg, 0, device="cpu")
    card = lm.init_params(cfg, 0, device=dev)
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    build.reset_launches()
    got = lm.prefill(cfg, card, {"tokens": toks}, device=dev)
    assert build.launches()["flash_attention"] == cfg.n_layers
    want = lm.prefill(cfg, cpu, {"tokens": toks}, device="cpu")
    tol = LM_TOL[compute_dtype] * (1.0 if compute_dtype == "float32"
                                   else float(want.abs().max()))
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=tol)
    sc = lm.make_decode_state(cfg, 2, 16, device="cpu")
    sg = lm.make_decode_state(cfg, 2, 16, device=dev)
    for t in range(12):
        lc, sc = lm.decode_step(cfg, cpu, toks[:, t:t + 1], sc, t,
                                device="cpu")
        lg, sg = lm.decode_step(cfg, card, toks[:, t:t + 1], sg, t,
                                device=dev)
        torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=tol)
