"""The Python around the Hopper designs of the Hines kernels K1
(``hines_factor``), K2 (``hines_solve_factored``) and K3 (``hines_solve``)
and of K6 (``compact_ids``), on the CPU: each Hines kernel's plan (the tile
frame while its tile fits the block's shared memory, else the warp frame,
staged while its rows fit), their level schedule (the schedule-ordered
plain versions equal the sequential ones bit for bit, and the counts by
which each tile block derives the schedule give the words the warp frame
is handed), the dispatchers' choice by device, the CUDA wrappers'
refusals, and the plain versions at the main path's layouts against the
JAX package.  The
kernels themselves are held to their plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 2, 5 and 8).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import morphology
from repro_torch.core.cell import CellModel
from repro_torch.core.hines import hines_assemble
from repro_torch.kernels import build
from repro_torch.kernels.event_wheel import event_wheel as ew_cuda
from repro_torch.kernels.event_wheel import ops as ew_ops
from repro_torch.kernels.event_wheel import ref as ew_ref
from repro_torch.kernels.hines import hines as h_cuda
from repro_torch.kernels.hines import ops as h_ops
from repro_torch.kernels.hines import ref as h_ref

# every tree builder of core/morphology.py, at its defaults and at the
# sizes the port runs (the main path's branched_tree(2, 2), C = 13)
MORPHS = {"soma": morphology.soma_only,
          "ball_and_stick": morphology.ball_and_stick,
          "ball_and_stick_40": lambda: morphology.ball_and_stick(n_dend=40),
          "branched": morphology.branched_tree,
          "branched_2_2": lambda: morphology.branched_tree(2, 2),
          "branched_1_1": lambda: morphology.branched_tree(1, 1),
          "branched_4_2": lambda: morphology.branched_tree(depth=4)}


@pytest.mark.parametrize("name", list(MORPHS))
def test_tile_rule_fits_shared_memory_for_every_morphology(name):
    m = MORPHS[name]()
    frame, staged, smem = h_cuda.plan(m.n_comp)
    assert (frame, staged, h_cuda.TILE) == ("tile", True, 32)
    assert smem == h_cuda.tile_smem_bytes(32, m.n_comp) <= h_cuda.SMEM_MAX


@pytest.mark.parametrize("C", [0, -3, 283, 284, 10_000])
def test_tile_rule_refuses_what_it_cannot_tile(C):
    """What K2's tile cannot take, its warp frame takes: staged up to C =
    9685 (three rows of C float64), walking device memory above.  Only a
    tree without compartments is refused."""
    if C < 1:
        with pytest.raises(ValueError, match="at least one compartment"):
            h_cuda.plan(C)
        return
    frame, staged, smem = h_cuda.plan(C)
    assert frame == "warp" and staged == (C <= 9685)
    assert smem == (24 * C if staged else 0) <= h_cuda.SMEM_MAX


def test_tile_bytes_match_the_kernel():
    """The wrapper's tile size is the launcher's dynamic shared memory
    (``factored_smem_bytes`` in csrc/hines.cu): x, d_elim and the
    multipliers as [C][nb + 1] float64, g_axial, and 6 C + 3 int32 of tree
    and schedule; the largest tree it takes is C = 282."""
    for nb, C in ((32, 1), (32, 13), (32, 29), (64, 13)):
        assert h_cuda.tile_smem_bytes(nb, C) == \
            24 * (nb + 1) * C + 8 * C + 4 * (6 * C + 3)
    assert h_cuda.tile_smem_bytes(32, 282) <= h_cuda.SMEM_MAX \
        < h_cuda.tile_smem_bytes(32, 283)
    assert h_cuda.plan(282) == ("tile", True, h_cuda.tile_smem_bytes(32, 282))
    for make in MORPHS.values():        # the schedule's words fit 4 C + 3
        m = make()
        sch = h_ref.hines_schedule(m.parent)
        assert len(sch.level_ptr) + len(sch.nodes) + len(sch.child_ptr) \
            + len(sch.children) + 1 <= 4 * m.n_comp + 3


# each kernel's staged operands and the largest tree its tile takes
KERNEL_TILES = {"hines_factor": (1, 785), "hines_solve_factored": (3, 282),
                "hines_solve": (2, 415)}


@pytest.mark.parametrize("kernel", list(KERNEL_TILES))
def test_each_kernel_tile_bytes_and_limit(kernel):
    """Each Hines kernel's tile -- its staged operands as [C][nb + 1]
    float64 (K1 d; K2 d_elim, b and the multipliers; K3 d and b), g_axial
    and 6 C + 3 int32 -- fits the block's shared memory up to its largest
    C, which the main paths' cells (C <= 29) and the card tests' random
    trees (C <= 282) stay within."""
    tiles, c_max = KERNEL_TILES[kernel]
    assert h_cuda.TILES[kernel] == tiles
    assert h_cuda.max_compartments(kernel) == c_max
    for nb, C in ((32, 1), (32, 13), (32, 29), (64, 13)):
        assert h_cuda.tile_smem_bytes(nb, C, tiles) == \
            8 * tiles * (nb + 1) * C + 8 * C + 4 * (6 * C + 3)
    assert h_cuda.tile_smem_bytes(32, c_max, tiles) <= h_cuda.SMEM_MAX \
        < h_cuda.tile_smem_bytes(32, c_max + 1, tiles)
    for make in MORPHS.values():
        assert h_cuda.plan(make().n_comp, kernel).frame == "tile"
    assert h_cuda.plan(282, kernel).frame == h_cuda.plan(
        c_max, kernel).frame == "tile"


@pytest.mark.parametrize("kernel", list(KERNEL_TILES))
@pytest.mark.parametrize("over", [1, 2, 1000])
def test_each_kernel_refuses_a_tree_over_its_limit(kernel, over):
    """A tree whose tile does not fit takes the kernel's warp frame, its
    rows (g_axial and the operands, K2's multipliers formed where they are
    added) in shared memory; only an empty tree is refused."""
    C = KERNEL_TILES[kernel][1] + over
    rows = h_cuda.WARP_ROWS[kernel]
    assert rows == {"hines_factor": 2, "hines_solve_factored": 3,
                    "hines_solve": 3}[kernel]
    assert h_cuda.plan(C, kernel) == ("warp", True, 8 * rows * C)
    with pytest.raises(ValueError, match="at least one compartment"):
        h_cuda.plan(0, kernel)


def _random_tree(C, seed):
    """A Hines-ordered tree: parent[i] drawn below i, more or less bushy."""
    rng = np.random.default_rng(seed)
    span = rng.integers(1, C) if C > 1 else 1
    return [-1] + [int(rng.integers(max(0, i - span), i))
                   for i in range(1, C)]


TREES = {**{name: MORPHS[name]().parent for name in MORPHS},
         **{f"random_{C}_{seed}": _random_tree(C, seed)
            for C, seed in ((2, 0), (5, 1), (17, 2), (40, 3), (64, 4),
                            (64, 5), (100, 6), (200, 7), (282, 8))},
         "chain_64": [-1] + list(range(63)), "star_64": [-1] + [0] * 63}


def _seq_factor(parent, g_axial, d):
    """The sequential child -> parent elimination, one compartment after
    the other from C - 1 down, as ``repro.core.hines`` loops: d [N, C] ->
    d_elim.  The oracle of ``core.hines`` and, through it, of the
    kernels."""
    par, gax, dd = [int(p) for p in parent], torch.as_tensor(g_axial), d.clone()
    for i in range(len(par) - 1, 0, -1):
        f = gax[i] / dd[:, i]
        dd[:, par[i]] = dd[:, par[i]] + (-f * gax[i])
    return dd


def _seq_back(par, gax, diag, bb):
    v = torch.zeros_like(bb)
    v[:, 0] = bb[:, 0] / diag[:, 0]
    for i in range(1, len(par)):
        v[:, i] = (bb[:, i] + gax[i] * v[:, par[i]]) / diag[:, i]
    return v


def _seq_solve_factored(parent, g_axial, d_elim, b):
    """The sequential forward sweep and back substitution on a factored
    diagonal: d_elim, b [N, C] -> x."""
    par, gax, bb = [int(p) for p in parent], torch.as_tensor(g_axial), b.clone()
    for i in range(len(par) - 1, 0, -1):
        f = gax[i] / d_elim[:, i]
        bb[:, par[i]] = bb[:, par[i]] + f * bb[:, i]
    return _seq_back(par, gax, d_elim, bb)


def _seq_solve(parent, g_axial, d, b):
    """The sequential fused solve, the elimination carrying b with the same
    multipliers: d, b [N, C] -> x."""
    par, gax = [int(p) for p in parent], torch.as_tensor(g_axial)
    dd, bb = d.clone(), b.clone()
    for i in range(len(par) - 1, 0, -1):
        f = gax[i] / dd[:, i]
        dd[:, par[i]] = dd[:, par[i]] + (-f * gax[i])
        bb[:, par[i]] = bb[:, par[i]] + f * bb[:, i]
    return _seq_back(par, gax, dd, bb)


@pytest.mark.parametrize("name", list(TREES))
def test_schedule_order_equals_sequential_solve_bitwise(name):
    """K2's level schedule gives every value the operations of the
    sequential sweeps in the same order: bit for bit the plain version and
    the sequential loops, on every morphology and on seeded random
    Hines-ordered trees."""
    parent = TREES[name]
    C = len(parent)
    rng = np.random.default_rng(C)
    gax = torch.from_numpy(rng.uniform(0.1, 2.0, C))
    de = torch.from_numpy(rng.uniform(0.5, 3.0, (C, 23)))
    b = torch.from_numpy(rng.normal(size=(C, 23)))
    sched = h_ref.hines_schedule(parent)
    x = h_ref.hines_solve_factored_sched_ref(sched, gax, de, b)
    assert torch.equal(x, h_ref.hines_solve_factored_ref(parent, gax, de, b))
    assert torch.equal(x, _seq_solve_factored(parent, gax, de.T, b.T).T)
    # the schedule is a partition of the tree by depth, children descending
    assert sorted(sched.nodes) == list(range(C))
    assert sched.level_ptr[-1] == C and sched.nodes[0] == 0
    for p in range(C):
        kids = sched.children[sched.child_ptr[p]:sched.child_ptr[p + 1]]
        assert list(kids) == sorted((i for i in range(1, C)
                                     if parent[i] == p), reverse=True)


def _tree_case(parent, N=23):
    C = len(parent)
    rng = np.random.default_rng(C + 1000)
    gax = torch.from_numpy(rng.uniform(0.1, 2.0, C))
    d = hines_assemble(parent, gax, torch.from_numpy(
        rng.uniform(0.5, 1.5, (N, C)))).T
    return gax, d, torch.from_numpy(rng.normal(size=(C, N)))


@pytest.mark.parametrize("name", list(TREES))
def test_factor_and_fused_schedule_orders_equal_sequential_bitwise(name):
    """K1's and K3's orders on the level schedule -- the elimination deepest
    level first, each parent adding its children in descending index, with
    multipliers from the children's final rows; K3 then K2's back
    substitution -- equal the plain versions and the sequential loops bit
    for bit, and K3's model equals K2's model applied to K1's."""
    parent = TREES[name]
    gax, d, b = _tree_case(parent)
    sched = h_ref.hines_schedule(parent)
    de = h_ref.hines_factor_sched_ref(sched, gax, d)
    assert torch.equal(de, h_ref.hines_factor_ref(parent, gax, d))
    assert torch.equal(de, _seq_factor(parent, gax, d.T).T)
    x = h_ref.hines_solve_sched_ref(sched, gax, d, b)
    assert torch.equal(x, h_ref.hines_solve_ref(parent, gax, d, b))
    assert torch.equal(x, _seq_solve(parent, gax, d.T, b.T).T)
    assert torch.equal(x, h_ref.hines_solve_factored_sched_ref(sched, gax,
                                                                de, b))
    assert torch.isfinite(x).all()


@pytest.mark.parametrize("name", ["soma", "ball_and_stick", "branched_2_2",
                                  "branched_4_2", "random_282_8",
                                  "chain_64", "star_64"])
def test_factor_and_fused_schedule_orders_vs_jax(name):
    """K1's and K3's schedule-ordered plain versions against the JAX
    package's oracles under x64, within rtol 1e-12, atol 1e-14."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from repro.kernels.hines import ref as jh_ref

    parent = TREES[name]
    gax, d, b = _tree_case(parent, N=37)
    sched = h_ref.hines_schedule(parent)
    jp, jg = jnp.asarray(np.asarray(parent, np.int32)), jnp.asarray(gax.numpy())
    np.testing.assert_allclose(
        h_ref.hines_factor_sched_ref(sched, gax, d).numpy(),
        np.asarray(jh_ref.hines_factor_ref(jp, jg, jnp.asarray(d.numpy()))),
        rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        h_ref.hines_solve_sched_ref(sched, gax, d, b).numpy(),
        np.asarray(jh_ref.hines_solve_ref(jp, jg, jnp.asarray(d.numpy()),
                                          jnp.asarray(b.numpy()))),
        rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("parent", [[], [0], [-1, 1], [-1, 0, 3, 1],
                                    [-1, -1]])
def test_schedule_refuses_trees_out_of_hines_order(parent):
    with pytest.raises(ValueError, match="Hines order"):
        h_ref.hines_schedule(parent)


def _forbid(monkeypatch, module, name):
    def boom(*a, **k):
        raise AssertionError(f"{name} launched for CPU tensors")
    monkeypatch.setattr(module, name, boom)


def test_dispatchers_send_cpu_tensors_to_the_plain_versions(monkeypatch):
    _forbid(monkeypatch, h_ops, "hines_solve_factored_cuda")
    _forbid(monkeypatch, ew_ops, "compact_ids_cuda")
    m = morphology.branched_tree(2, 2)
    g = torch.Generator().manual_seed(4)
    par = torch.as_tensor(m.parent, dtype=torch.int32)
    gax = torch.as_tensor(m.g_axial)
    de = torch.rand((m.n_comp, 9), generator=g, dtype=torch.float64) + 1.0
    b = torch.randn((m.n_comp, 9), generator=g, dtype=torch.float64)
    before = build.launches()
    assert torch.equal(h_ops.hines_solve_factored(par, gax, de, b),
                       h_ref.hines_solve_factored_ref(par, gax, de, b))
    mask = torch.rand(37, generator=g) < 0.5
    for got, want in zip(ew_ops.compact_ids(mask, 8),
                         ew_ref.compact_ids_ref(mask, 8)):
        assert torch.equal(got, want)
    assert build.launches() == before


@pytest.mark.parametrize("kernel", ["hines_factor", "hines_solve"])
def test_factor_and_fused_dispatchers_take_the_plain_versions_on_cpu(
        monkeypatch, kernel):
    """K1 and K3 on CPU tensors: the plain version, and no launch."""
    _forbid(monkeypatch, h_ops, f"{kernel}_cuda")
    m = morphology.branched_tree(2, 2)
    par = torch.as_tensor(m.parent, dtype=torch.int32)
    gax, d, b = _tree_case(m.parent, N=9)
    args = (d,) if kernel == "hines_factor" else (d, b)
    before = build.launches()
    assert torch.equal(getattr(h_ops, kernel)(par, gax, *args),
                       getattr(h_ref, f"{kernel}_ref")(par, gax, *args))
    assert build.launches() == before


@pytest.mark.parametrize("kernel", ["hines_factor", "hines_solve"])
def test_factor_and_fused_wrappers_refuse_cpu_tensors(kernel):
    """The trimmed K1 and K3 wrappers fall back to the detailed checks,
    which name the operand, and launch nothing."""
    par = torch.zeros(3, dtype=torch.int32)
    gax = torch.ones(3, dtype=torch.float64)
    x = torch.ones((3, 5), dtype=torch.float64)
    args = (x,) if kernel == "hines_factor" else (x, x)
    before = build.launches()
    with pytest.raises(ValueError, match="float64 CUDA tensor of shape"):
        getattr(h_cuda, f"{kernel}_cuda")(par, gax, *args)
    assert build.launches() == before


def test_cuda_wrappers_refuse_cpu_tensors():
    par = torch.zeros(3, dtype=torch.int32)
    gax = torch.ones(3, dtype=torch.float64)
    x = torch.ones((3, 5), dtype=torch.float64)
    before = build.launches()
    with pytest.raises(ValueError, match="float64 CUDA tensor"):
        h_cuda.hines_solve_factored_cuda(par, gax, x, x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ew_cuda.compact_ids_cuda(torch.zeros(5, dtype=torch.bool), 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ew_cuda.compact_ids_cuda(torch.zeros(5, dtype=torch.bool), 0)
    assert build.launches() == before


def _schedule_by_counts(parent):
    """The level schedule as K2's tile blocks derive it (``derive_schedule``
    in csrc/hines.cu): each compartment's depth by a walk to the root of at
    most C - 1 steps, then its place among the compartments ordered by
    (depth, index) and among its parent's children in descending index, by
    counting over the others -- the same counts, taken for all
    compartments at once."""
    par = np.asarray(parent, np.int64)
    C = len(par)
    dep, k = np.zeros(C, np.int64), np.arange(C)
    for _ in range(C - 1):                 # the kernel's depth walk
        q = par[k]
        step = (k > 0) & (q >= 0) & (q < k)
        if not step.any():
            break
        dep += step
        k = np.where(step, q, 0)
    c, j = np.arange(C)[:, None], np.arange(C)[None, :]
    dc, dj = dep[:, None], dep[None, :]
    shallower = (dj < dc).sum(1)
    before = ((j < c) & (dj == dc)).sum(1)
    deeper = (dj > dc).sum(1)
    pc, pj, js = par[:, None], par[None, 1:], j[:, 1:]
    kid_slot = ((pj < pc) | ((pj == pc) & (js > c))).sum(1)
    kids_below = (pj < c).sum(1)
    nodes, kids = [None] * C, [None] * (C - 1)
    lvl, cptr, D = [None] * (C + 1), [None] * C + [C - 1], None
    for i in range(C):
        nodes[shallower[i] + before[i]] = i
        cptr[i] = int(kids_below[i])
        if i > 0 and kid_slot[i] < C - 1:
            kids[kid_slot[i]] = i
        if before[i] == 0:
            lvl[dep[i]] = int(shallower[i])
            if deeper[i] == 0:
                lvl[dep[i] + 1], D = C, int(dep[i])
    return D, lvl[:D + 2], nodes, cptr, kids


# trees past the tiles: detailed cells (branched_tree at depths 8 and 10,
# C = 1021 and 4093) and a 4000-compartment chain (depth C - 1)
LARGE_TREES = {"branched_8": lambda: morphology.branched_tree(depth=8).parent,
               "branched_10": lambda: morphology.branched_tree(
                   depth=10).parent,
               "chain_4000": lambda: morphology.ball_and_stick(
                   n_dend=4000).parent}


@pytest.mark.parametrize("name", list(TREES) + list(LARGE_TREES))
def test_core_sweeps_equal_the_sequential_loops_bitwise(name):
    """``core.hines`` runs its sweeps in batches of independent
    compartments (``tree_sweeps``); each value still sees the sequential
    loops' operations in the same order, so its factor, factored solve and
    fused solve equal the loops bit for bit, on every tree and on the
    detailed cells and the 4000-compartment chain."""
    from repro_torch.core import hines as core_hines
    parent = TREES[name] if name in TREES else LARGE_TREES[name]()
    gax, d, b = _tree_case(parent, N=7)
    d, b = d.T, b.T
    de = core_hines.hines_factor(parent, gax, d)
    assert torch.equal(de, _seq_factor(parent, gax, d))
    assert torch.equal(core_hines.hines_solve_factored(parent, gax, de, b),
                       _seq_solve_factored(parent, gax, de, b))
    assert torch.equal(core_hines.hines_solve(parent, gax, d, b),
                       _seq_solve(parent, gax, d, b))


@pytest.mark.parametrize("name", list(TREES) + list(LARGE_TREES))
def test_kernel_schedule_counts_give_the_model_order(name):
    """The counts by which each K2 tile block derives the schedule from the
    staged parent fill every slot, and give ``ref.hines_schedule``'s
    order: the depths, the compartments by depth, the child ranges and
    each parent's children in descending index.  The words the warp frame
    is handed (``hines.schedule``) are that order, so both frames walk the
    tree alike."""
    parent = TREES[name] if name in TREES else LARGE_TREES[name]()
    D, lvl, nodes, cptr, kids = _schedule_by_counts(parent)
    sched = h_ref.hines_schedule(parent)
    assert D == sched.depth
    assert tuple(lvl) == sched.level_ptr
    assert tuple(nodes) == sched.nodes
    assert tuple(cptr) == sched.child_ptr
    assert tuple(kids) == sched.children
    words, depth = h_cuda.schedule(torch.tensor(parent, dtype=torch.int32))
    assert depth == D and words.dtype == torch.int32
    assert words.tolist() == lvl + nodes + cptr + kids


@pytest.mark.parametrize("kernel", list(KERNEL_TILES))
def test_plan_frames_at_their_limits(kernel):
    """The tile frame up to the kernel's tile limit; the warp frame staged
    from there while its rows fit (K1 to C = 14528, K2 and K3 9685:
    SMEM_MAX over 16, 24 and 24 bytes a compartment); past that the warp
    frame walks device memory, with no upper limit."""
    c_tile = h_cuda.max_compartments(kernel)
    c_rows = h_cuda.SMEM_MAX // h_cuda.warp_smem_bytes(1, kernel)
    assert c_rows == {"hines_factor": 14528, "hines_solve_factored": 9685,
                      "hines_solve": 9685}[kernel]
    assert h_cuda.warp_smem_bytes(c_rows, kernel) <= h_cuda.SMEM_MAX \
        < h_cuda.warp_smem_bytes(c_rows + 1, kernel)
    assert [h_cuda.plan(C, kernel)[:2] for C in
            (1, c_tile, c_tile + 1, c_rows, c_rows + 1, 10 ** 6)] == \
        [("tile", True)] * 2 + [("warp", True)] * 2 + [("warp", False)] * 2


def test_schedule_is_built_once_per_tree():
    """``schedule`` keeps a tree's words: a second call hands back the same
    tensor, an edited tree is built anew, a tree out of Hines order is
    refused, and at most ``_TREES_MAX`` addresses are kept."""
    par = torch.tensor(morphology.branched_tree(depth=8).parent,
                       dtype=torch.int32)
    words, D = h_cuda.schedule(par)
    assert h_cuda.schedule(par)[0] is words and D == 16
    star = torch.tensor([-1] + [0] * 1020, dtype=torch.int32)
    assert h_cuda.schedule(star)[1] == 1
    star[5] = 4                                   # edited in place
    assert h_cuda.schedule(star)[1] == 2
    star[5] = 7                                   # parent after child
    with pytest.raises(ValueError, match="Hines order"):
        h_cuda.schedule(star)
    for k in range(h_cuda._TREES_MAX + 3):
        h_cuda.schedule(torch.tensor([-1] + [0] * k, dtype=torch.int32))
    assert len(h_cuda._TREES) == h_cuda._TREES_MAX


@pytest.mark.parametrize("kernel", ["hines_factor", "hines_solve_factored",
                                    "hines_solve"])
def test_dispatchers_take_the_plain_versions_for_large_trees_on_cpu(
        monkeypatch, kernel):
    """At C = 1021, past every tile, CPU tensors still take the plain
    version, and nothing is launched; K3 == K2(K1) bitwise there."""
    _forbid(monkeypatch, h_ops, f"{kernel}_cuda")
    m = morphology.branched_tree(depth=8)
    par = torch.as_tensor(m.parent, dtype=torch.int32)
    gax, d, b = _tree_case(m.parent, N=5)
    args = (d,) if kernel == "hines_factor" else (d, b)
    before = build.launches()
    got = getattr(h_ops, kernel)(par, gax, *args)
    assert torch.equal(got, getattr(h_ref, f"{kernel}_ref")(par, gax, *args))
    if kernel == "hines_solve":
        assert torch.equal(got, h_ref.hines_solve_factored_ref(
            par, gax, h_ref.hines_factor_ref(par, gax, d), b))
    assert build.launches() == before


@pytest.mark.parametrize("name,N", [("soma", 5), ("ball_and_stick", 33),
                                    ("branched_2_2", 70), ("branched", 41)])
def test_factored_solve_at_factor_rows_plain_vs_jax(name, N):
    """K2's plain version on the main path's operands -- d_elim as the
    ``factors[:, :C].T`` slice of ``[N, n_factors]`` rows, b as the
    transposed ``[N, C]`` rows -- against the JAX oracle within rtol 1e-12,
    and bitwise equal to the same solve on contiguous ``[C, N]`` copies."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from repro.kernels.hines import ref as jh_ref

    m = MORPHS[name]()
    C = m.n_comp
    rng = np.random.default_rng(N + C)
    d = np.asarray(hines_assemble(m.parent, torch.as_tensor(m.g_axial),
                                  torch.from_numpy(
                                      rng.uniform(0.5, 1.5, (N, C)))))
    b = rng.normal(size=(N, C))
    par = torch.as_tensor(m.parent, dtype=torch.int32)
    gax = torch.as_tensor(m.g_axial)
    de = h_ops.hines_factor(par, gax, torch.from_numpy(d).T).T
    fac = torch.from_numpy(rng.normal(
        size=(N, CellModel(m, device="cpu").n_factors())))
    fac[:, :C] = de
    x = h_ops.hines_solve_factored(par, gax, fac[:, :C].T,
                                   torch.from_numpy(b).T)
    assert torch.equal(x, h_ops.hines_solve_factored(
        par, gax, de.T.contiguous(), torch.from_numpy(b.T.copy())))
    want = jh_ref.hines_solve_factored_ref(
        jnp.asarray(m.parent), jnp.asarray(m.g_axial),
        jnp.asarray(de.T.numpy()), jnp.asarray(b.T))
    np.testing.assert_allclose(x.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-14)

