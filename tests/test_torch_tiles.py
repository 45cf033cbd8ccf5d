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
from repro_torch.core.hines import hines_assemble, warp_words
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
    frame, place, neurons, smem = h_cuda.plan(m.n_comp)
    assert (frame, place, neurons, h_cuda.TILE) == ("tile", "shared", 32, 32)
    assert smem == h_cuda.tile_smem_bytes(32, m.n_comp) <= h_cuda.SMEM_MAX


@pytest.mark.parametrize("C", [0, -3, 283, 284, 10_000])
def test_tile_rule_refuses_what_it_cannot_tile(C):
    """What K2's tile cannot take, its warp frame takes: in shared memory
    beside the tree's tables (schedule words and g_axial, at their bound
    here) up to C = 2905, its rows alone up to 14528 (two rows of C
    float64 a neuron).  Only a tree without compartments is refused."""
    if C < 1:
        with pytest.raises(ValueError, match="at least one compartment"):
            h_cuda.plan(C)
        return
    frame, place, neurons, smem = h_cuda.plan(C)
    assert frame == "warp" and place == ("shared" if C <= 2905 else "rows")
    assert 1 <= neurons <= h_cuda.WARP_MAX
    assert smem == h_cuda.warp_smem_bytes(C, "hines_solve_factored", place,
                                          neurons) <= h_cuda.SMEM_MAX


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
    assert h_cuda.plan(282) == ("tile", "shared", 32,
                                h_cuda.tile_smem_bytes(32, 282))
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
    """A tree whose tile does not fit takes the kernel's warp frame: as
    many neurons a block (up to 16) as fit in shared memory beside the
    tables (at their bound, 16 C int32: the schedule words and g_axial,
    packed by entry), each with its rows (K1 d; K2 d_elim and b, its
    multipliers formed where they are added; K3 d and b); only an empty
    tree is refused."""
    C = KERNEL_TILES[kernel][1] + over
    rows = h_cuda.WARP_ROWS[kernel]
    assert rows == {"hines_factor": 1, "hines_solve_factored": 2,
                    "hines_solve": 2}[kernel]
    tables = 4 * 16 * C
    assert tables == 4 * h_cuda.warp_tables_bound(C)
    n = min(16, (h_cuda.SMEM_MAX - tables) // (8 * rows * C))
    assert n == {(1000, "hines_factor"): 8,
                 (1000, "hines_solve_factored"): 7,
                 (1000, "hines_solve"): 6}.get((over, kernel), 16)
    assert h_cuda.plan(C, kernel) == ("warp", "shared", n,
                                      tables + 8 * rows * C * n)
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
    is handed (``hines.schedule``) are ``core.hines.warp_words`` of that
    schedule, so both frames walk the tree alike."""
    parent = TREES[name] if name in TREES else LARGE_TREES[name]()
    D, lvl, nodes, cptr, kids = _schedule_by_counts(parent)
    sched = h_ref.hines_schedule(parent)
    assert D == sched.depth
    assert tuple(lvl) == sched.level_ptr
    assert tuple(nodes) == sched.nodes
    assert tuple(cptr) == sched.child_ptr
    assert tuple(kids) == sched.children
    tree = h_cuda.schedule(torch.tensor(parent, dtype=torch.int32))
    assert tree.D == D and tree.words.dtype == torch.int32
    assert tree.words.tolist() == warp_words(sched)
    assert tree.F == sum(1 for p in range(len(parent))
                         if sched.child_ptr[p + 1] > sched.child_ptr[p])


@pytest.mark.parametrize("kernel", list(KERNEL_TILES))
def test_plan_frames_at_their_limits(kernel):
    """The tile frame up to the kernel's tile limit; the warp frame from
    there: "shared" while one neuron's rows fit beside the tables at their
    bound (K1 to C = 3228, K2 and K3 2905: SMEM_MAX over 72, 80 and 80
    bytes a compartment), "rows" while one neuron's rows fit (K1 to 29056,
    K2 and K3 14528: over 8, 16 and 16 bytes), and walking device memory
    past that, with no upper limit."""
    c_tile = h_cuda.max_compartments(kernel)
    c_shared, c_rows = h_cuda.warp_limits(kernel)
    assert (c_shared, c_rows) == {"hines_factor": (3228, 29056),
                                  "hines_solve_factored": (2905, 14528),
                                  "hines_solve": (2905, 14528)}[kernel]
    for C, place in ((c_shared, "shared"), (c_rows, "rows")):
        assert h_cuda.warp_smem_bytes(C, kernel, place, 1) \
            <= h_cuda.SMEM_MAX < h_cuda.warp_smem_bytes(C + 1, kernel,
                                                         place, 1)
    assert [h_cuda.plan(C, kernel)[:2] for C in
            (1, c_tile, c_tile + 1, c_shared, c_shared + 1, c_rows,
             c_rows + 1, 10 ** 6)] == \
        [("tile", "shared")] * 2 + [("warp", "shared")] * 2 \
        + [("warp", "rows")] * 2 + [("warp", "device")] * 2
    assert h_cuda.plan(10 ** 6, kernel) == ("warp", "device", 8, 0)


def test_schedule_is_built_once_per_tree():
    """``schedule`` keeps a tree's words: a second call hands back the same
    tensor, an edited tree is built anew, a tree out of Hines order is
    refused, and at most ``_TREES_MAX`` addresses are kept."""
    par = torch.tensor(morphology.branched_tree(depth=8).parent,
                       dtype=torch.int32)
    tree = h_cuda.schedule(par)
    assert h_cuda.schedule(par).words is tree.words and tree.D == 16
    star = torch.tensor([-1] + [0] * 1020, dtype=torch.int32)
    assert h_cuda.schedule(star)[1:] == (1, 1, 1019)
    star[5] = 4                                   # edited in place
    assert h_cuda.schedule(star)[1:] == (2, 2, 1018)
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



def _children(c0, c1, m, more):
    """A forward entry's children: c0, then c1 unless -1, then the
    ``more[m]`` words after ``more[m]`` where m >= 0."""
    return [c0] + ([c1] if c1 >= 0 else []) \
        + (more[m + 1:m + 1 + more[m]] if m >= 0 else [])


def _walk_words(words, gax, d, b=None, kind="hines_solve"):
    """The sweeps as the warp frame walks ``core.hines.warp_words``, one
    compartment at a time: d, b [N, C] -> d_elim (K1) or x (K2 from a
    factored d, K3 from an assembled one).  The forward entries of each
    depth, deepest first, each parent adding its children in the entry's
    order; the back entries of each depth, root first."""
    F, M, D, n = words[:4]
    C = d.shape[1]
    fwd = [words[4 + 4 * k:8 + 4 * k] for k in range(F)]
    back = [words[4 + 4 * F + 2 * k:6 + 4 * F + 2 * k] for k in range(C)]
    more = words[4 + 4 * F + 2 * C:4 + 4 * F + 2 * C + M]
    fptr = words[4 + 4 * F + 2 * C + M:][:D + 1]
    lvl = words[4 + 4 * F + 2 * C + M + D + 1:][:D + 2]
    W, X = d.clone(), None if b is None else b.clone()
    for L in range(D, 0, -1):
        for p, c0, c1, m in fwd[fptr[L - 1]:fptr[L]]:
            w, x = W[:, p], None if X is None else X[:, p]
            for i in _children(c0, c1, m, more):
                f = gax[i] / W[:, i]
                if kind != "hines_solve_factored":
                    w = w + (-f * gax[i])
                if kind != "hines_factor":
                    x = x + f * X[:, i]
            if kind != "hines_solve_factored":
                W[:, p] = w
            if kind != "hines_factor":
                X[:, p] = x
    if kind == "hines_factor":
        return W
    X[:, 0] = X[:, 0] / W[:, 0]
    for i, p in back[lvl[1]:]:
        X[:, i] = (X[:, i] + gax[i] * X[:, p]) / W[:, i]
    return X


@pytest.mark.parametrize("name", list(TREES) + list(LARGE_TREES))
def test_warp_words_decode_to_the_sequential_order(name):
    """``core.hines.warp_words`` against ``hines_schedule``: the header,
    each parent with children once, at its depth and in index order, its
    children in descending index (the first two in its entry, the others
    counted in ``more``), the back entries the compartments by depth with
    their parents; and the sweeps walked in the words' order give K1, K2
    and K3 bit for bit as the sequential loops do."""
    from repro_torch.core.hines import hines_schedule
    parent = TREES[name] if name in TREES else LARGE_TREES[name]()
    sched = hines_schedule(parent)
    words = warp_words(sched)
    C = len(parent)
    F, M, D, n = words[:4]
    kids = {p: list(sched.children[sched.child_ptr[p]:sched.child_ptr[p + 1]])
            for p in range(C)}
    parents = [p for p in sched.nodes if kids[p]]
    assert (F, M, D, n) == (len(parents), sum(len(k) - 1 for k in
                                              kids.values() if len(k) > 2),
                            sched.depth, len(words))
    assert n % 4 == 0 and n - 4 < 4 * F + 2 * C + M + 2 * D + 7 <= n \
        <= h_cuda.warp_words_bound(C)
    fwd = [words[4 + 4 * k:8 + 4 * k] for k in range(F)]
    more = words[4 + 4 * F + 2 * C:4 + 4 * F + 2 * C + M]
    fptr = words[4 + 4 * F + 2 * C + M:][:D + 1]
    assert [e[0] for e in fwd] == parents
    depth = {i: L for L in range(D + 1)
             for i in sched.nodes[sched.level_ptr[L]:sched.level_ptr[L + 1]]}
    for L in range(D):
        assert all(depth[e[0]] == L for e in fwd[fptr[L]:fptr[L + 1]])
    for p, c0, c1, m in fwd:
        assert (c1 >= 0, m >= 0) == (len(kids[p]) > 1, len(kids[p]) > 2)
        assert _children(c0, c1, m, more) == kids[p] == sorted(kids[p],
                                                               reverse=True)
    back = words[4 + 4 * F:4 + 4 * F + 2 * C]
    assert back == [w for i in sched.nodes for w in (i, parent[i])]
    assert words[4 + 4 * F + 2 * C + M + D + 1:][:D + 2] \
        == list(sched.level_ptr)
    gax, d, b = _tree_case(parent, N=7)
    d, b = d.T, b.T
    de = _walk_words(words, gax, d, kind="hines_factor")
    assert torch.equal(de, _seq_factor(parent, gax, d))
    assert torch.equal(_walk_words(words, gax, de, b, "hines_solve_factored"),
                       _seq_solve_factored(parent, gax, de, b))
    assert torch.equal(_walk_words(words, gax, d, b), _seq_solve(parent, gax,
                                                                d, b))


@pytest.mark.parametrize("kernel", list(KERNEL_TILES))
def test_warp_plan_at_the_detailed_cell(kernel):
    """The warp frame's plan at the main path's detailed cell (C = 1021,
    5144 schedule words, 765 parents): the tables once a block -- the
    words (20,576 bytes), each forward entry's two g_axial (12,240) and
    g_axial and each back entry's (8,168 each), 49,152 bytes -- then as
    many neurons as fit, up to 16: K1 16 (one row of 8,168 bytes; 22
    would fit), K2 and K3 11 (two rows, 228,848 bytes), one block an SM;
    the tables' bound (16 C int32) leaves K2 and K3 a neuron less."""
    par = torch.tensor(morphology.branched_tree(depth=8).parent,
                       dtype=torch.int32)
    tree = h_cuda.schedule(par)
    words = tree.words.numel()
    assert (words, tree.D, tree.F, tree.M) == (5144, 16, 765, 0)
    tables = h_cuda.warp_tables(1021, words, tree.F)
    assert 4 * tables == 20576 + 12240 + 2 * 8168 == 49152
    neurons = {"hines_factor": 16, "hines_solve_factored": 11,
               "hines_solve": 11}[kernel]
    row = 8 * h_cuda.WARP_ROWS[kernel] * 1021
    pl = h_cuda.plan(1021, kernel, tables)
    assert pl == ("warp", "shared", neurons, 4 * tables + neurons * row)
    assert pl.smem == (179840 if kernel == "hines_factor" else 228848)
    assert pl.smem + row > h_cuda.SMEM_MAX or neurons == h_cuda.WARP_MAX
    assert pl.smem == h_cuda.warp_smem_bytes(1021, kernel, "shared",
                                             neurons, tables)
    assert h_cuda.plan(1021, kernel).neurons == neurons - (
        kernel != "hines_factor")
