"""The Python around the Hopper designs of the Hines kernels K1
(``hines_factor``), K2 (``hines_solve_factored``) and K3 (``hines_solve``)
and of K6 (``compact_ids``), on the CPU: each Hines kernel's tile rule
against the block's shared memory, their level schedule (the
schedule-ordered plain versions equal the sequential ones bit for bit, and
the counts by which each block derives the schedule give the same order),
the dispatchers' choice by device, the CUDA wrappers' refusals, and the
plain versions at the main path's layouts against the JAX package.  The
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
    nb = h_cuda.tile_neurons(m.n_comp)
    assert nb == h_cuda.TILE == 32
    assert h_cuda.tile_smem_bytes(nb, m.n_comp) <= h_cuda.SMEM_MAX


@pytest.mark.parametrize("C", [0, -3, 283, 284, 10_000])
def test_tile_rule_refuses_what_it_cannot_tile(C):
    with pytest.raises(ValueError):
        h_cuda.tile_neurons(C)


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
    assert h_cuda.tile_neurons(282) == 32
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
        assert h_cuda.tile_neurons(make().n_comp, kernel) == 32
    assert h_cuda.tile_neurons(282, kernel) == h_cuda.tile_neurons(
        c_max, kernel) == 32


@pytest.mark.parametrize("kernel", list(KERNEL_TILES))
@pytest.mark.parametrize("over", [1, 2, 1000])
def test_each_kernel_refuses_a_tree_over_its_limit(kernel, over):
    """A tree whose tile does not fit is refused with a ValueError that
    names the limit; so is an empty tree."""
    C = KERNEL_TILES[kernel][1] + over
    with pytest.raises(ValueError, match=f"at most {h_cuda.SMEM_MAX}"):
        h_cuda.tile_neurons(C, kernel)
    with pytest.raises(ValueError, match="at least one compartment"):
        h_cuda.tile_neurons(0, kernel)


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


@pytest.mark.parametrize("name", list(TREES))
def test_schedule_order_equals_sequential_solve_bitwise(name):
    """K2's level schedule gives every value the operations of the
    sequential sweeps in the same order: bit for bit the plain version, on
    every morphology and on seeded random Hines-ordered trees."""
    parent = TREES[name]
    C = len(parent)
    rng = np.random.default_rng(C)
    gax = torch.from_numpy(rng.uniform(0.1, 2.0, C))
    de = torch.from_numpy(rng.uniform(0.5, 3.0, (C, 23)))
    b = torch.from_numpy(rng.normal(size=(C, 23)))
    sched = h_ref.hines_schedule(parent)
    assert torch.equal(h_ref.hines_solve_factored_sched_ref(sched, gax, de, b),
                       h_ref.hines_solve_factored_ref(parent, gax, de, b))
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
    substitution -- equal the sequential plain versions bit for bit, and
    K3's model equals K2's model applied to K1's."""
    parent = TREES[name]
    gax, d, b = _tree_case(parent)
    sched = h_ref.hines_schedule(parent)
    de = h_ref.hines_factor_sched_ref(sched, gax, d)
    assert torch.equal(de, h_ref.hines_factor_ref(parent, gax, d))
    x = h_ref.hines_solve_sched_ref(sched, gax, d, b)
    assert torch.equal(x, h_ref.hines_solve_ref(parent, gax, d, b))
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
    """The level schedule as K2's blocks derive it (``derive_schedule`` in
    csrc/hines.cu): each compartment counts the others for its place among
    the compartments ordered by (depth, index) and among its parent's
    children in descending index."""
    C = len(parent)
    dep = []
    for c in range(C):
        k, d = c, 0
        while k > 0 and d < C - 1:
            k, d = parent[k], d + 1
        dep.append(d)
    nodes, kids = [None] * C, [None] * (C - 1)
    lvl, cptr, D = [None] * (C + 1), [None] * C + [C - 1], None
    for c in range(C):
        dc, pc = dep[c], parent[c]
        shallower = sum(dj < dc for dj in dep)
        before = sum(dep[j] == dc for j in range(c))
        deeper = sum(dj > dc for dj in dep)
        nodes[shallower + before] = c
        cptr[c] = sum(parent[j] < c for j in range(1, C))
        if c > 0:
            kids[sum(parent[j] < pc or (parent[j] == pc and j > c)
                     for j in range(1, C))] = c
        if before == 0:
            lvl[dc] = shallower
            if deeper == 0:
                lvl[dc + 1], D = C, dc
    return D, lvl[:D + 2], nodes, cptr, kids


@pytest.mark.parametrize("name", list(TREES))
def test_kernel_schedule_counts_give_the_model_order(name):
    """The counts by which each K2 block derives the schedule from the
    staged parent fill every slot, and give ``ref.hines_schedule``'s
    order: the depths, the compartments by depth, the child ranges and
    each parent's children in descending index."""
    parent = TREES[name]
    D, lvl, nodes, cptr, kids = _schedule_by_counts(parent)
    sched = h_ref.hines_schedule(parent)
    assert D == sched.depth
    assert tuple(lvl) == sched.level_ptr
    assert tuple(nodes) == sched.nodes
    assert tuple(cptr) == sched.child_ptr
    assert tuple(kids) == sched.children


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

