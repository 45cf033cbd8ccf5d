"""The port's meshes and LM sharding specs (``repro_torch.launch.mesh``,
``repro_torch.distributed.sharding``) against the JAX package's, on the
CPU with no devices behind the meshes.

* mesh geometry: every mesh function gives JAX's shape and axes for the
  same arguments (JAX's own functions run with ``jax.devices`` standing in
  for 512 devices and the mesh constructor recording its arguments);
* specs, for every arch of the registry reduced and at full size (JAX
  through ``jax.eval_shape``, the port on the ``meta`` device), every
  shape and the (4, 2), (16, 16) and (2, 16, 16) meshes: each fitted spec
  of the parameters, AdamW state, batch, token and decode state equals
  JAX's leaf by leaf -- for the port's per-layer leaves, JAX's spec of the
  stacked leaf without its leading ``None`` -- each device's shard shape
  equals ``NamedSharding.shard_shape`` (over a ``jax.sharding.
  AbstractMesh``), and the dry run's argument bytes equal JAX's sum;
* ``model_flops`` equals JAX's ``repro.launch.dryrun.model_flops`` for
  every arch and shape.
"""
import contextlib
import math
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.distributed import sharding as j_shd  # noqa: E402
from repro.launch import mesh as j_mesh  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.distributed import sharding as t_shd  # noqa: E402
from repro_torch.launch import dryrun as t_dry  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402

MESHES = {"4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
STACKED = ("layers", "enc", "dec")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the meta tensors do no arithmetic, and the
    suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _jax_dryrun_module():
    """``repro.launch.dryrun``, imported with the backend already up and
    ``XLA_FLAGS`` restored: the module sets 512 host devices for itself."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
        yield dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


# ---------------------------------------------------------------------------
# mesh geometry
# ---------------------------------------------------------------------------
@pytest.fixture
def jax_mesh_calls(monkeypatch):
    """JAX's mesh functions with 512 stand-in devices, returning the
    (shape, axes) their constructor was given."""
    monkeypatch.setattr(j_mesh.jax, "devices", lambda: list(range(512)))
    monkeypatch.setattr(j_mesh, "_mk",
                        lambda shape, axes, devices: (tuple(shape),
                                                      tuple(axes)))
    return j_mesh


def _geom(m):
    return m.sizes, m.axis_names


def test_mesh_geometry_matches_jax(jax_mesh_calls, monkeypatch):
    jm = jax_mesh_calls
    for multi in (False, True):
        assert _geom(t_mesh.make_production_mesh(multi_pod=multi)) == \
            jm.make_production_mesh(multi_pod=multi)
    for n in list(range(1, 65)) + [96, 100, 128, 200, 256, 384, 512]:
        for mp in (1, 2, 4, 8, 16, 32):
            assert _geom(t_mesh.elastic_mesh(n, mp)) == \
                jm.elastic_mesh(n, mp), (n, mp)
    assert _geom(t_mesh.make_mesh_compat((4, 2), ("data", "model"))) == \
        ((4, 2), ("data", "model"))
    # the local mesh over this machine's devices: none here, so one
    monkeypatch.setattr(j_mesh.jax, "devices", lambda: [0])
    for n_model in (1, 2):
        assert _geom(t_mesh.make_local_mesh(n_model)) == \
            jm.make_local_mesh(n_model)
    m = t_mesh.make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512


# ---------------------------------------------------------------------------
# specs, leaf by leaf
# ---------------------------------------------------------------------------
_JAX_TREES = {}


def _jax_trees(arch, reduced):
    """JAX's (params, AdamW state) of an arch as ShapeDtypeStructs."""
    key = (arch, reduced)
    if key not in _JAX_TREES:
        cfg = j_configs.get_config(arch)
        cfg = cfg.reduced() if reduced else cfg
        params = jax.eval_shape(
            lambda: j_lm.init_params(cfg, jax.random.PRNGKey(0)))
        _JAX_TREES[key] = (cfg, params, jax.eval_shape(j_adamw_init, params))
    return _JAX_TREES[key]


def _path_name(path):
    return "/".join(str(getattr(p, "key", getattr(p, "name", "")))
                    for p in path if hasattr(p, "key") or hasattr(p, "name"))


def _jax_leaves(tree, specs, mesh):
    """{name: (JAX fitted spec, its shard shape, stacked)} by the leaf's
    key path (list indices dropped)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    sp = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for (path, leaf), s in zip(flat, sp):
        name = _path_name(path)
        shard = NamedSharding(mesh, s).shard_shape(leaf.shape)
        out[name] = (tuple(s), tuple(shard), name.split("/")[0] in STACKED)
    return out


def _check_tree(t_tree, t_specs, j_leaves, tmesh, what):
    from torch.utils._pytree import tree_flatten_with_path
    t_flat = tree_flatten_with_path(t_tree)[0]
    s_flat = [s for _, s in tree_flatten_with_path(
        t_specs, is_leaf=lambda x: isinstance(x, t_shd.P))[0]]
    assert len(t_flat) == len(s_flat)
    seen = set()
    for (path, leaf), spec in zip(t_flat, s_flat):
        name = "/".join(str(getattr(p, "key", getattr(p, "name", "")))
                        for p in path if not hasattr(p, "idx"))
        j_spec, j_shard, stacked = j_leaves[name]
        seen.add(name)
        want_spec = j_spec[1:] if stacked else j_spec
        want_shard = j_shard[1:] if stacked else j_shard
        assert tuple(spec) == tuple(want_spec), (what, name, spec, j_spec)
        assert t_shd.shard_shape(tuple(leaf.shape), spec, tmesh) == \
            want_shard, (what, name)
    assert seen == set(j_leaves), (what, set(j_leaves) - seen)


def _jax_bytes(tree, specs, mesh):
    leaves = jax.tree_util.tree_leaves(tree)
    sp = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return sum(math.prod(NamedSharding(mesh, s).shard_shape(x.shape)) *
               np.dtype(x.dtype).itemsize for x, s in zip(leaves, sp))


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", sorted(j_configs.ARCHS))
def test_specs_shards_and_argument_bytes_match_jax(arch, reduced):
    with _jax_dryrun_module() as j_dry:
        jcfg, jparams, jopt = _jax_trees(arch, reduced)
        tcfg = t_configs.get_config(arch)
        tcfg = tcfg.reduced() if reduced else tcfg
        tparams = t_dry.params_meta(tcfg)
        from repro_torch.optim import adamw_init
        topt = adamw_init(tparams)
        for mname, (shape, axes) in MESHES.items():
            jmesh = AbstractMesh(shape, axes)
            tmesh = t_mesh.make_mesh_compat(shape, axes)
            fit_j = lambda s, t: j_shd.fit_specs(s, t, jmesh)  # noqa: E731
            fit_t = lambda s, t: t_shd.fit_specs(s, t, tmesh)  # noqa: E731
            jps = fit_j(j_shd.param_specs(jcfg, jparams, jmesh), jparams)
            tps = fit_t(t_shd.param_specs(tcfg, tparams, tmesh), tparams)
            _check_tree(tparams, tps, _jax_leaves(jparams, jps, jmesh),
                        tmesh, (arch, mname, "params"))
            jos = fit_j(j_shd.opt_specs(jcfg, jopt, jmesh), jopt)
            tos = fit_t(t_shd.opt_specs(tcfg, topt, tmesh), topt)
            assert tuple(tos.step) == tuple(jos.step) == ()
            for part in ("mu", "nu"):
                _check_tree(getattr(topt, part), getattr(tos, part),
                            _jax_leaves(getattr(jopt, part),
                                        getattr(jos, part), jmesh),
                            tmesh, (arch, mname, part))
            for sname, shp in t_configs.SHAPES.items():
                jshape = j_configs.SHAPES[sname]
                _, targs, tspecs = t_dry.build(tcfg, shp, tmesh)
                tbytes = t_dry.argument_bytes(shp.kind, targs, tspecs,
                                              tmesh)
                if shp.kind == "decode":
                    jin = j_dry.input_specs(jcfg, jshape)
                    jss = fit_j(j_shd.decode_state_specs(jcfg, jshape,
                                                         jmesh), jin["state"])
                    jts = fit_j(j_shd.token_spec(jcfg, jshape, jmesh),
                                jin["token"])
                    _check_tree(targs[2], tspecs[2],
                                _jax_leaves(jin["state"], jss, jmesh),
                                tmesh, (arch, mname, sname, "state"))
                    assert tuple(tspecs[1]) == tuple(jts)
                    jargs = (jparams, jin["token"], jin["state"])
                    jspecs = (jps, jts, jss)
                else:
                    jb = j_dry.input_specs(jcfg, jshape)
                    braw = j_shd.batch_specs(jcfg, jshape, jmesh)
                    jbs = fit_j({k: braw[k] for k in jb}, jb)
                    assert {k: tuple(v) for k, v in tspecs[-1].items()} == \
                        {k: tuple(v) for k, v in jbs.items()}, (arch, sname)
                    jargs = (jparams, jopt, jb) if shp.kind == "train" \
                        else (jparams, jb)
                    jspecs = (jps, jos, jbs) if shp.kind == "train" \
                        else (jps, jbs)
                assert sum(tbytes.values()) == sum(
                    _jax_bytes(a, s, jmesh) for a, s in zip(jargs, jspecs)), \
                    (arch, mname, sname)


def test_model_flops_match_jax():
    with _jax_dryrun_module() as j_dry:
        for arch in sorted(j_configs.ARCHS):
            for sname in j_configs.SHAPES:
                assert t_dry.model_flops(
                    t_configs.get_config(arch), t_configs.SHAPES[sname]) == \
                    j_dry.model_flops(j_configs.get_config(arch),
                                      j_configs.SHAPES[sname]), (arch, sname)


def test_partition_spec_and_shards():
    mesh = t_mesh.make_mesh_compat((2, 4, 2), ("pod", "data", "model"))
    assert t_shd.P(("data",), None) == t_shd.P("data", None)
    spec = t_shd._fit_one(t_shd.P(("pod", "data"), "model"), (12, 6), mesh)
    assert tuple(spec) == ("pod", "model")    # 12 % 8: only pod divides
    assert t_shd.shard_shape((12, 6), spec, mesh) == (6, 3)
    with pytest.raises(ValueError, match="does not divide"):
        t_shd.shard_shape((5, 6), t_shd.P("pod"), mesh)
    x = torch.empty((12, 6), dtype=torch.bfloat16, device="meta")
    assert t_shd.shard_bytes({"x": x}, {"x": spec}, mesh) == 6 * 3 * 2
