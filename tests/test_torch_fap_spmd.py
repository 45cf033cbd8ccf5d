"""The port's SPMD FAP round (``repro_torch.distributed``) on four gloo
ranks on the CPU, against live JAX ``run_fap_spmd`` on four host devices.

The configurations of ``tests/test_fap_spmd.py`` (soma_only, N = 32, k_in
= 4, seed 3, six transports and knobs plus a placed block net, and the
paper-faithful global round ``optimized=False``, 6 ms):

* against JAX -- spike counts exact and spike times within ``T_TOL`` at
  6 ms; every counter (steps, solver counters, events, resets, drops,
  rounds, parcel bytes) exact at 3 ms, before the step sequences drift
  apart (ROADMAP §3); and, for ``sparse`` and ``allgather``, each round run
  from JAX's own carried state with every counter exact;
* inside the port, exactly -- ``sparse`` == ``allgather`` == the full
  stack == the global round == the single-host
  ``run_fap_vardt(step_budget=8)``, the global round with the wheel queue
  == ``allgather`` with it, and the placed run == its unplaced
  single-host anchor;
* drops, bytes -- overflow fires ``dropped``; the per-channel byte
  counters show ragged parcels at or below the static cap's, parcel bytes
  set by the cap and not by N, and a placed block net's notify bytes
  below a uniform net's by the frontier ratio (these stand in for the
  JAX tests' compiled-HLO byte attribution).

JAX runs in four subprocesses (the host device count locks at its first
initialisation; the 6 ms runs, the 3 ms runs, the global round's 6 and 3
ms runs and the round records), in parallel with the port's ranks.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import exec_fap  # noqa: E402
from repro_torch.core import morphology, network  # noqa: E402
from repro_torch.core.cell import CellModel  # noqa: E402
from repro_torch.core.topology import TopologyConfig  # noqa: E402
from repro_torch.distributed import group as grp  # noqa: E402
from repro_torch.distributed import placement as plc  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
T_TOL = 1e-6      # ms, spike times against JAX (tests/test_torch_exec_fap.py)
T_FULL = 3.0      # ms, every counter exact against JAX
T_END = 6.0       # ms, the JAX tests' runs
N, K_IN, SEED = 32, 4, 3

# name -> (knobs, block net); caps as in tests/test_fap_spmd.py
CONFIGS = {
    "allgather": (dict(transport="allgather"), False),
    "sparse": (dict(transport="sparse", parcel_cap=8), False),
    "sparse_wheel": (dict(transport="sparse", parcel_cap=8, queue="wheel"),
                     False),
    "sparse_compact": (dict(transport="sparse", parcel_cap=8,
                            batch="compact"), False),
    "sparse_ragged": (dict(transport="sparse_ragged", parcel_cap=8), False),
    "full_stack": (dict(transport="sparse_ragged", parcel_cap=8,
                        batch="compact", fanout="compact", spike_cap=8,
                        horizon="incremental"), False),
    "placed": (dict(transport="sparse", parcel_cap=8, placement="greedy"),
               True),
}
# the global round runs in a JAX subprocess of its own
GLOBAL = {"global": (dict(optimized=False), False)}
# port-only runs at T_END: the global round and allgather on the wheel
WHEEL = {"global_wheel": dict(optimized=False, queue="wheel"),
         "allgather_wheel": dict(transport="allgather", queue="wheel")}

JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_enable_x64", True)

from repro import sched
from repro.core import bdf, morphology, network
from repro.core import exec_common as xc
from repro.core.cell import CellModel
from repro.core.topology import TopologyConfig
from repro.distributed.exchange import ExchangeSpec
from repro.distributed.fap_spmd import (PaperNeuroSpec, build_fap_round,
                                        run_fap_spmd)
from repro.launch.mesh import make_mesh_compat

mode, out_path = sys.argv[1], sys.argv[2]
configs = pickle.loads(bytes.fromhex(sys.argv[3]))
mesh = make_mesh_compat((2, 2), ("data", "model"))
model = CellModel(morphology.soma_only())
n = 32
nets = {False: network.make_network(n, k_in=4, seed=3),
        True: network.make_network(n, k_in=4, seed=3,
                                   topology=TopologyConfig("block", n_blocks=4,
                                                           p_in=0.95))}
iinj = 0.16 + 0.004 * np.random.default_rng(1).standard_normal(n)
out = {}


def knobs(kw):
    kw = dict(kw)
    if "parcel_cap" in kw:
        kw["exchange"] = ExchangeSpec(parcel_cap=kw.pop("parcel_cap"))
    return kw


t_ends = {"t6": (6.0,), "t3": (3.0,), "global": (6.0, 3.0),
          "rounds": ()}[mode]
for t_end, (name, (kw, block)) in [(t, c) for t in t_ends
                                   for c in configs.items()]:
    res, rounds = run_fap_spmd(model, nets[block], iinj, t_end, mesh,
                               max_rounds=60, **knobs(kw))
    key = f"{name}/{t_end}" if mode == "global" else name
    out[key] = {"times": np.asarray(res.rec.times),
                 "count": np.asarray(res.rec.count),
                 "n_steps": int(res.n_steps), "n_events": int(res.n_events),
                 "n_resets": int(res.n_resets), "dropped": int(res.dropped),
                 "failed": bool(res.failed), "rounds": rounds,
                 "parcel_bytes": int(res.comm["parcel_bytes"]),
                 "solver": {k: int(v) for k, v in res.solver.items()}}

if mode == "rounds":
    # every round of a 6 ms run, inputs and outputs, for the port to rerun
    net = nets[False]
    spec = PaperNeuroSpec(n_neurons=n, k_in=4, ev_cap=32, t_end=6.0,
                          horizon_cap=2.0)
    qops = sched.get_queue_ops("dense", ev_cap=32)
    iinj_v = jnp.asarray(iinj, jnp.float64)
    dnet = xc.to_device(net)
    for tr in ("sparse", "allgather"):
        fn, ex_args, in_sh = build_fap_round(
            model, spec, mesh, optimized=True, transport=tr,
            exchange=ExchangeSpec(parcel_cap=8), net=net)
        static = jax.device_put(
            (dnet.pre, dnet.post, dnet.delay, dnet.w_ampa, dnet.w_gaba,
             iinj_v) + ex_args[10:], in_sh[4:10] + in_sh[10:])
        jfn = jax.jit(fn, in_shardings=in_sh)
        sts = jax.vmap(lambda y, i: bdf.reinit(model, 0.0, y, i,
                                               bdf.BDFOptions()))(
            xc.batch_init(model, n), iinj_v)
        eq = qops.make(n)
        eq_t, eq_a, eq_g = eq.t, eq.w_ampa, eq.w_gaba
        rounds = []
        while float(sts.t.min()) < 6.0 - 1e-9 and len(rounds) < 60:
            npy = lambda x: jax.tree_util.tree_map(np.asarray, x)
            inp = (npy(sts._asdict()), np.asarray(eq_t), np.asarray(eq_a),
                   np.asarray(eq_g))
            sts, eq_t, eq_a, eq_g, spiked, t_sp, nd, nrs, dropped, pb = jfn(
                sts, eq_t, eq_a, eq_g, *static)
            rounds.append({"in": inp, "sts": npy(sts._asdict()),
                           "eq_t": np.asarray(eq_t),
                           "spiked": np.asarray(spiked),
                           "t_sp": np.asarray(t_sp), "nd": int(nd),
                           "nrs": int(nrs), "dropped": int(dropped),
                           "pbytes": int(pb)})
        out["rounds/" + tr] = rounds
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


def _knobs(kw):
    from repro_torch.distributed.exchange import ExchangeSpec
    kw = dict(kw)
    if "parcel_cap" in kw:
        kw["exchange"] = ExchangeSpec(parcel_cap=kw.pop("parcel_cap"))
    return kw


def _net(n=N, block=False, seed=SEED, p_in=0.95):
    topo = TopologyConfig("block", n_blocks=4, p_in=p_in) if block \
        else "uniform"
    return network.make_network(n, k_in=K_IN, seed=seed, topology=topo)


def _iinj(n=N, base=0.16):
    return base + 0.004 * np.random.default_rng(1).standard_normal(n)


def _summary(res, rounds):
    return {"times": res.rec.times.numpy(), "count": res.rec.count.numpy(),
            "y": res.y_final.numpy(), "n_steps": int(res.n_steps),
            "n_events": int(res.n_events), "n_resets": int(res.n_resets),
            "dropped": int(res.dropped), "failed": bool(res.failed),
            "rounds": rounds,
            "parcel_bytes": res.comm and int(res.comm["parcel_bytes"]),
            "parcel_peak": res.comm and res.comm["parcel_peak"],
            "channels": res.comm and res.comm["channels"],
            "solver": {k: int(v) for k, v in res.solver.items()},
            "health": res.health}


def _port_ranks(group):
    """Every port run of the module on this rank (four ranks, CPU)."""
    from repro_torch.distributed.fap_spmd import run_fap_spmd
    model = CellModel(morphology.soma_only(), device=group.device)
    out = {}

    def run(net, iinj, t_end, **kw):
        res, rounds = run_fap_spmd(model, net, iinj, t_end, group,
                                   max_rounds=60, **_knobs(kw))
        return _summary(res, rounds)

    for name, (kw, block) in {**CONFIGS, **GLOBAL}.items():
        for t_end in (T_FULL, T_END):
            out[f"{name}/{t_end}"] = run(_net(block=block), _iinj(), t_end,
                                         **kw)
    from repro_torch.sched import WheelSpec
    for name, kw in WHEEL.items():
        out[f"{name}/{T_END}"] = run(_net(), _iinj(), T_END,
                                     wheel=WheelSpec.auto(_net()), **kw)
    hot = _iinj(base=0.20)
    out["overflow"] = run(_net(), hot, T_END, transport="sparse",
                          parcel_cap=1)
    out["ragged_overflow"] = run(_net(), hot, T_END,
                                 transport="sparse_ragged", parcel_cap=2)
    # per-round channel bytes at two widths, and placed block vs uniform
    # (the nets of tests/test_fap_spmd.py's byte checks)
    for n_ in (64, 256):
        for tr in ("sparse", "allgather"):
            out[f"bytes/{tr}/{n_}"] = run(_net(n_, seed=5), _iinj(n_), 0.5,
                                          transport=tr, parcel_cap=8)
    out["bytes/block_placed"] = run(_net(256, True, seed=5, p_in=0.98),
                                    _iinj(256), 0.5, transport="sparse",
                                    parcel_cap=8, placement="greedy")
    return out


def _port_from_jax_rounds(group, path):
    """Each recorded JAX round rerun by the port's round from JAX's
    inputs; the outputs are gathered to every rank."""
    from repro_torch.distributed.exchange import ExchangeSpec
    from repro_torch.distributed.fap_spmd import (PaperNeuroSpec,
                                                  build_fap_round, shard_rows)
    from repro_torch.core import exec_common as xc
    with open(path, "rb") as f:
        data = pickle.load(f)
    model = CellModel(morphology.soma_only(), device="cpu")
    net = _net()
    dnet = xc.to_device(net, "cpu")
    spec = PaperNeuroSpec(n_neurons=N, k_in=K_IN, ev_cap=32, t_end=T_END,
                          horizon_cap=2.0)
    static = tuple(shard_rows(x, group) for x in
                   (dnet.pre, dnet.delay, dnet.w_ampa, dnet.w_gaba,
                    xc.per_neuron(_iinj(), N, "cpu")))
    out = {}
    for tr in ("sparse", "allgather"):
        fn = build_fap_round(model, spec, group, optimized=True,
                             transport=tr,
                             exchange=ExchangeSpec(parcel_cap=8), net=net)
        got = []
        for r in data["rounds/" + tr]:
            sts_in, eq_t, eq_a, eq_g = r["in"]
            sts = interop.bdf_state_from_numpy(sts_in, "cpu")
            rows = [shard_rows(x, group) for x in
                    (torch.as_tensor(eq_t), torch.as_tensor(eq_a),
                     torch.as_tensor(eq_g))]
            o = fn(type(sts)(*[shard_rows(x, group) for x in sts]), *rows,
                   *static)
            gather = lambda x: group.all_gather(x, "other")  # noqa: E731
            got.append({"sts": {k: gather(v).numpy()
                                for k, v in o[0]._asdict().items()},
                        "eq_t": gather(o[1]).numpy(),
                        "spiked": gather(o[4]).numpy(),
                        "t_sp": gather(o[5]).numpy(), "nd": int(o[6]),
                        "nrs": int(o[7]), "dropped": int(o[8]),
                        "pbytes": int(o[9])})
        out[tr] = got
    return out


@pytest.fixture(scope="module")
def jax_procs(tmp_path_factory):
    """Start the JAX subprocesses (the 6 ms runs, the 3 ms runs, the global
    round's runs, the round records) before the port's ranks, so that they
    all overlap."""
    d = tmp_path_factory.mktemp("jax_spmd")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    procs = {}
    for mode in ("t6", "t3", "global", "rounds"):
        path = str(d / f"{mode}.pkl")
        cfg = pickle.dumps(GLOBAL if mode == "global" else CONFIGS).hex()
        procs[mode] = (subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT, mode, path, cfg], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), path)
    yield procs
    for p, _ in procs.values():
        if p.poll() is None:
            p.kill()


def _jax_result(procs, mode):
    p, path = procs[mode]
    _, err = p.communicate(timeout=900)
    assert p.returncode == 0, err[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def port(jax_procs):
    return grp.launch(4, _port_ranks, backend="gloo", device="cpu")


@pytest.fixture(scope="module")
def jax_global(jax_procs, port):
    return _jax_result(jax_procs, "global")


def _jax_at(procs, mode, t_end, name):
    """JAX's run of ``name`` at ``t_end``: the global round's from its own
    subprocess, the others' from the subprocess of ``mode``."""
    if name in GLOBAL:
        return _jax_result(procs, "global")[f"{name}/{t_end}"]
    return _jax_result(procs, mode)[name]


@pytest.fixture(scope="module")
def jax6(jax_procs, port):
    return lambda name: _jax_at(jax_procs, "t6", T_END, name)


@pytest.fixture(scope="module")
def jax3(jax_procs, port):
    return lambda name: _jax_at(jax_procs, "t3", T_FULL, name)


@pytest.fixture(scope="module")
def single_host():
    """The single-host anchors: the port's ``run_fap_vardt`` with the
    SPMD round's step budget, on the uniform and the (unplaced) block
    net."""
    model = CellModel(morphology.soma_only(), device="cpu")
    return {block: _summary(exec_fap.run_fap_vardt(
        model, _net(block=block), _iinj(), T_END, step_budget=8, ev_cap=32,
        device="cpu"), None) for block in (False, True)}


def _same_trains(a, b, spk_cap):
    assert np.array_equal(a["count"], b["count"])
    assert np.array_equal(a["times"][:, :spk_cap], b["times"][:, :spk_cap])


@pytest.mark.parametrize("name", list(CONFIGS) + list(GLOBAL))
def test_spike_trains_match_live_jax(port, jax6, name):
    p, j = port[f"{name}/{T_END}"], jax6(name)
    assert int(j["count"].sum()) > 0
    assert np.array_equal(p["count"], j["count"])
    fin = np.isfinite(j["times"])
    assert np.array_equal(np.isfinite(p["times"]), fin)
    np.testing.assert_allclose(p["times"][fin], j["times"][fin], rtol=0,
                               atol=T_TOL)
    for k in ("n_events", "n_resets", "dropped", "failed", "rounds"):
        assert p[k] == j[k], k
    assert p["dropped"] == 0 and not p["failed"]
    h = p["health"]                # the watchdog looked at every round
    assert h["checks"] == p["rounds"] and h["rollbacks"] == 0
    assert h["clock_regressions"] == h["horizon_violations"] == 0


@pytest.mark.parametrize("name", list(CONFIGS) + list(GLOBAL))
def test_counters_match_live_jax_to_3ms(port, jax3, name):
    p, j = port[f"{name}/{T_FULL}"], jax3(name)
    for k in ("n_steps", "n_events", "n_resets", "dropped", "failed",
              "rounds", "parcel_bytes"):
        assert p[k] == j[k], k
    for k, v in j["solver"].items():
        assert p["solver"][k] == v, k
    fin = np.isfinite(j["times"])
    assert np.array_equal(np.isfinite(p["times"]), fin)
    np.testing.assert_allclose(p["times"][fin], j["times"][fin], rtol=0,
                               atol=T_TOL)


@pytest.mark.parametrize("name", [k for k in CONFIGS if k != "placed"]
                         + list(GLOBAL))
def test_every_knob_equals_allgather_and_single_host(port, single_host,
                                                     name):
    """Inside the port the transports and knobs change no event and no
    bit: equal spike trains, final states and counters, and equal to the
    single-host runner with the same step budget."""
    ref, p = port[f"allgather/{T_END}"], port[f"{name}/{T_END}"]
    _same_trains(p, ref, 128)
    assert np.array_equal(p["y"], ref["y"])
    for k in ("n_steps", "n_events", "n_resets", "rounds", "solver"):
        assert p[k] == ref[k], k
    sh = single_host[False]
    _same_trains(p, sh, 128)
    assert np.array_equal(p["y"], sh["y"])
    assert p["n_steps"] == sh["n_steps"] and p["n_events"] == sh["n_events"]


def test_global_wheel_round_equals_allgather_wheel(port):
    """The global round's generic wheel insert (K8 over all E events)
    gives what the shard-local grouped wheel insert gives: every bit of
    the trains, final states and counters, and the same bytes on its own
    channels as allgather's two."""
    g, a = port[f"global_wheel/{T_END}"], port[f"allgather_wheel/{T_END}"]
    assert int(a["count"].sum()) > 0
    _same_trains(g, a, 128)
    assert np.array_equal(g["y"], a["y"])
    for k in ("n_steps", "n_events", "n_resets", "dropped", "rounds",
              "solver"):
        assert g[k] == a[k], k
    gc, ac = g["channels"], a["channels"]
    assert gc["global_clocks"]["bytes"] == ac["exchange_notify"]["bytes"]
    assert gc["global_spikes"]["bytes"] == ac["exchange_parcel"]["bytes"]
    assert gc["global_spikes"]["calls"] == 2 * g["rounds"]
    assert "exchange_notify" not in gc and g["parcel_bytes"] == 0
    assert g["parcel_peak"] == [0] * g["rounds"]


def test_placed_run_equals_unplaced_anchor(port, single_host):
    p, sh = port[f"placed/{T_END}"], single_host[True]
    assert int(sh["count"].sum()) > 0 and p["dropped"] == 0
    _same_trains(p, sh, 128)
    assert np.array_equal(p["y"], sh["y"])
    assert p["n_steps"] == sh["n_steps"] and p["n_events"] == sh["n_events"]


def test_parcel_overflow_is_counted(port):
    assert port["overflow"]["dropped"] > 0
    assert port["ragged_overflow"]["dropped"] > 0
    assert port["overflow"]["health"]["dropped_events"] == \
        port["overflow"]["dropped"]


def test_ragged_parcel_bytes_at_or_below_static_cap(port):
    sp, rg = port[f"sparse/{T_END}"], port[f"sparse_ragged/{T_END}"]
    assert rg["rounds"] == sp["rounds"]
    assert 0 < rg["parcel_bytes"] < sp["parcel_bytes"]
    ch = rg["channels"]
    per_class = {int(t.rsplit("_c", 1)[1]): v for t, v in ch.items()
                 if t.startswith("exchange_parcel_c")}
    assert set(per_class) <= {1, 4, 8} and "exchange_parcel" not in ch
    # each round ships one class: two all-to-alls of 4 x c x (4 or 8) bytes
    assert sum(v["calls"] for v in per_class.values()) == 2 * rg["rounds"]
    assert sum(v["bytes"] for v in per_class.values()) == rg["parcel_bytes"]
    assert ch["exchange_counts"]["calls"] == rg["rounds"]
    assert sp["channels"]["exchange_parcel"]["bytes"] == sp["parcel_bytes"] \
        == sp["rounds"] * 4 * 8 * 12


def test_parcel_peak_is_reported_per_round(port):
    """``comm["parcel_peak"]`` holds each round's fullest (source,
    destination) pair over the ranks: zeros for allgather, the same
    rounds for every sparse knob, the ragged class of each round the
    smallest that holds it, past the cap exactly where parcels drop."""
    sp = port[f"sparse/{T_END}"]["parcel_peak"]
    assert len(sp) == port[f"sparse/{T_END}"]["rounds"] and 0 < max(sp) <= 8
    ag = port[f"allgather/{T_END}"]
    assert ag["parcel_peak"] == [0] * ag["rounds"]
    for name in ("sparse_wheel", "sparse_compact", "sparse_ragged",
                 "full_stack"):
        assert port[f"{name}/{T_END}"]["parcel_peak"] == sp, name
    rg = port[f"sparse_ragged/{T_END}"]
    picked = [next(c for c in (1, 4, 8) if p <= c or c == 8) for p in sp]
    for tag, v in rg["channels"].items():
        if tag.startswith("exchange_parcel_c"):
            assert v["calls"] == 2 * picked.count(int(tag.rsplit("_c", 1)[1]))
    for name, cap in (("overflow", 1), ("ragged_overflow", 2)):
        assert max(port[name]["parcel_peak"]) > cap, name


def _per_round(run, tag):
    return run["channels"][tag]["bytes"] / run["rounds"]


def test_parcel_bytes_follow_the_cap_not_n(port):
    sp64 = _per_round(port["bytes/sparse/64"], "exchange_parcel")
    sp256 = _per_round(port["bytes/sparse/256"], "exchange_parcel")
    ag64 = _per_round(port["bytes/allgather/64"], "exchange_parcel")
    ag256 = _per_round(port["bytes/allgather/256"], "exchange_parcel")
    assert sp64 == sp256 == 4 * 8 * (4 + 8)
    assert ag64 == 64 * 9 and ag256 == 256 * 9
    assert sp256 < ag256
    for tr in ("sparse", "allgather"):
        assert _per_round(port[f"bytes/{tr}/256"], "exchange_notify") > 0


def test_placement_cuts_notify_bytes_by_the_frontier_ratio(port):
    uni = _per_round(port["bytes/sparse/256"], "exchange_notify")
    blk = _per_round(port["bytes/block_placed"], "exchange_notify")
    net_b = _net(256, True, seed=5, p_in=0.98)
    pl = plc.compute_placement(net_b, 4, method="greedy")
    f_ratio = plc.frontier_stats(_net(256, seed=5), 4)["F"] \
        / plc.frontier_stats(net_b, 4, pl)["F"]
    assert f_ratio >= 2.0
    assert uni / blk >= max(2.0, 0.8 * f_ratio), (uni / blk, f_ratio)
    assert _per_round(port["bytes/block_placed"], "exchange_parcel") == \
        _per_round(port["bytes/sparse/256"], "exchange_parcel")


@pytest.fixture(scope="module")
def jax_rounds(jax_procs, port):
    return _jax_result(jax_procs, "rounds")


@pytest.fixture(scope="module")
def from_jax(jax_rounds, jax_procs):
    return grp.launch(4, _port_from_jax_rounds, jax_procs["rounds"][1],
                      backend="gloo", device="cpu")


INTS = ("q", "nst", "nfe", "nni", "netf", "nncf", "nreset", "nsetups",
        "qwait", "failed", "jbad")


@pytest.mark.parametrize("tr", ["sparse", "allgather"])
def test_rounds_from_jax_carry(jax_rounds, from_jax, tr):
    """Each round of a JAX run (33 rounds to 6 ms) rerun by the port from
    JAX's carried state: per-lane counters, spikes, queue occupancy and the
    round's counts exact.  Clocks within 1e-8 and steps within 1e-7
    relative: XLA's exp and FMAs differ from the port's in the last bit,
    and the step-size controller's eta = (1 / (6 dsm))^(1 / (q + 1))
    amplifies that over up to 8 steps a round (largest seen: 1.6e-10 for
    t, 1.3e-8 for h, in a round after the first spikes)."""
    jr, pr = jax_rounds["rounds/" + tr], from_jax[tr]
    assert len(jr) == len(pr) > 10
    assert sum(int(r["spiked"].sum()) for r in jr) > 0
    for j, p in zip(jr, pr):
        for k in INTS:
            assert np.array_equal(p["sts"][k], j["sts"][k]), k
        for k, rtol in (("t", 1e-8), ("h", 1e-7)):
            np.testing.assert_allclose(p["sts"][k], j["sts"][k], rtol=rtol,
                                       atol=0, err_msg=k)
        assert np.array_equal(np.isfinite(p["eq_t"]), np.isfinite(j["eq_t"]))
        assert np.array_equal(p["spiked"], j["spiked"])
        np.testing.assert_allclose(p["t_sp"], j["t_sp"], rtol=0, atol=1e-9)
        for k in ("nd", "nrs", "dropped", "pbytes"):
            assert p[k] == j[k], k


def test_unported_and_bad_knobs_raise():
    """The global round (``optimized=False``, the default of
    ``build_fap_round`` as in JAX) builds and rejects what JAX's rejects,
    in JAX's words; checkpoint knobs without a directory and the other
    knob combinations JAX rejects are rejected."""
    from repro_torch.distributed.fap_spmd import (PaperNeuroSpec,
                                                  build_fap_round,
                                                  run_fap_spmd)
    g = grp.Group(0, 4, "gloo", "cpu")
    model = CellModel(morphology.soma_only(), device="cpu")
    spec = PaperNeuroSpec(n_neurons=N, k_in=K_IN)
    assert not build_fap_round(model, spec, g).incremental
    net = _net()
    for kw, words in (
            (dict(transport="sparse", net=net), "global path has no "
             "explicit channels"),
            (dict(batch="compact"), "global path has no shard-local "
             "advance"),
            (dict(fanout="compact", net=net), "compact fan-out is "
             r"shard-local \(optimized=True\)"),
            (dict(horizon="incremental", net=net), "incremental horizon "
             r"maintenance needs the shard-local round \(optimized=True\)")):
        with pytest.raises(ValueError, match=words):
            build_fap_round(model, spec, g, optimized=False, **kw)
    for kw in (dict(checkpoint_every=2), dict(resume=True)):
        with pytest.raises(ValueError, match="ckpt_dir"):
            run_fap_spmd(model, _net(), 0.16, 1.0, g, **kw)
    for kw in (dict(horizon="incremental", transport="sparse"),
               dict(horizon="incremental", batch="compact"),
               dict(batch="wide"), dict(fanout="compact")):
        with pytest.raises(ValueError):
            build_fap_round(model, spec, g, optimized=True, **kw)

