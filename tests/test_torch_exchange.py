"""The spike-parcel transport's pieces in the port against the JAX
package: K9's plain version and its dispatcher (``spike_compact``)
against JAX's ``compact_rows_ref`` and ``compact_rows_pallas`` (interpret
mode), the ragged class ladder, ``horizon_times(t_table=)`` and
``health_check``; then the process group's collectives, its byte
counters and its launcher on four gloo ranks, and the two transports'
exchange on the same spikes."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)

from repro.core import exec_common as jxc  # noqa: E402
from repro.distributed.exchange import ExchangeSpec as JSpec  # noqa: E402
from repro.kernels.event_wheel import ref as jref  # noqa: E402
from repro.kernels.event_wheel.event_wheel import \
    compact_rows_pallas  # noqa: E402

from repro_torch.core import exec_common as txc  # noqa: E402
from repro_torch.core import network  # noqa: E402
from repro_torch.distributed import group as grp  # noqa: E402
from repro_torch.distributed.exchange import ExchangeSpec  # noqa: E402
from repro_torch.kernels.event_wheel import ops as ew_ops  # noqa: E402
from repro_torch.kernels.event_wheel import ref as tref  # noqa: E402

D, M = 4, 96

# (seed, density, cap): caps below, equal to and above the row length
CASES = [(s, d, c) for s, d, c in [
    (0, 0.05, 8), (1, 0.05, 8), (2, 0.5, 8), (3, 0.5, 40), (4, 1.0, 16),
    (5, 0.3, M), (6, 0.9, M), (7, 0.5, M + 7), (8, 0.0, 8), (9, 0.2, 1)]]


def _inputs(seed, density):
    rng = np.random.default_rng(seed)
    mask = rng.random((D, M)) < density
    mask[0] = False                      # an empty row
    mask[-1] = True                      # a full row
    vals = rng.random((D, M)) * 20.0
    return mask, vals


@pytest.mark.parametrize("seed,density,cap", CASES)
def test_compact_rows_equals_jax(seed, density, cap):
    mask, vals = _inputs(seed, density)
    want_ref = jref.compact_rows_ref(jnp.asarray(mask), jnp.asarray(vals),
                                     cap=cap)
    want_pl = compact_rows_pallas(jnp.asarray(mask), jnp.asarray(vals),
                                  cap=cap, interpret=True)
    got_ref = tref.compact_rows_ref(torch.as_tensor(mask),
                                    torch.as_tensor(vals), cap)
    got_ops = ew_ops.spike_compact(torch.as_tensor(mask),
                                   torch.as_tensor(vals), cap)
    for got in (got_ref, got_ops):
        for g, r, p, dt in zip(got, want_ref, want_pl,
                               (torch.int32, torch.float64, torch.int32)):
            assert g.dtype == dt
            assert np.array_equal(g.numpy(), np.asarray(r))
            assert np.array_equal(g.numpy(), np.asarray(p))
    assert int(got_ops[2][0]) == 0 and int(got_ops[2][-1]) == M


def test_compact_rows_reads_broadcast_and_int_masks():
    """The transport hands K9 a transposed mask and one spike-time row
    broadcast to every destination (stride 0); integer masks keep their
    nonzero entries, as in JAX."""
    rng = np.random.default_rng(11)
    m = torch.as_tensor(rng.random((M, D)) < 0.3).T            # strided
    row = torch.as_tensor(rng.random(M))
    vals = row[None, :].expand(D, M)
    got = ew_ops.spike_compact(m, vals, 12)
    want = tref.compact_rows_ref(m.contiguous(), vals.contiguous(), 12)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    jw = jref.compact_rows_ref(jnp.asarray(m.numpy().astype(np.int32)),
                               jnp.asarray(vals.numpy()), cap=12)
    gi = tref.compact_rows_ref(m.to(torch.int32), vals, 12)
    for g, w in zip(gi, jw):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cap,classes", [(64, ()), (8, ()), (1, ()),
                                         (100, (3, 50, 99, 100, 200)),
                                         (16, (16, 4, 4))])
def test_class_ladder_equals_jax(cap, classes):
    assert ExchangeSpec(parcel_cap=cap, classes=classes).class_ladder() == \
        JSpec(parcel_cap=cap, classes=classes).class_ladder()


def test_horizon_times_with_a_clock_table_equals_jax():
    """The shard-local horizon: global pre ids into the notify table, the
    shard-relative post index, the local clocks for the cap term."""
    n, k, shards = 64, 4, 4
    net = network.make_network(n, k_in=k, seed=2)
    rng = np.random.default_rng(3)
    table = rng.random(n) * 5.0
    nl = n // shards
    for r in range(shards):
        sl = slice(r * nl * k, (r + 1) * nl * k)
        post_rel = np.repeat(np.arange(nl), k)
        t_loc = table[r * nl:(r + 1) * nl]
        jd = jxc.DeviceNet(jnp.asarray(net.pre[sl]), jnp.asarray(post_rel),
                           jnp.asarray(net.delay[sl]),
                           jnp.asarray(net.w_ampa[sl]),
                           jnp.asarray(net.w_gaba[sl]))
        want = jxc.horizon_times(jd, nl, jnp.asarray(t_loc), 6.0,
                                 t_table=jnp.asarray(table), horizon_cap=2.0)
        td = txc.DeviceNet(torch.as_tensor(net.pre[sl]).long(),
                           torch.as_tensor(post_rel),
                           torch.as_tensor(net.delay[sl]),
                           torch.as_tensor(net.w_ampa[sl]),
                           torch.as_tensor(net.w_gaba[sl]))
        got = txc.horizon_times(td, nl, torch.as_tensor(t_loc), 6.0,
                                t_table=torch.as_tensor(table),
                                horizon_cap=2.0)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_health_check_equals_jax():
    from types import SimpleNamespace
    rng = np.random.default_rng(4)
    zn = rng.random((8, 3, 5))
    zn[2, 1, 3] = np.nan
    t = rng.random(8)
    h = rng.random(8)
    h[5] = np.inf
    t_prev = t + np.where(np.arange(8) == 6, 1.0, 0.0)
    hor = t + np.where(np.arange(8) == 1, 3.0, 1.0)
    jst = SimpleNamespace(zn=jnp.asarray(zn), t=jnp.asarray(t),
                          h=jnp.asarray(h))
    tst = SimpleNamespace(zn=torch.as_tensor(zn), t=torch.as_tensor(t),
                          h=torch.as_tensor(h))
    want = jxc.health_check(jst, jnp.asarray(t_prev), jnp.asarray(hor), 2.0)
    got = txc.health_check(tst, torch.as_tensor(t_prev),
                           torch.as_tensor(hor), 2.0)
    assert {k: int(v) for k, v in got.items()} == \
        {k: int(v) for k, v in want.items()} == \
        {"nonfinite_lanes": 2, "clock_regress": 1, "horizon_violations": 1}
    assert txc.empty_health(False) == jxc.empty_health(False)


def _collectives(group):
    """Each collective of ``Group`` on rank-dependent data."""
    r, w = group.rank, group.world
    x = torch.arange(3, dtype=torch.float64) + 10 * r
    gathered = group.all_gather(x, "a")
    rows = torch.arange(w * 2, dtype=torch.int32).reshape(w, 2) + 100 * r
    swapped = group.all_to_all(rows, "b")
    red = {op: group.all_reduce(torch.tensor([r, -r], dtype=torch.int64), op,
                                "c") for op in ("sum", "min", "max")}
    return gathered, swapped, red, group.counters()


def _fails_on_rank_2(group):
    if group.rank == 2:
        raise ValueError("rank 2 gives up")
    group.all_reduce(torch.zeros(1), "sum", "other")


def _exchanges(group):
    """Both transports on the same per-rank spikes."""
    from repro_torch.distributed.exchange import get_transport
    n = 64
    net = network.make_network(n, k_in=4, seed=5)
    rng = np.random.default_rng(group.rank)
    nl = n // group.world
    spiked = torch.as_tensor(rng.random(nl) < 0.4)
    t_sp = torch.where(spiked, torch.as_tensor(rng.random(nl)), 0.0)
    t_loc = torch.as_tensor(rng.random(nl))
    out = {}
    for name in ("allgather", "sparse", "sparse_ragged"):
        tp = get_transport(name, group, n=n, net=net,
                           spec=ExchangeSpec(parcel_cap=16))
        table, _ = tp.notify(t_loc)
        out[name] = (table,) + tuple(tp.exchange(spiked, t_sp))
    return out, group.rank


def test_group_collectives_and_counters():
    gathered, swapped, red, counters = grp.launch(4, _collectives, device="cpu")
    assert torch.equal(gathered, torch.tensor(
        [0., 1, 2, 10, 11, 12, 20, 21, 22, 30, 31, 32], dtype=torch.float64))
    assert torch.equal(swapped, torch.tensor(
        [[0, 1], [100, 101], [200, 201], [300, 301]], dtype=torch.int32))
    assert red["sum"].tolist() == [6, -6] and red["min"].tolist() == [0, -3] \
        and red["max"].tolist() == [3, 0]
    assert counters["a"]["bytes"] == 12 * 8 and counters["b"]["bytes"] == 32
    assert counters["c"] == {"bytes": 48, "calls": 3,
                             "seconds": counters["c"]["seconds"]}


def test_launch_raises_what_a_rank_raised():
    with pytest.raises(RuntimeError, match="rank 2 gives up"):
        grp.launch(4, _fails_on_rank_2, device="cpu")


def test_transports_deliver_the_same_spikes():
    """Rank 0's view: the sparse transports deliver exactly the spikes of
    the neurons with a synapse into shard 0, at their times, and the
    notify table holds every clock that shard 0's in-edges read."""
    out, rank = grp.launch(4, _exchanges, device="cpu")
    assert rank == 0
    net = network.make_network(64, k_in=4, seed=5)
    need = np.zeros(64, bool)
    need[net.pre[: 16 * 4]] = True
    ag_table, ag_sp, ag_t, ag_drop, ag_bytes, ag_peak = out["allgather"]
    assert int(ag_drop) == 0 and ag_bytes == 64 * 9 and int(ag_peak) == 0
    # rank 0's fullest (source, destination) parcel: its spiking neurons
    # with a synapse into one shard
    spiked0 = np.random.default_rng(0).random(16) < 0.4
    into = np.zeros((16, 4), bool)
    own = np.asarray(net.pre) < 16
    into[np.asarray(net.pre)[own], np.asarray(net.post)[own] // 16] = True
    peak = int((into & spiked0[:, None]).sum(axis=0).max())
    assert peak > 0
    for name in ("sparse", "sparse_ragged"):
        table, sp, t_sp, drop, nbytes, got_peak = out[name]
        assert int(drop) == 0 and int(got_peak) == peak
        assert torch.equal(sp, ag_sp & torch.as_tensor(need))
        assert torch.equal(t_sp[sp], ag_t[sp])
        assert torch.equal(table[torch.as_tensor(need)],
                           ag_table[torch.as_tensor(need)])
    assert out["sparse"][4] == 4 * 16 * 12
    assert out["sparse_ragged"][4] <= out["sparse"][4]
