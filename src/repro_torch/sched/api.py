"""Queue-implementation dispatch: the ``queue="dense"|"wheel"`` knob.

Every execution model builds a ``QueueOps`` and goes through it for all
queue traffic, as in ``repro.sched.api``, so the dense queue and the
bucketed event wheel stay interchangeable.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.sched import wheel as wh
from repro_torch.sched.wheel import WheelQueue, WheelSpec


class QueueOps(NamedTuple):
    name: str
    capacity: int
    make: Callable            # (n, device) -> queue
    insert: Callable          # (eq, target[E], t[E], wa[E], wg[E], valid[E]) -> eq
    insert_grouped: Callable  # (eq, t[N,k], wa[N,k], wg[N,k], valid[N,k]) -> eq
    insert_batch: Callable    # insert for a small batch (flat in N)
    next_time: Callable       # (eq,) -> f64[N]
    deliver_until: Callable   # (eq, t_dl[N]) -> (eq, wa[N], wg[N], cnt[N])
    wrap: Callable            # (t, wa, wg, dropped) -> queue


def _dense_insert_grouped(eq, t_ev, w_ampa, w_gaba, valid):
    n, k = t_ev.shape
    tgt = torch.arange(n, dtype=torch.int64,
                       device=t_ev.device).repeat_interleave(k)
    return ev.insert(eq, tgt, t_ev.reshape(-1), w_ampa.reshape(-1),
                     w_gaba.reshape(-1), valid.reshape(-1))


def get_queue_ops(queue: str = "dense", *, ev_cap: int = 64,
                  wheel: WheelSpec = WheelSpec()) -> QueueOps:
    if queue == "dense":
        return QueueOps(
            name="dense", capacity=ev_cap,
            make=lambda n, device: ev.make_queue(n, ev_cap, device),
            insert=ev.insert,
            insert_grouped=_dense_insert_grouped,
            insert_batch=ev.insert_rows,
            next_time=ev.next_time,
            deliver_until=ev.deliver_until,
            wrap=ev.EventQueue,
        )
    if queue == "wheel":
        # the generic insert doubles as the batch insert: its ranking
        # (K8) is pairwise over the batch, whatever the number of keys
        ins = functools.partial(wh.insert, wheel)
        return QueueOps(
            name="wheel", capacity=wheel.capacity,
            make=lambda n, device: wh.make_wheel(n, wheel, device),
            insert=ins,
            insert_grouped=functools.partial(wh.insert_grouped, wheel),
            insert_batch=ins,
            next_time=wh.next_time,
            deliver_until=wh.deliver_until,
            wrap=WheelQueue,
        )
    raise ValueError(f"unknown queue implementation {queue!r}")


def gather_rows(eq, ids):
    """Queue rows (t, w_ampa, w_gaba) of a compacted id list, ``ids``
    clipped to [0, N).  Both queues share the [N, Q] flat slot layout, so
    one gather serves either."""
    return eq.t[ids], eq.w_ampa[ids], eq.w_gaba[ids]


def scatter_rows(eq, ids, t_rows):
    """Write advanced delivery-time rows back; sentinel ids (>= N) are
    dropped.  The advance consumes events by setting their times to +inf
    and never touches the weights, so only ``t`` is written."""
    from repro_torch.core import exec_common as xc
    return eq._replace(t=xc.scatter_at(eq.t, ids, t_rows))


def grouped_k(net):
    """Host-side check of ``make_network``'s static edge layout: edges
    grouped by postsynaptic neuron with uniform in-degree.  Returns the
    in-degree k when the layout holds, else None."""
    post = np.asarray(net.post)
    E, n = post.shape[0], int(net.n)
    if E % n == 0 and np.array_equal(
            post, np.repeat(np.arange(n, dtype=post.dtype), E // n)):
        return E // n
    return None


def edge_insert(qops: QueueOps, net) -> Callable:
    """Best insert path for a network's static edge list: the grouped path
    when ``grouped_k`` holds, otherwise the generic insert."""
    k = grouped_k(net)
    if k is None:
        return qops.insert
    n = int(net.n)

    def ins(eq, target, t_ev, w_ampa, w_gaba, valid):
        return qops.insert_grouped(eq, t_ev.reshape(n, k),
                                   w_ampa.reshape(n, k),
                                   w_gaba.reshape(n, k),
                                   valid.reshape(n, k))

    return ins
