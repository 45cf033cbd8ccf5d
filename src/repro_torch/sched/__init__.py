"""Scheduler-side queue structures of the port (``repro.sched``
counterpart).

``wheel`` - the bucketed event wheel (calendar queue): insert by prefix
            sums over bucket slots, ranked by kernel K8, no sort.
``api``   - the ``queue="dense"|"wheel"`` dispatch every execution model
            uses, and the compact path's queue-row gather/scatter.
"""
from repro_torch.sched.api import (QueueOps, edge_insert,  # noqa: F401
                                   gather_rows, get_queue_ops, grouped_k,
                                   scatter_rows)
from repro_torch.sched.wheel import (WheelQueue, WheelSpec,  # noqa: F401
                                     bucket_occupancy, deliver_until, insert,
                                     insert_grouped, make_wheel, next_time)
