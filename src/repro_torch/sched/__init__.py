"""Scheduler-side queue dispatch of the port (``repro.sched`` counterpart).

Only the dense queue is ported; ``queue="wheel"`` (the bucketed event
wheel and its kernels K6-K8) comes in a later slice.
"""
from repro_torch.sched.api import (QueueOps, edge_insert,  # noqa: F401
                                   get_queue_ops, grouped_k)
