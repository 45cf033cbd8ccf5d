"""Tenant-isolated simulation serving of the port (``repro.serve``
counterpart): ``SimService`` over ``run.tenant_round`` and the lane
bookkeeping of ``tenants``."""
from repro_torch.serve.service import ServeResult, SimService  # noqa: F401
from repro_torch.serve.tenants import (LaneState, TenantRequest,  # noqa: F401
                                       TenantResult, lane_slice, stack_lanes,
                                       write_lane)
