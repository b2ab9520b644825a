"""Cascade pipeline executor, the port of ``repro.pipeline``: each
workload's ``CostDescriptor.stages`` as a pipeline of per-stage executors
with bounded handoff queues and cross-request stage-level batching (paper
§IV-C, §V-A).  ``ServeEngine`` with ``route="cascade"`` is the serving entry
point; this package is the machinery."""

from repro_torch.pipeline.cascade import (
    DISPATCH_OVERHEAD_FRAC,
    CascadePipeline,
    stage_batch_sizes,
)
from repro_torch.pipeline.stage import (
    ParkedTask,
    StageBuffer,
    StageExecutor,
    StageTask,
    mean_demand,
    stage_unit_cost,
    state_nbytes,
    state_signature,
)
from repro_torch.workload.base import resolve_stage_impls, split_state, stack_states

__all__ = [
    "CascadePipeline",
    "DISPATCH_OVERHEAD_FRAC",
    "ParkedTask",
    "StageBuffer",
    "StageExecutor",
    "StageTask",
    "mean_demand",
    "resolve_stage_impls",
    "split_state",
    "stack_states",
    "stage_batch_sizes",
    "stage_unit_cost",
    "state_nbytes",
    "state_signature",
]
