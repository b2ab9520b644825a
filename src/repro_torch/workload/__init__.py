"""Workload protocol and registry; importing this package registers the
ported workloads."""

from repro_torch.workload.base import (
    CostDescriptor,
    GenerativeWorkload,
    GenRequest,
    Stage,
    reduced_workload,
    register_workload,
    stage_generator,
    stage_noise,
    workload_for,
)
from repro_torch.workload.diffusion import DiffusionWorkload

__all__ = [
    "CostDescriptor", "DiffusionWorkload", "GenRequest", "GenerativeWorkload", "Stage",
    "reduced_workload", "register_workload", "stage_generator", "stage_noise",
    "workload_for",
]
