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
from repro_torch.workload.ar_image import ARImageWorkload
from repro_torch.workload.diffusion import DiffusionWorkload
from repro_torch.workload.lm import LMWorkload
from repro_torch.workload.ttv import MakeAVideoWorkload, PhenakiWorkload

__all__ = [
    "ARImageWorkload", "CostDescriptor", "DiffusionWorkload", "GenRequest",
    "GenerativeWorkload", "LMWorkload", "MakeAVideoWorkload", "PhenakiWorkload", "Stage",
    "reduced_workload", "register_workload", "stage_generator", "stage_noise",
    "workload_for",
]
