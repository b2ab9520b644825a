"""Serving, the port of ``repro.serving``: arrival traces, the bucketed and
denoise-pod schedulers, and the ``ServeEngine`` behind the lm, pod and
cascade routes."""

from repro_torch.serving.arrivals import ON_COMPLETION, PATTERNS, ArrivalTrace
from repro_torch.serving.scheduler import (
    BucketedScheduler,
    DenoisePodScheduler,
    Request,
    bucket_of,
)
from repro_torch.serving.engine import LMServeEngine, ServeConfig, ServeEngine

__all__ = [
    "ON_COMPLETION",
    "PATTERNS",
    "ArrivalTrace",
    "BucketedScheduler",
    "DenoisePodScheduler",
    "Request",
    "bucket_of",
    "LMServeEngine",
    "ServeConfig",
    "ServeEngine",
]
