"""Characterization entry points, the port of ``repro.core.characterize``:
trace a workload, get its event stream.

``trace_workload`` runs a model function on ``meta`` tensors with the tracer
active: parameters and activations have shapes and dtypes but no storage,
so characterizing a 21.9 B-parameter pipeline allocates nothing, while every
layer still records its exact shape-derived FLOPs and bytes.  The kernel
wrappers take their plain versions shape-only on ``meta``
(``kernels.build.takes_plain``): nothing is computed, nothing launched.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import tracer
from repro_torch.core.tracer import OpEvent


def abstract_params(model: torch.nn.Module) -> torch.nn.Module:
    """A workload's model as built, every parameter on ``meta`` (never
    through ``nn.init_module``): the counterpart of the reference's
    ``eval_shape`` of ``model.init``."""
    bad = [k for k, p in model.named_parameters() if p.device.type != "meta"]
    if bad:
        raise ValueError(f"parameters not on meta: {bad[:3]}")
    return model


def _check_meta(args) -> None:
    for a in args:
        if isinstance(a, torch.Tensor) and a.device.type != "meta":
            raise ValueError(f"trace_workload takes meta tensors, got one on {a.device}")


@torch.inference_mode()
def trace_workload(fn: Callable, *args, **kwargs) -> list[OpEvent]:
    """Trace ``fn(*args)`` on ``meta`` tensors and return its event stream."""
    _check_meta(args)
    with tracer.trace() as tr:
        fn(*args, **kwargs)
    return tr.events


@torch.inference_mode()
def trace_concrete(fn: Callable, *args, **kwargs) -> list[OpEvent]:
    """Trace while actually executing (small models, tests)."""
    with tracer.trace() as tr:
        fn(*args, **kwargs)
    return tr.events


def trace_generative(workload, impl: str = "auto") -> list[OpEvent]:
    """The event stream of a ``GenerativeWorkload``'s representative
    inference (its ``trace_events`` recipe: the full pipeline for
    single-pass generators, prefill + sampled decode steps for the
    autoregressive ones)."""
    return list(workload.trace_events(impl=impl))
