"""Shared by the ``test_torch_trace_parity_*`` files: each suite model's
full-width operator event stream from the JAX reference and from the port,
and their comparison event for event.

The reference resolves ``impl="auto"`` by its JAX backend: on its
deployment chip (a TPU) to the fused Pallas kernels, ``pallas``; on the CPU
to the unfused ``xla`` conv and ``blocked_jax`` attention.  The port's
``auto`` is its kernel tier, the fused structure, so its oracle is the
reference's deployment stream: the reference is traced abstractly
(``jax.eval_shape``: nothing is compiled or run) with its backend query
answering ``tpu``.  Every other string is traced as given in both packages.
SD and Parti are traced in bf16, as the reference's characterization tests
trace SD.
"""

from __future__ import annotations

import math
from unittest import mock

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as j_get_config
from repro.configs.suite import with_dtype as j_with_dtype
from repro.core import characterize as j_characterize
from repro.workload import workload_for as j_workload_for
from repro_torch.configs import get_config
from repro_torch.configs.suite import with_dtype
from repro_torch.core import characterize
from repro_torch.workload import workload_for

BF16 = ("stable-diffusion", "parti")
FIELDS = ("op", "name", "seq_len", "repeats", "meta")


def reference_events(arch: str, impl: str) -> list:
    cfg = j_get_config(arch)
    if arch in BF16:
        cfg = j_with_dtype(cfg, jnp.bfloat16)
    wl = j_workload_for(cfg)
    if impl != "auto":
        return j_characterize.trace_generative(wl, impl=impl)
    with mock.patch.object(jax, "default_backend", lambda: "tpu"):
        return j_characterize.trace_generative(wl, impl="auto")


def port_events(arch: str, impl: str) -> list:
    cfg = get_config(arch)
    if arch in BF16:
        cfg = with_dtype(cfg, torch.bfloat16)
    wl = workload_for(cfg)
    events = characterize.trace_generative(wl, impl=impl)
    assert all(p.device.type == "meta" for p in wl.model.parameters())
    return events


def assert_streams_equal(got: list, want: list) -> None:
    """Event for event: op, name, seq_len, repeats and meta equal; flops and
    bytes_hbm within 1e-12 relative."""
    assert len(got) == len(want), (len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        for f in FIELDS:
            assert getattr(g, f) == getattr(w, f), (i, f, g, w)
        for f in ("flops", "bytes_hbm"):
            assert math.isclose(getattr(g, f), getattr(w, f), rel_tol=1e-12, abs_tol=0.0), (
                i, f, g, w)
