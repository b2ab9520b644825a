"""Kernel tiers of the port and the mapping from the reference's names.

``impl`` takes the port's tiers -- ``kernel`` (the hand-written CUDA kernel,
or its plain version for a CPU tensor), ``torch`` (composite PyTorch ops) --
plus ``auto`` (= ``kernel``) and the JAX package's model-level strings, so
one parametrisation can drive both packages: ``pallas``/``interpret`` map to
``kernel``; ``blocked_jax``/``xla``/``naive`` to ``torch``.  ``naive`` is
the reference's unfused baseline; eager PyTorch already runs every stage of
the composite tier as its own op, so the two are one path here.
"""

from __future__ import annotations

_MODEL_IMPL = {
    "auto": "kernel",
    "kernel": "kernel",
    "pallas": "kernel",
    "interpret": "kernel",
    "torch": "torch",
    "blocked_jax": "torch",
    "xla": "torch",
    "naive": "torch",
}


TIERS = ("kernel", "torch")  # what ``resolve_model_impl`` gives


def resolve_model_impl(impl: str | None) -> str:
    key = impl or "auto"
    if key not in _MODEL_IMPL:
        raise ValueError(f"unknown impl {impl!r} (expected one of {sorted(_MODEL_IMPL)})")
    return _MODEL_IMPL[key]


def is_fused(impl: str | None) -> bool:
    """True when ``impl`` selects the fused (kernel) structure of the model."""
    return resolve_model_impl(impl) == "kernel"
