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


# The reference's name of the path an ``impl`` string selects, as its tracer
# events carry it: ``auto`` resolves to ``pallas`` on the reference's
# deployment chip, the port's ``kernel`` tier is that fused path, and its
# ``torch`` tier the unfused ``naive`` baseline; the reference's own strings
# pass unchanged.  Events are computed from this name, never from the tier
# the port runs (``naive`` and ``blocked_jax`` both run ``torch`` here).
_EVENT_IMPL = {"auto": "pallas", "kernel": "pallas", "torch": "naive"}


def event_impl(impl: str | None) -> str:
    """The attention event's ``impl`` for the caller's string."""
    return _EVENT_IMPL.get(impl or "auto", impl)


def conv_event_impl(impl: str | None) -> str:
    """The conv event's ``impl``: the reference's conv tier of the string
    (``blocked_jax`` runs the library conv, ``xla``)."""
    name = event_impl(impl)
    return "xla" if name == "blocked_jax" else name


TIERS = ("kernel", "torch")  # what ``resolve_model_impl`` gives


def resolve_model_impl(impl: str | None) -> str:
    key = impl or "auto"
    if key not in _MODEL_IMPL:
        raise ValueError(f"unknown impl {impl!r} (expected one of {sorted(_MODEL_IMPL)})")
    return _MODEL_IMPL[key]


def is_fused(impl: str | None) -> bool:
    """True when ``impl`` selects the fused (kernel) structure of the model."""
    return resolve_model_impl(impl) == "kernel"
