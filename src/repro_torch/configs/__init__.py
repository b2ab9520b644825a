"""Config registry of the port (``--arch`` names, as ``repro.configs``).

Importing ``repro_torch.configs`` registers every ported config; the
suite configs live in ``repro_torch.configs.suite``.
"""

from __future__ import annotations

from typing import Any

_REGISTRY: dict[str, Any] = {}


def register(config) -> None:
    _REGISTRY[config.name] = config


def get_config(name: str):
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]



from repro_torch.configs import suite  # noqa: E402,F401  (registers the suite)
