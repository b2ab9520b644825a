"""Config registry of the port (``--arch`` names, as ``repro.configs``).

The suite configs live in ``repro_torch.configs.suite``, which registers
them when it is imported (``get_config`` imports it first; the models import
``configs.base``, so this package imports no model).  ``reduced(cfg)``
builds the CPU-test variant of an LM config.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs.base import LMConfig, check_dense

_REGISTRY: dict[str, Any] = {}


def register(config) -> None:
    _REGISTRY[config.name] = config


def get_config(name: str):
    from repro_torch.configs import suite  # noqa: F401  (registers the suite)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    """The registered ``--arch`` names."""
    from repro_torch.configs import suite  # noqa: F401  (registers the suite)

    return sorted(_REGISTRY)


def reduced(cfg: LMConfig) -> LMConfig:
    """Tiny same-family config for CPU tests (``repro.configs.reduced``):
    the dense branch; the other families' reductions come with them."""
    check_dense(cfg)
    return dataclasses.replace(
        cfg, name=cfg.name + "-reduced", n_layers=max(2, min(4, cfg.n_layers)), d_model=64,
        n_heads=4, n_kv_heads=min(4, max(1, cfg.n_kv_heads * 4 // max(cfg.n_heads, 1))),
        head_dim=16, d_ff=128 if cfg.d_ff else 0, vocab=256,
        window=None if cfg.window is None else 8)
