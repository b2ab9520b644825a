"""Config registry of the port (``--arch`` names, as ``repro.configs``).

The suite configs live in ``repro_torch.configs.suite``, which registers
them when it is imported (``get_config`` imports it first; the models import
``configs.base``, so this package imports no model).  The assigned LM
configs register when this package is imported, as the reference's do.
``reduced(cfg)`` builds the CPU-test variant of an LM config.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs.base import LMConfig

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
    the dense, MoE, SSM, encoder, window and M-RoPE branches."""
    changes: dict = dict(
        name=cfg.name + "-reduced", n_layers=max(2, min(4, cfg.n_layers)), d_model=64,
        n_heads=4, n_kv_heads=min(4, max(1, cfg.n_kv_heads * 4 // max(cfg.n_heads, 1))),
        head_dim=16, d_ff=128 if cfg.d_ff else 0, vocab=256,
        window=None if cfg.window is None else 8)
    if cfg.moe is not None:
        # capacity covers the worst case, so no assignment is dropped and
        # prefill == decode holds exactly
        changes.update(d_ff=128, moe=dataclasses.replace(
            cfg.moe, n_experts=8, top_k=min(cfg.moe.top_k, 2), d_ff_expert=32,
            d_ff_shared=64 if cfg.moe.n_shared else 0, capacity_factor=8.0))
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=16)
    if cfg.encoder is not None:
        changes["encoder"] = dataclasses.replace(cfg.encoder, n_layers=2)
    if cfg.mrope_sections is not None:
        changes["mrope_sections"] = (2, 3, 3)  # head_dim 16 -> D/2 = 8
    return dataclasses.replace(cfg, **changes)


# assigned architectures, in the order of the reference's ASSIGNED_ARCHS
from repro_torch.configs import olmo_1b  # noqa: E402,F401
from repro_torch.configs import qwen2_72b  # noqa: E402,F401
from repro_torch.configs import glm4_9b  # noqa: E402,F401
from repro_torch.configs import stablelm_3b  # noqa: E402,F401
from repro_torch.configs import mamba2_780m  # noqa: E402,F401
from repro_torch.configs import whisper_base  # noqa: E402,F401
from repro_torch.configs import qwen2_vl_2b  # noqa: E402,F401
from repro_torch.configs import qwen3_moe_30b_a3b  # noqa: E402,F401
from repro_torch.configs import deepseek_moe_16b  # noqa: E402,F401
from repro_torch.configs import recurrentgemma_9b  # noqa: E402,F401

ASSIGNED_ARCHS = ["olmo-1b", "qwen2-72b", "glm4-9b", "stablelm-3b", "mamba2-780m",
                  "whisper-base", "qwen2-vl-2b", "qwen3-moe-30b-a3b", "deepseek-moe-16b",
                  "recurrentgemma-9b"]
