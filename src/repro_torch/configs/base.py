"""The LM config of the port (``repro.configs.base.LMConfig``), field for
field with torch dtypes, and its ``MoESpec`` and ``SSMSpec``.

Every field of the reference is kept, so a config copies across unchanged.
The port builds decoder-only stacks of ``"dense"``, ``"moe"``, ``"mamba2"``,
``"rglru"`` and ``"local_attn"`` blocks (LLaMA, the dense, MoE, SSM and
hybrid assigned LMs, and the image transformers' blocks), with RMSNorm,
LayerNorm or the non-parametric LN, optional qk-norm, and an untied or tied
head.  ``encoder``, ``mrope_sections`` and ``embed_inputs`` describe the
enc-dec and VLM families: a model that needs an encoder, M-RoPE or
embedding inputs raises ``NotImplementedError`` where it is built
(:func:`check_ported`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """The reference's ``repro.configs.base.MoESpec``, field for field."""

    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    first_k_dense: int = 0  # leading dense (non-MoE) layers (DeepSeekMoE: 1)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    """The reference's ``repro.configs.base.SSMSpec``, field for field."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric_ln
    mlp_activation: str = "silu"
    mlp_gated: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_base: float = 10000.0
    rope_pct: float = 1.0  # partial rotary (StableLM)
    mrope_sections: tuple | None = None  # Qwen2-VL
    tie_embeddings: bool = False
    window: int | None = None  # local attention window (hybrid archs)
    # per-layer block pattern, cycled to n_layers:
    # "dense" | "moe" | "mamba2" | "rglru" | "local_attn"
    block_pattern: tuple = ("dense",)
    moe: MoESpec | None = None
    ssm: SSMSpec | None = None
    encoder: Any = None  # EncoderSpec (enc-dec, whisper)
    embed_inputs: bool = False  # inputs are embeddings (vlm stub frontend)
    dtype: Any = torch.float32
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def block_types(self) -> tuple:
        """Expanded per-layer block types of length n_layers."""
        pattern = self.block_pattern
        types = [pattern[i % len(pattern)] for i in range(self.n_layers)]
        if self.moe is not None and self.moe.first_k_dense:
            for i in range(self.moe.first_k_dense):
                types[i] = "dense"
        return tuple(types)

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None


PORTED_BLOCKS = ("dense", "moe", "mamba2", "rglru", "local_attn")


def check_ported(cfg: LMConfig) -> None:
    """Raise unless ``cfg`` is a decoder-only stack of blocks the port
    builds (:data:`PORTED_BLOCKS`)."""
    missing = sorted({t for t in cfg.block_types() if t not in PORTED_BLOCKS})
    for field, what in (("encoder", "enc-dec"), ("mrope_sections", "M-RoPE (VLM)"),
                        ("embed_inputs", "embedding inputs (VLM)")):
        if getattr(cfg, field):
            missing.append(what)
    if cfg.norm not in ("rmsnorm", "layernorm", "nonparametric_ln"):
        missing.append(f"norm {cfg.norm!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet; the port builds dense, MoE, "
            "SSM and hybrid decoder-only stacks, and the other LM families come with their "
            "own slice")
