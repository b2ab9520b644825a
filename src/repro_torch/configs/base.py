"""The LM config of the port (``repro.configs.base.LMConfig``), field for
field with torch dtypes, and its ``MoESpec``, ``SSMSpec`` and
``EncoderSpec``.

Every field of the reference is kept, so a config copies across unchanged.
The port builds every LM family of the reference: stacks of ``"dense"``,
``"moe"``, ``"mamba2"``, ``"rglru"`` and ``"local_attn"`` blocks with
RMSNorm, LayerNorm or the non-parametric LN, optional qk-norm, and an
untied or tied head; an encoder and cross-attention decoder (``encoder``,
whisper); M-RoPE and embedding inputs (``mrope_sections``,
``embed_inputs``, Qwen2-VL).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

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
class EncoderSpec:
    """The reference's ``repro.configs.base.EncoderSpec``: the encoder stack
    of an enc-dec model (whisper), as wide as the decoder.  The conv/log-mel
    frontend is a stub: inputs are precomputed frame embeddings of shape
    (B, enc_len(seq), d_model)."""

    n_layers: int
    enc_len: Callable[[int], int] = staticmethod(lambda s: s)


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
    encoder: EncoderSpec | None = None  # enc-dec (whisper)
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
    def homogeneous(self) -> bool:
        return len(set(self.block_types())) == 1

    @property
    def sub_quadratic(self) -> bool:
        """True if prefill cost is sub-quadratic in sequence length (SSM, or
        a hybrid whose attention is local-window)."""
        types = set(self.block_types())
        if types <= {"mamba2", "rglru"}:
            return True
        if "dense" in types or "moe" in types:
            return False
        return types <= {"mamba2", "rglru", "local_attn"} and self.window is not None

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    def supports_shape(self, shape: "ShapeSpec") -> bool:
        """False for a full-attention arch at a decode over 65536 positions
        (``long_500k``: the dry-run skips it, as the reference's)."""
        return not (shape.kind == "decode" and shape.seq_len > 65536 and not self.sub_quadratic)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        per_expert = 3 * self.d_model * m.d_ff_expert
        n_moe_layers = sum(1 for t in self.block_types() if t == "moe")
        return int(self.param_count() - n_moe_layers * per_expert * (m.n_experts - m.top_k))

    def param_count(self) -> int:
        """Analytic parameter count (embedding, blocks, head, and an
        encoder's layers and the decoder's cross-attention), as the
        reference's: projections and MLPs only, no bias or norm leaf."""
        d, V = self.d_model, self.vocab
        H, KVH, hd = self.n_heads, self.n_kv_heads, self.resolved_head_dim
        attn = d * (H + 2 * KVH) * hd + H * hd * d
        mlp = (3 if self.mlp_gated else 2) * d * self.d_ff
        total = V * d * (1 if self.tie_embeddings else 2)
        for t in self.block_types():
            if t in ("dense", "moe", "local_attn"):
                total += attn
            if t in ("dense", "local_attn"):
                total += mlp
            elif t == "moe":
                m = self.moe
                total += m.n_experts * 3 * d * m.d_ff_expert + d * m.n_experts
                if m.n_shared:
                    total += 3 * d * (m.d_ff_shared or m.n_shared * m.d_ff_expert)
            elif t == "mamba2":
                s = self.ssm
                di = s.expand * d
                total += d * (2 * di + 2 * s.d_state + di // s.head_dim) + di * d
            elif t == "rglru":  # d_rnn = d_model
                total += 3 * d * d + 2 * d * d + mlp
        if self.encoder is not None:
            total += self.encoder.n_layers * (attn + mlp) + self.n_layers * attn
        return int(total)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """The reference's ``repro.configs.base.ShapeSpec``: one input shape of
    the assigned set."""

    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}
