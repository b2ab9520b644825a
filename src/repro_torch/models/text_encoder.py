"""Text encoder (CLIP-style bidirectional transformer), the port of
``repro.models.text_encoder``: the first stage of every TTI pipeline.  Layer
``i`` runs under ``tracer.scope("text_enc_layer<i>")``, as the reference's."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import tracer
from repro_torch.models.layers.attention import Attention
from repro_torch.models.layers.basic import Embedding
from repro_torch.models.layers.mlp import MLP
from repro_torch.models.layers.norms import LayerNorm
from repro_torch.nn import Module, normal_init


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    vocab: int = 49408
    max_len: int = 77
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072
    dtype: Any = torch.float32


class _EncoderLayer(Module):
    def __init__(self, c: TextEncoderConfig):
        super().__init__()
        self.ln1 = LayerNorm(c.d_model, dtype=c.dtype, name="ln1")
        self.attn = Attention(c.d_model, c.n_heads, c.d_model // c.n_heads,
                              qkv_bias=True, out_bias=True, dtype=c.dtype)
        self.ln2 = LayerNorm(c.d_model, dtype=c.dtype, name="ln2")
        self.mlp = MLP(c.d_model, c.d_ff, use_bias=True, dtype=c.dtype)

    def forward(self, x, *, impl="auto"):
        x = x + self.attn(self.ln1(x), impl=impl)
        return x + self.mlp(self.ln2(x))


class TextEncoder(Module):
    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab, cfg.d_model, cfg.dtype)
        self.param("pos", (cfg.max_len, cfg.d_model), normal_init(0.01), cfg.dtype,
                   axes=(None, "embed"))
        self.final_ln = LayerNorm(cfg.d_model, dtype=cfg.dtype, name="final_ln")
        for i in range(cfg.n_layers):
            self.add_module(f"layer{i}", _EncoderLayer(cfg))

    def forward(self, tokens, *, impl="auto"):
        S = tokens.shape[1]
        x = self.embed(tokens)
        x = x + self.pos[:S].to(x.dtype)[None]
        for i in range(self.cfg.n_layers):
            with tracer.scope(f"text_enc_layer{i}"):
                x = getattr(self, f"layer{i}")(x, impl=impl)
        return self.final_ln(x)
