"""The transformer ``Block`` of the parallel-decode image transformer
(``repro.models.transformer.Block`` with ``block_type="dense"``): non-causal,
optionally with cross-attention to a context.

The reference builds its blocks from an ``LMConfig``; the port takes the
fields a dense block reads (LayerNorm, bias-free non-gated tanh-GELU MLP,
``head_dim = d_model // n_heads``, no GQA).  The LM config, causal blocks and
decode with a KV cache come with Parti and the LM slice.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers.attention import Attention
from repro_torch.models.layers.mlp import MLP
from repro_torch.models.layers.norms import LayerNorm
from repro_torch.nn import Module


class Block(Module):
    """norm1 -> self-attention -> (norm_cross -> cross-attention) -> norm2 ->
    MLP, each with its residual, under the reference's keys ``norm1``,
    ``attn``, ``norm_cross``, ``cross_attn``, ``norm2``, ``mlp``."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, *, with_cross: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.with_cross = with_cross
        head_dim = d_model // n_heads
        self.norm1 = LayerNorm(d_model, dtype=dtype)
        self.attn = Attention(d_model, n_heads, head_dim, dtype=dtype)
        self.norm2 = LayerNorm(d_model, dtype=dtype)
        self.mlp = MLP(d_model, d_ff, dtype=dtype)
        if with_cross:
            self.cross_attn = Attention(d_model, n_heads, head_dim, cross=True, dtype=dtype)
            self.norm_cross = LayerNorm(d_model, dtype=dtype)

    def forward(self, x: torch.Tensor, *, context: torch.Tensor | None = None,
                impl: str = "auto") -> torch.Tensor:
        x = x + self.attn(self.norm1(x), impl=impl)
        if self.with_cross:
            x = x + self.cross_attn(self.norm_cross(x), context=context, impl=impl)
        return x + self.mlp(self.norm2(x))
