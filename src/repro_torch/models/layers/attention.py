"""Multi-head attention layer (``repro.models.layers.attention.Attention``):
non-causal self-attention and cross-attention to a context, as the UNet, the
text encoders and the parallel-decode transformers (Muse, Phenaki) use it.

The reference builds the attention of Muse's transformer ``Block`` with
``rope=True``, but ``ARImageModel.backbone`` passes ``positions=None``, so
its RoPE is a no-op and this layer has none.  Causal/windowed masks, GQA,
RoPE, qk-norm and decode with a KV cache come with Parti and the LM slice
(the kernel already takes the masks and GQA)."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.models.layers.basic import Dense
from repro_torch.nn import Module


class Attention(Module):
    def __init__(self, d_model: int, n_heads: int, head_dim: int, *, qkv_bias: bool = False,
                 out_bias: bool = False, cross: bool = False, dtype=torch.float32):
        super().__init__()
        self.n_heads, self.head_dim, self.cross = n_heads, head_dim, cross
        self.wq = Dense(d_model, n_heads * head_dim, qkv_bias, dtype)
        self.wk = Dense(d_model, n_heads * head_dim, qkv_bias, dtype)
        self.wv = Dense(d_model, n_heads * head_dim, qkv_bias, dtype)
        self.wo = Dense(n_heads * head_dim, d_model, out_bias, dtype)

    def forward(self, x: torch.Tensor, *, context: torch.Tensor | None = None,
                impl: str = "auto") -> torch.Tensor:
        B, S, _ = x.shape
        kv_src = context if self.cross else x
        heads = lambda t: t.reshape(B, t.shape[1], self.n_heads, self.head_dim)  # noqa: E731
        out = attn_ops.attention(heads(self.wq(x)), heads(self.wk(kv_src)),
                                 heads(self.wv(kv_src)), impl=impl)
        return self.wo(out.reshape(B, S, self.n_heads * self.head_dim))
