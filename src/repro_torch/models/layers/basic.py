"""Dense / Embedding primitives (``repro.models.layers.basic``)."""

from __future__ import annotations

import math

import torch

from repro_torch.nn import Module, normal_init, scaled_init, zeros_init


class Dense(Module):
    """y = x @ W (+ b), W stored ``(in, out)`` as in the reference."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.use_bias = use_bias
        self.param("kernel", (in_dim, out_dim), scaled_init((0,)), dtype)
        if use_bias:
            self.param("bias", (out_dim,), zeros_init, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.kernel.to(x.dtype))
        if self.use_bias:
            y = y + self.bias.to(x.dtype)
        return y


class Embedding(Module):
    def __init__(self, vocab: int, dim: int, dtype=torch.float32):
        super().__init__()
        self.param("table", (vocab, dim), normal_init(0.02), dtype)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.table[ids]


def sinusoidal_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Timestep / position sinusoidal features: t (...,) -> (..., dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb
