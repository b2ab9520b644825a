"""Dense / Embedding primitives (``repro.models.layers.basic``), each
recording its tracer event under the reference's ``name``."""

from __future__ import annotations

import math

import torch

from repro_torch.core import tracer
from repro_torch.nn import Module, normal_init, scaled_init, zeros_init


class Dense(Module):
    """y = x @ W (+ b), W stored ``(in, out)`` as in the reference."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = False,
                 dtype=torch.float32, name: str = "dense"):
        super().__init__()
        self.in_dim, self.out_dim, self.use_bias, self.name = in_dim, out_dim, use_bias, name
        self.param("kernel", (in_dim, out_dim), scaled_init((0,)), dtype)
        if use_bias:
            self.param("bias", (out_dim,), zeros_init, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.kernel.to(x.dtype))
        if self.use_bias:
            y = y + self.bias.to(x.dtype)
        if tracer.active():
            tracer.record(
                "linear", self.name,
                flops=2.0 * tracer.numel(x.shape[:-1]) * self.in_dim * self.out_dim,
                bytes_hbm=tracer.nbytes((x.shape, x.dtype), (y.shape, y.dtype),
                                        ((self.in_dim, self.out_dim), x.dtype)))
        return y


class Embedding(Module):
    """Token embedding, with the tied logits head (:meth:`attend`)."""

    def __init__(self, vocab: int, dim: int, dtype=torch.float32, name: str = "embed"):
        super().__init__()
        self.name = name
        self.param("table", (vocab, dim), normal_init(0.02), dtype)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = self.table[ids]
        if tracer.active():
            tracer.record("embed", self.name, flops=0.0,
                          bytes_hbm=tracer.nbytes((out.shape, out.dtype))
                          + tracer.numel(ids.shape) * 4)
        return out

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Logits through the transposed table (the tied head), in ``x``'s
        dtype: x (..., dim) -> (..., vocab)."""
        table = self.table.to(x.dtype)
        y = torch.matmul(x, table.T)
        if tracer.active():
            vocab, dim = table.shape
            tracer.record(
                "linear", f"{self.name}_logits",
                flops=2.0 * tracer.numel(x.shape[:-1]) * dim * vocab,
                bytes_hbm=tracer.nbytes((x.shape, x.dtype), (y.shape, y.dtype),
                                        ((vocab, dim), x.dtype)))
        return y


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
