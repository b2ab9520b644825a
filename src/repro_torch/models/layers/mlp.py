"""Feed-forward block (``repro.models.layers.mlp``): the non-gated, biased
tanh-GELU MLP of the text encoder.  Gated and bias-free variants come with
the LM slice."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers.basic import Dense
from repro_torch.nn import Module


class MLP(Module):
    def __init__(self, d_model: int, d_ff: int, dtype=torch.float32):
        super().__init__()
        self.wi = Dense(d_model, d_ff, True, dtype)
        self.wo = Dense(d_ff, d_model, True, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # jax.nn.gelu defaults to the tanh approximation
        return self.wo(F.gelu(self.wi(x), approximate="tanh"))
