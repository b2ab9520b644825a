"""Feed-forward blocks (``repro.models.layers.mlp``): the plain MLP
``wo(act(wi x))`` (tanh-GELU, biased in the text encoder, bias-free in the
image transformers' ``Block``) and the gated one ``wo(act(wg x) * wi x)``
(SwiGLU with ``silu``: LLaMA), under the reference's keys ``wi``, ``wg``,
``wo``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import tracer
from repro_torch.models.layers.basic import Dense
from repro_torch.nn import Module
from repro_torch.parallel.sharding import constrain

_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
}


class MLP(Module):
    def __init__(self, d_model: int, d_ff: int, use_bias: bool = False, dtype=torch.float32, *,
                 activation: str = "gelu", gated: bool = False, name: str = "mlp"):
        super().__init__()
        self.act, self.gated, self.name = _ACTS[activation], gated, name
        self.wi = Dense(d_model, d_ff, use_bias, dtype, name="wi", axes=("embed", "mlp"))
        self.wo = Dense(d_ff, d_model, use_bias, dtype, name="wo", axes=("mlp", "embed"))
        if gated:
            self.wg = Dense(d_model, d_ff, use_bias, dtype, name="wg", axes=("embed", "mlp"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the hidden activation pinned batch-sharded x TP-sharded, as the reference
        spec = ("batch", None, "model") if x.ndim == 3 else (None,) * x.ndim
        h = constrain(self.wi(x), spec)
        h = self.act(constrain(self.wg(x), spec)) * h if self.gated else self.act(h)
        if tracer.active():
            tracer.record("pointwise", f"{self.name}_act", flops=4.0 * h.numel(),
                          bytes_hbm=tracer.nbytes((h.shape, h.dtype)) * 2)
        return self.wo(h)
