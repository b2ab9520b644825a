"""LayerNorm and GroupNorm over channels-last tensors (``repro.models.layers.norms``).

``GroupNorm`` dispatches through ``kernels.groupnorm_silu.ops`` with the
call site's tier: the CUDA kernel on the ``kernel`` tier, the composite
version on ``torch``.  (The reference's GroupNorm picks its tier from its
own ``impl`` field, which callers never set; the function is the same.)
"""

from __future__ import annotations

import torch

from repro_torch.kernels.groupnorm_silu import ops as gn_ops
from repro_torch.nn import Module, ones_init, zeros_init


class LayerNorm(Module):
    eps = 1e-5

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.param("scale", (dim,), ones_init, dtype)
        self.param("bias", (dim,), zeros_init, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.scale.float() + self.bias.float()
        return y.to(x.dtype)


class GroupNorm(Module):
    """GroupNorm over (B, ..., C), optional fused SiLU."""

    eps = 1e-5

    def __init__(self, channels: int, groups: int = 32, fuse_silu: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.groups, self.fuse_silu = groups, fuse_silu
        self.param("scale", (channels,), ones_init, dtype)
        self.param("bias", (channels,), zeros_init, dtype)

    def forward(self, x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        return gn_ops.groupnorm_silu(x, self.scale, self.bias, groups=self.groups,
                                     eps=self.eps, silu=self.fuse_silu, impl=impl)
