"""LayerNorm, RMSNorm and GroupNorm over channels-last tensors
(``repro.models.layers.norms``).

``GroupNorm`` dispatches through ``kernels.groupnorm_silu.ops`` with the
call site's tier: the CUDA kernel on the ``kernel`` tier, the composite
version on ``torch``.  (The reference's GroupNorm picks its tier from its
own ``impl`` field, which callers never set; the function is the same.)
Its tracer event is therefore always the reference's fused one, whatever
tier the call site passes.
"""

from __future__ import annotations

import torch

from repro_torch.core import tracer
from repro_torch.kernels.groupnorm_silu import ops as gn_ops
from repro_torch.nn import Module, ones_init, zeros_init


def _record_norm(name: str, x: torch.Tensor, fused: bool, n_params: int):
    if not tracer.active():
        return
    n = tracer.numel(x.shape)
    elem = tracer.dtype_bytes(x.dtype)
    # unfused: ~3 HBM round trips (stats, normalize, activation); fused: one
    # read and one write
    traffic = (2 if fused else 6) * n * elem + n_params * elem
    tracer.record("norm", name, flops=8.0 * n, bytes_hbm=traffic)


class LayerNorm(Module):
    """LayerNorm over the last axis; ``with_scale=False, with_bias=False`` is
    OLMo's non-parametric LN, with no leaves.  Its event counts the bytes of
    a scale and a bias either way, as the reference's does."""

    eps = 1e-5

    def __init__(self, dim: int, dtype=torch.float32, name: str = "layernorm", *,
                 with_scale: bool = True, with_bias: bool = True):
        super().__init__()
        self.dim, self.name = dim, name
        self.with_scale, self.with_bias = with_scale, with_bias
        if with_scale:
            self.param("scale", (dim,), ones_init, dtype)
        if with_bias:
            self.param("bias", (dim,), zeros_init, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.with_scale:
            y = y * self.scale.float()
        if self.with_bias:
            y = y + self.bias.float()
        _record_norm(self.name, x, fused=True, n_params=2 * self.dim)
        return y.to(x.dtype)


class RMSNorm(Module):
    """x * rsqrt(mean(x^2) + eps) * scale, the variance in fp32 (LLaMA)."""

    eps = 1e-6

    def __init__(self, dim: int, dtype=torch.float32, name: str = "rmsnorm"):
        super().__init__()
        self.dim, self.name = dim, name
        self.param("scale", (dim,), ones_init, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.eps)
        _record_norm(self.name, x, fused=True, n_params=self.dim)
        return (y * self.scale.float()).to(x.dtype)


class GroupNorm(Module):
    """GroupNorm over (B, ..., C), optional fused SiLU."""

    eps = 1e-5

    def __init__(self, channels: int, groups: int = 32, fuse_silu: bool = False,
                 dtype=torch.float32, name: str = "groupnorm"):
        super().__init__()
        self.channels, self.groups, self.fuse_silu, self.name = channels, groups, fuse_silu, name
        self.param("scale", (channels,), ones_init, dtype)
        self.param("bias", (channels,), zeros_init, dtype)

    def forward(self, x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        out = gn_ops.groupnorm_silu(x, self.scale, self.bias, groups=self.groups,
                                    eps=self.eps, silu=self.fuse_silu, impl=impl)
        _record_norm(self.name, x, fused=True, n_params=2 * self.channels)
        return out
