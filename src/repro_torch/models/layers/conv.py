"""Conv2D layer and the fused GroupNorm producer (``repro.models.layers.conv``).

``Conv2D`` dispatches through ``kernels.conv2d.ops.conv2d`` and exposes its
fused epilogues (bias / time-embedding add / SiLU / residual add), the fused
GroupNorm(+SiLU) producer and next-GroupNorm stats emission.  Layout NHWC,
kernel HWIO.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.nn import Module, scaled_init, zeros_init


def fused_gn_producer(x: torch.Tensor, gn: Module, *, groups: int):
    """Collapse a GroupNorm(+SiLU) that feeds a conv into the per-(batch,
    channel) affine the fused kernel applies to its input (one statistics
    read over ``x``; the normalised tensor is never written)."""
    return conv_ops.groupnorm_affine(x, gn.scale, gn.bias, groups=groups)


class Conv2D(Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.stride = stride
        self.param("kernel", (kernel, kernel, in_ch, out_ch), scaled_init((0, 1, 2)), dtype)
        self.param("bias", (out_ch,), zeros_init, dtype)

    def forward(self, x: torch.Tensor, *, impl: str = "auto", gn_affine: tuple | None = None,
                gn_silu: bool = True, temb: torch.Tensor | None = None, silu: bool = False,
                residual: torch.Tensor | None = None, emit_stats: bool = False):
        """x (B, H, W, C_in) -> y (B, OH, OW, C_out), or (y, stats)."""
        return conv_ops.conv2d(
            x, self.kernel.to(x.dtype), stride=self.stride, bias=self.bias, gn_affine=gn_affine,
            gn_silu=gn_silu, temb=temb, silu=silu, residual=residual,
            emit_stats=emit_stats, impl=impl)
