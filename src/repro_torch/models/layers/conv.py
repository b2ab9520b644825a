"""Conv layers and the fused GroupNorm producer (``repro.models.layers.conv``).

``Conv2D`` dispatches through ``kernels.conv2d.ops.conv2d`` and exposes its
fused epilogues (bias / time-embedding add / SiLU / residual add), the fused
GroupNorm(+SiLU) producer and next-GroupNorm stats emission.  Layout NHWC,
kernel HWIO.  ``TemporalConv1D`` convolves over the frame axis of
(B, F, H, W, C) video tensors through ``kernels.conv2d.ops.temporal_conv1d``.
``CausalDepthwiseConv1D`` is the short causal conv of the SSM and RG-LRU
blocks over (B, S, C): ``width`` shifted multiply-adds, as the reference's
``lax.conv_general_dilated`` with ``feature_group_count=C`` (no Pallas
kernel there, none here).

Every conv records the reference's event (``_record_conv``): the fused
tiers (the reference's ``pallas``/``interpret``, the port's ``kernel``)
apply the epilogues while a tile is on chip; each unfused epilogue stage
costs one more round trip of the output, an unfused GroupNorm producer a
normalize pass over the input.
"""

from __future__ import annotations

import torch

from repro_torch.core import tracer
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.tiers import conv_event_impl
from repro_torch.nn import Module, scaled_init, zeros_init


def _record_conv(name, x, y, w_shape, *, impl, groups=1, has_bias=True, gn=False, temb=False,
                 silu=False, residual=False, emit_stats=False, extra_bytes=0.0,
                 bw_efficiency=None):
    """Conv operator event with the fused-vs-unfused HBM traffic; ``impl``
    is the reference's conv tier name (``tiers.conv_event_impl``); a
    grouped conv does ``1 / groups`` of the dense conv's FLOPs."""
    if not tracer.active():
        return
    B = x.shape[0]
    out_spatial = tracer.numel(y.shape[1:-1])
    cout = w_shape[-1]
    flops = 2.0 * B * out_spatial * cout * tracer.numel(w_shape[:-1]) / max(groups, 1)
    elem = tracer.dtype_bytes(x.dtype)
    n_x = tracer.numel(x.shape) * elem
    n_y = tracer.numel(y.shape) * elem
    fused = impl in ("pallas", "interpret")
    traffic = n_x + n_y + tracer.numel(w_shape) * elem + extra_bytes
    if has_bias:
        traffic += cout * elem
    if gn:
        traffic += 2 * B * x.shape[-1] * 4  # per-(batch, channel) affine
    if temb:
        traffic += B * cout * elem
    if residual:
        traffic += n_y  # the residual operand's read
    if emit_stats:
        traffic += B * 2 * cout * 4
    if not fused:
        traffic += 2 * n_y * sum((temb, silu, residual))
        if gn:
            traffic += 2 * n_x  # the materialized normalize pass over the input
    meta = dict(impl=impl, fused=fused)
    if bw_efficiency is not None:
        meta["bw_efficiency"] = bw_efficiency
    tracer.record("conv", name, flops=flops, bytes_hbm=traffic, **meta)


def fused_gn_producer(x: torch.Tensor, gn: Module, *, groups: int, name: str = "gn_stats"):
    """Collapse a GroupNorm(+SiLU) that feeds a conv into the per-(batch,
    channel) affine the fused kernel applies to its input (one statistics
    read over ``x``, recorded as a one-pass norm event; the normalised
    tensor is never written)."""
    a, b = conv_ops.groupnorm_affine(x, gn.scale, gn.bias, groups=groups)
    if tracer.active():
        n = tracer.numel(x.shape) * tracer.dtype_bytes(x.dtype)
        tracer.record("norm", name, flops=4.0 * tracer.numel(x.shape),
                      bytes_hbm=n + 2 * x.shape[0] * x.shape[-1] * 4)
    return a, b


class Conv2D(Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 dtype=torch.float32, name: str = "conv"):
        super().__init__()
        self.stride, self.name = stride, name
        self.param("kernel", (kernel, kernel, in_ch, out_ch), scaled_init((0, 1, 2)), dtype)
        self.param("bias", (out_ch,), zeros_init, dtype)

    def forward(self, x: torch.Tensor, *, impl: str = "auto", gn_affine: tuple | None = None,
                gn_silu: bool = True, temb: torch.Tensor | None = None, silu: bool = False,
                residual: torch.Tensor | None = None, emit_stats: bool = False):
        """x (B, H, W, C_in) -> y (B, OH, OW, C_out), or (y, stats)."""
        w = self.kernel.to(x.dtype)
        out = conv_ops.conv2d(
            x, w, stride=self.stride, bias=self.bias, gn_affine=gn_affine,
            gn_silu=gn_silu, temb=temb, silu=silu, residual=residual,
            emit_stats=emit_stats, impl=impl)
        _record_conv(self.name, x, out[0] if emit_stats else out, w.shape,
                     impl=conv_event_impl(impl), gn=gn_affine is not None,
                     temb=temb is not None, silu=silu, residual=residual is not None,
                     emit_stats=emit_stats)
        return out


class TemporalConv1D(Module):
    """Conv over the frame axis of (B, F, H, W, C) video tensors, the
    temporal convolutions TTV models interleave with temporal attention;
    kernel (K, C, C), zero-padded to keep F.  The ``kernel`` tier tiles the
    tensor in place; the unfused tiers permute it twice, which the event
    counts (4 more passes over it, at half the bandwidth: strided access)."""

    def __init__(self, channels: int, kernel: int = 3, dtype=torch.float32, name: str = "tconv"):
        super().__init__()
        self.taps, self.name = kernel, name
        self.param("kernel", (kernel, channels, channels), scaled_init((0, 1)), dtype)
        self.param("bias", (channels,), zeros_init, dtype)

    def forward(self, x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        y = conv_ops.temporal_conv1d(x, self.kernel.to(x.dtype), self.bias, impl=impl)
        name = conv_event_impl(impl)
        fused = name in ("pallas", "interpret")
        C = x.shape[-1]
        _record_conv(self.name, x, y, (self.taps, 1, C, C), impl=name,
                     extra_bytes=0.0 if fused else 4 * tracer.numel(x.shape)
                     * tracer.dtype_bytes(x.dtype),
                     bw_efficiency=1.0 if fused else 0.5)
        return y


class CausalDepthwiseConv1D(Module):
    """Short causal depthwise conv over the sequence axis (Mamba, Griffin):
    kernel (W, C) and bias (C,); output row s sums input rows s-W+1..s
    (zeros before the start), each channel on its own.  ``step`` runs one
    token against the (B, W-1, C) window of the previous raw inputs."""

    def __init__(self, channels: int, width: int = 4, dtype=torch.float32,
                 name: str = "conv1d"):
        super().__init__()
        self.channels, self.width, self.name = channels, width, name
        self.param("kernel", (width, channels), scaled_init((0,)), dtype)
        self.param("bias", (channels,), zeros_init, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, S, C) -> (B, S, C)."""
        w = self.kernel.to(x.dtype)
        S, W = x.shape[1], self.width
        xp = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
        y = xp[:, :S] * w[0]
        for j in range(1, W):
            y = y + xp[:, j:j + S] * w[j]
        y = y + self.bias.to(x.dtype)
        _record_conv(self.name, x, y, (W, 1, 1, self.channels), impl="xla",
                     groups=self.channels)
        return y

    def step(self, x_new: torch.Tensor, conv_state: torch.Tensor):
        """x_new (B, C), conv_state (B, W-1, C) -> (y (B, C), the next window)."""
        window = torch.cat([conv_state, x_new[:, None, :]], dim=1)  # (B, W, C)
        y = (window * self.kernel.to(x_new.dtype)).sum(dim=1) + self.bias.to(x_new.dtype)
        return y, window[:, 1:]
