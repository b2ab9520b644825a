"""Dispatcher of the fused Conv2D, mirroring ``repro.kernels.conv2d.ops``.

``conv2d(...)`` is the call-site API of every conv layer.  Tiers
(``repro_torch.kernels.tiers``): ``kernel`` runs the CUDA kernel (its plain
version for a CPU tensor), ``torch`` the composite ``ref.conv2d_ref``.

``temporal_conv1d(...)`` is the call-site API of the temporal conv layers:
the ``kernel`` tier runs the temporal CUDA kernel on the (B, F, H*W, C)
view of the video tensor, tiled in place; the ``torch`` tier the
conventional permute -> conv1d -> permute of ``ref.temporal_conv1d_ref``.

``groupnorm_affine`` and ``affine_from_stats`` collapse a GroupNorm that
feeds a conv into the per-(batch, channel) affine the fused kernel applies
to its input; they are plain PyTorch outside any kernel, as in the
reference.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.conv2d import conv2d as _kernel
from repro_torch.kernels.conv2d import ref as _ref
from repro_torch.kernels.tiers import is_fused, resolve_model_impl

__all__ = ["affine_from_stats", "conv2d", "groupnorm_affine", "is_fused",
           "resolve_model_impl", "temporal_conv1d"]


def _affine_from_moments(mean, var, scale, bias, *, cpg: int, eps: float):
    """(mean, var) per (batch, group) -> (a, b) per (batch, channel) with
    GroupNorm(x)[..., c] == x * a + b."""
    rstd = torch.rsqrt(var + eps)
    sc = scale.float()[None]
    a = rstd.repeat_interleave(cpg, dim=1) * sc
    b = bias.float()[None] - (mean * rstd).repeat_interleave(cpg, dim=1) * sc
    return a, b  # each (B, C) fp32


def groupnorm_affine(x, scale, bias, *, groups: int, eps: float = 1e-5):
    """One statistics pass over ``x`` (B, ..., C), one-pass variance."""
    B, C = x.shape[0], x.shape[-1]
    cpg = C // groups
    xf = x.float().reshape(B, -1, groups, cpg)
    mean = xf.mean(dim=(1, 3))
    var = (xf * xf).mean(dim=(1, 3)) - mean * mean
    return _affine_from_moments(mean, var, scale, bias, cpg=cpg, eps=eps)


def affine_from_stats(stats, scale, bias, *, groups: int, count: int, eps: float = 1e-5):
    """The same affine from the (B, 2, C) channel sums a fused conv emitted;
    ``count`` is the number of pixels summed per channel."""
    B, _, C = stats.shape
    cpg = C // groups
    n = count * cpg
    mean = stats[:, 0].reshape(B, groups, cpg).sum(-1) / n
    var = stats[:, 1].reshape(B, groups, cpg).sum(-1) / n - mean * mean
    return _affine_from_moments(mean, var, scale, bias, cpg=cpg, eps=eps)


def conv2d(
    x: torch.Tensor,  # (B, H, W, C_in)
    w: torch.Tensor,  # (K, K, C_in, C_out)
    *,
    stride: int = 1,
    bias: torch.Tensor | None = None,
    gn_affine: tuple | None = None,  # (a, b) each (B, C_in)
    gn_silu: bool = True,
    temb: torch.Tensor | None = None,  # (B, C_out)
    silu: bool = False,
    residual: torch.Tensor | None = None,
    emit_stats: bool = False,
    impl: str = "auto",
):
    """Fused NHWC Conv2D: ``y`` or ``(y, stats)`` when ``emit_stats``."""
    gn_a, gn_b = gn_affine if gn_affine is not None else (None, None)
    fn = _kernel.conv2d if resolve_model_impl(impl) == "kernel" else _ref.conv2d_ref
    return fn(x, w, stride=stride, gn_a=gn_a, gn_b=gn_b, gn_silu=gn_silu, bias=bias,
              temb=temb, silu=silu, residual=residual, emit_stats=emit_stats)


def temporal_conv1d(
    x: torch.Tensor,  # (B, F, H, W, C): conv over the frame axis
    w: torch.Tensor,  # (K, C, C_out)
    bias: torch.Tensor,  # (C_out,)
    *,
    impl: str = "auto",
) -> torch.Tensor:
    if resolve_model_impl(impl) == "kernel":
        B, F, H, W, C = x.shape
        y = _kernel.temporal_conv1d(x.reshape(B, F, H * W, C), w, bias)
        return y.reshape(B, F, H, W, w.shape[-1])
    return _ref.temporal_conv1d_ref(x, w, bias)
