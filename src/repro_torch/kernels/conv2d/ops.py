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

Gradients: where autograd needs one (grad enabled and an operand that
requires it), the ``kernel`` tier runs the fused conv through
``Conv2dFn``, the counterpart of the reference's ``custom_vjp``
(``_conv2d_fused`` / ``_conv2d_bwd``): the forward launches the kernel, the
backward is the VJP of ``ref.conv2d_ref`` recomputed from the saved
operands, for every operand (``x``, ``w``, ``gn_a``, ``gn_b``, ``bias``,
``temb``, ``residual``) and from the cotangents of both outputs when
``emit_stats`` returns ``(y, stats)``.  The forward runs outside autograd,
as the CUDA kernel does, also on a CPU tensor (its plain version): a
gradient the backward failed to give is missing on the CPU too.  The
``torch`` tier is plain autograd through ``ref.conv2d_ref``.  The temporal
conv runs through ``TemporalConv1dFn`` there, the counterpart of the
reference's ``_tconv_fused`` / ``_tconv_bwd``: the temporal kernel forward
on the (B, F, H*W, C) view, and for ``x``, ``w`` and ``bias`` the VJP of
``ref.temporal_conv1d_ref`` recomputed from the saved operands.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.conv2d import conv2d as _kernel
from repro_torch.kernels.conv2d import ref as _ref
from repro_torch.kernels.tiers import is_fused, resolve_model_impl
from repro_torch.kernels.vjp import needs_grad, plain_vjp

__all__ = ["Conv2dFn", "TemporalConv1dFn", "affine_from_stats", "conv2d", "groupnorm_affine",
           "is_fused", "resolve_model_impl", "temporal_conv1d"]


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


def _call(fn, static: tuple, *ops):
    """``fn`` (the kernel's wrapper or ``ref.conv2d_ref``) on the operands
    (x, w, gn_a, gn_b, bias, temb, residual) and ``static`` (stride,
    gn_silu, silu, emit_stats)."""
    stride, gn_silu, silu, emit_stats = static
    x, w, gn_a, gn_b, bias, temb, residual = ops
    return fn(x, w, stride=stride, gn_a=gn_a, gn_b=gn_b, gn_silu=gn_silu, bias=bias,
              temb=temb, silu=silu, residual=residual, emit_stats=emit_stats)


class Conv2dFn(torch.autograd.Function):
    """The fused conv with its gradient: the kernel forward, the VJP of
    ``ref.conv2d_ref`` backward (``static``: stride, gn_silu, silu,
    emit_stats)."""

    @staticmethod
    def forward(ctx, static, *ops):
        ctx.static = static
        ctx.save_for_backward(*ops)
        return _call(_kernel.conv2d, static, *ops)

    @staticmethod
    def backward(ctx, *cotangents):
        return (None, *plain_vjp(lambda *o: _call(_ref.conv2d_ref, ctx.static, *o),
                                 ctx.saved_tensors, cotangents, ctx.needs_input_grad[1:]))


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
    ops = (x, w, gn_a, gn_b, bias, temb, residual)
    static = (stride, gn_silu, silu, emit_stats)
    if resolve_model_impl(impl) != "kernel":
        return _call(_ref.conv2d_ref, static, *ops)
    if needs_grad(*ops):
        return Conv2dFn.apply(static, *ops)
    return _call(_kernel.conv2d, static, *ops)


def _tconv_ref4(x4, w, bias):
    """``ref.temporal_conv1d_ref`` on the kernel's (B, F, N, C) layout."""
    B, F, N, C = x4.shape
    return _ref.temporal_conv1d_ref(x4.reshape(B, F, N, 1, C), w, bias).reshape(
        B, F, N, w.shape[-1])


class TemporalConv1dFn(torch.autograd.Function):
    """The temporal conv with its gradient: the kernel forward on (B, F, N,
    C), the VJP of ``ref.temporal_conv1d_ref`` backward."""

    @staticmethod
    def forward(ctx, x4, w, bias):
        ctx.save_for_backward(x4, w, bias)
        return _kernel.temporal_conv1d(x4, w, bias)

    @staticmethod
    def backward(ctx, g):
        return plain_vjp(_tconv_ref4, ctx.saved_tensors, (g,), ctx.needs_input_grad)


def temporal_conv1d(
    x: torch.Tensor,  # (B, F, H, W, C): conv over the frame axis
    w: torch.Tensor,  # (K, C, C_out)
    bias: torch.Tensor,  # (C_out,)
    *,
    impl: str = "auto",
) -> torch.Tensor:
    if resolve_model_impl(impl) != "kernel":
        return _ref.temporal_conv1d_ref(x, w, bias)
    B, F, H, W, C = x.shape
    x4 = x.reshape(B, F, H * W, C)
    if needs_grad(x4, w, bias):
        y = TemporalConv1dFn.apply(x4, w, bias)
    else:
        y = _kernel.temporal_conv1d(x4, w, bias)
    return y.reshape(B, F, H, W, w.shape[-1])
