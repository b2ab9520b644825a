"""Dispatcher of fused GroupNorm + SiLU, mirroring ``repro.kernels.groupnorm_silu.ops``.

Gradients: where autograd needs one, the ``kernel`` tier runs through
``GroupNormSiLUFn``: the kernel forward, and for x, scale and bias the VJP
of ``ref.groupnorm_silu_onepass_ref``, the kernel's own one-pass variance
``E[x^2] - mean^2`` (the ``torch`` tier keeps the reference's two-pass
``ref.groupnorm_silu_ref``).  The reference's Pallas kernel has no VJP and
is differentiated through its ``jax`` tier.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.groupnorm_silu import groupnorm_silu as _kernel
from repro_torch.kernels.groupnorm_silu import ref as _ref
from repro_torch.kernels.tiers import resolve_model_impl
from repro_torch.kernels.vjp import needs_grad, plain_vjp


class GroupNormSiLUFn(torch.autograd.Function):
    """GroupNorm(+SiLU) of (B, N, C) with its gradient (``static``: groups,
    eps, silu)."""

    @staticmethod
    def forward(ctx, static, x, scale, bias):
        ctx.static = static
        ctx.save_for_backward(x, scale, bias)
        groups, eps, silu = static
        return _kernel.groupnorm_silu(x, scale, bias, groups=groups, eps=eps, silu=silu)

    @staticmethod
    def backward(ctx, g):
        groups, eps, silu = ctx.static
        return (None, *plain_vjp(
            lambda x, scale, bias: _ref.groupnorm_silu_onepass_ref(
                x, scale, bias, groups=groups, eps=eps, silu=silu),
            ctx.saved_tensors, (g,), ctx.needs_input_grad[1:]))


def groupnorm_silu(
    x: torch.Tensor,  # (B, N, C) or (B, H, W, C)
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    groups: int,
    eps: float = 1e-5,
    silu: bool = True,
    impl: str = "auto",
) -> torch.Tensor:
    shape = x.shape
    x3 = x.reshape(shape[0], -1, shape[-1])
    if resolve_model_impl(impl) != "kernel":
        out = _ref.groupnorm_silu_ref(x3, scale, bias, groups=groups, eps=eps, silu=silu)
    elif needs_grad(x3, scale, bias):
        out = GroupNormSiLUFn.apply((groups, eps, silu), x3, scale, bias)
    else:
        out = _kernel.groupnorm_silu(x3, scale, bias, groups=groups, eps=eps, silu=silu)
    return out.reshape(shape)
