"""Dispatcher of fused GroupNorm + SiLU, mirroring ``repro.kernels.groupnorm_silu.ops``.

Gradients: where autograd needs one, the ``kernel`` tier runs through
``GroupNormSiLUFn``: the kernel forward, and for x, scale and bias the VJP
of ``ref.groupnorm_silu_onepass_ref``, the kernel's own one-pass variance
``E[x^2] - mean^2`` (the ``torch`` tier keeps the reference's two-pass
``ref.groupnorm_silu_ref``).  The reference's Pallas kernel has no VJP and
is differentiated through its ``jax`` tier.

On a mesh (DTensor operands) it runs on local shards through the boundary
of ``kernels.shards``: the batch over the batch axes, the channels where
they are sharded if each shard holds whole groups.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import shards
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
    if shards.on_mesh(x3, scale, bias):
        return _groupnorm_on_mesh(x3, scale, bias, groups=groups, eps=eps, silu=silu,
                                  impl=impl).reshape(shape)
    if resolve_model_impl(impl) != "kernel":
        out = _ref.groupnorm_silu_ref(x3, scale, bias, groups=groups, eps=eps, silu=silu)
    elif needs_grad(x3, scale, bias):
        out = GroupNormSiLUFn.apply((groups, eps, silu), x3, scale, bias)
    else:
        out = _kernel.groupnorm_silu(x3, scale, bias, groups=groups, eps=eps, silu=silu)
    return out.reshape(shape)


def _groupnorm_on_mesh(x3, scale, bias, *, groups: int, impl: str, **kw):
    """``groupnorm_silu`` on DTensors, (B, N, C): the batch on the batch axes;
    the channels stay sharded where they are (conv-channel TP) only if every
    rank then holds whole groups, else they are gathered first."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = shards.mesh_of(x3, scale, bias)
    B, N, C = x3.shape
    tp = shards.sharded_dims(x3, 2) if shards.on_mesh(x3) else ()
    n_tp = 1
    for i in tp:
        n_tp *= int(mesh.shape[i])
    if groups % n_tp:
        tp, n_tp = (), 1
    pl = shards.pinned((B,), ("batch",), mesh)
    c_pl = [Replicate()] * mesh.ndim
    for i in tp:
        pl[i], c_pl[i] = Shard(2), Shard(0)
    pl, c_pl = tuple(pl), tuple(c_pl)
    xl, sl, bl = (shards.local(shards.as_placed(t, mesh, p), pl)
                  for t, p in zip((x3, scale, bias), (pl, c_pl, c_pl)))
    out = groupnorm_silu(xl, sl, bl, groups=groups // n_tp, impl=impl, **kw)
    return shards.wrap(out, mesh, pl, (B, N, C))
