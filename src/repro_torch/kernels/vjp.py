"""Gradients of the kernel tier.

The reference has no backward kernel: its fused conv and temporal conv are
``custom_vjp``s whose backward is the plain function's VJP, and its
attention, temporal attention and GroupNorm kernels are differentiated
through their plain tiers.  The port's kernel-tier
``torch.autograd.Function``s (``conv2d.ops.Conv2dFn`` and
``TemporalConv1dFn``, ``flash_attention.ops.FlashAttentionFn`` and
``TemporalAttentionFn``, ``groupnorm_silu.ops.GroupNormSiLUFn``) launch the
hand-written kernel forward and pull the cotangents back through the plain
version here.
"""

from __future__ import annotations

import torch


def plain_vjp(fn, ops: tuple, cotangents: tuple, needs: tuple) -> tuple:
    """The gradients of ``fn(*ops)`` for the operands flagged in ``needs``
    (None elsewhere), recomputed through ``fn`` under autograd and pulled
    back from ``cotangents``, one for each of its outputs."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) if t is not None else None
                  for t, n in zip(ops, needs)]
        out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    wrt = [t for t, n in zip(leaves, needs) if n and t is not None]
    grads = iter(torch.autograd.grad(outs, wrt, cotangents, allow_unused=True))
    return tuple(next(grads) if n and t is not None else None for t, n in zip(leaves, needs))


def needs_grad(*ts) -> bool:
    """Whether autograd records a call on these operands."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)
