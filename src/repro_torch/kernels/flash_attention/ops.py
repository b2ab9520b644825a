"""Dispatcher of attention, mirroring ``repro.kernels.flash_attention.ops``.

``attention(...)`` is the call-site API of every attention layer.  Tiers
(``repro_torch.kernels.tiers``): ``kernel`` runs the CUDA flash-attention
kernel (its plain version for a CPU tensor), ``torch`` the composite
``ref.attention_ref``.

Shapes: q (B, Sq, H, D); k/v (B, Skv, KVH, D); out (B, Sq, H, D).

``decode_attention(...)`` attends one new query token to a KV cache (the
paper's Table III Decode regime).  The reference computes it in plain
``jnp`` outside any Pallas kernel, so it is plain PyTorch on every tier
here: no kernel replaces it.

``temporal_attention(...)`` attends across frames of (B, F, HW, H, D)
operands: the ``kernel`` tier runs the temporal CUDA kernel in that layout,
the ``torch`` tier the conventional permute to (B*HW, F, H, D), attention
and permute back (``ref.temporal_attention_ref``), as the reference's
``ops.temporal_attention``.  The kernel masks its ragged spatial tail
itself, so the TPU dispatcher's padding of HW has no counterpart.

Gradients: where autograd needs one, the ``kernel`` tier of ``attention``
runs through ``FlashAttentionFn``: the kernel forward, and for q, k and v
the VJP of ``ref.attention_ref`` recomputed from the saved inputs (GQA,
``causal``, ``window`` and ``kv_offset`` included).  The reference's
Pallas kernel has no VJP; it is differentiated through its plain tiers, so
the port's gradient is the function's, as there.  The forward runs outside
autograd on every device (``kernels.vjp``).  ``temporal_attention``'s
kernel tier runs through ``TemporalAttentionFn`` there: the temporal kernel
forward, and for q, k and v the VJP of ``ref.temporal_attention_ref``, the
permute path the reference trains through (its temporal kernel has no VJP
either).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention as _kernel
from repro_torch.kernels.flash_attention import ref as _ref
from repro_torch.kernels.tiers import resolve_model_impl
from repro_torch.kernels.vjp import needs_grad, plain_vjp


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its gradient (``static``: causal, window,
    scale, kv_offset): the kernel forward, the VJP of
    ``ref.attention_ref`` backward."""

    @staticmethod
    def forward(ctx, static, q, k, v):
        ctx.static = static
        ctx.save_for_backward(q, k, v)
        causal, window, scale, kv_offset = static
        return _kernel.flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                                       kv_offset=kv_offset)

    @staticmethod
    def backward(ctx, g):
        causal, window, scale, kv_offset = ctx.static
        return (None, *plain_vjp(
            lambda q, k, v: _ref.attention_ref(q, k, v, causal=causal, window=window,
                                               scale=scale, kv_offset=kv_offset),
            ctx.saved_tensors, (g,), ctx.needs_input_grad[1:]))


class TemporalAttentionFn(torch.autograd.Function):
    """Temporal attention with its gradient: the kernel forward on the
    (B, F, HW, H, D) operands, the VJP of ``ref.temporal_attention_ref``
    backward."""

    @staticmethod
    def forward(ctx, scale, q, k, v):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        return _kernel.temporal_flash_attention(q, k, v, scale=scale)

    @staticmethod
    def backward(ctx, g):
        return (None, *plain_vjp(
            lambda q, k, v: _ref.temporal_attention_ref(q, k, v, scale=ctx.scale),
            ctx.saved_tensors, (g,), ctx.needs_input_grad[1:]))


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: int | None = None,
    scale: float | None = None,
    kv_offset: int = 0,
    impl: str = "auto",
) -> torch.Tensor:
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if resolve_model_impl(impl) != "kernel":
        return _ref.attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                                  kv_offset=kv_offset)
    if needs_grad(q, k, v):
        return FlashAttentionFn.apply((causal, window, scale, kv_offset), q, k, v)
    return _kernel.flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                                   kv_offset=kv_offset)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S, KVH, D)
    v_cache: torch.Tensor,
    *,
    kv_len,
    scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Decode-phase attention, as ``repro.kernels.flash_attention.ops``'s:
    fp32 scores, keys at or past ``kv_len`` (an int, or one length a request)
    masked with ``NEG_INF``, and with a ``window`` also the keys below
    ``kv_len - window``; softmax, the output cast back to q's dtype.

    For an int ``kv_len`` (one length for the batch, as every caller here
    has) only the cache rows ``[max(0, kv_len - window), kv_len)`` are read
    (``[0, kv_len)`` without a window): a masked key's weight is exactly 0 in
    fp32 (exp(-1e30 - max)), so the function is unchanged and the cache read
    is the valid part only (half of Parti's, on average)."""
    B, _, H, D = q.shape
    one_len = isinstance(kv_len, int)
    if one_len:
        lo = 0 if window is None else max(0, kv_len - window)
        k_cache, v_cache = k_cache[:, lo:kv_len], v_cache[:, lo:kv_len]
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    group = H // KVH
    scale = scale if scale is not None else D ** -0.5
    # one batched product per request over strided views of the cache: (KVH,
    # g, D) @ (KVH, D, S) reads K in place (an einsum over (B, KVH) would copy
    # it to a contiguous layout first, 20 % of a LLaMA decode step)
    qf = q.float().reshape(B, KVH, group, D)
    kf, vf = k_cache.float(), v_cache.float()
    s = torch.stack([torch.matmul(qf[b], kf[b].permute(1, 2, 0)) for b in range(B)]) * scale
    if not one_len:  # every row read is valid otherwise
        pos, n = torch.arange(S, device=q.device), kv_len.to(q.device).reshape(-1, 1, 1, 1)
        ok = pos < n
        if window is not None:
            ok = ok & (pos >= n - window)
        s = torch.where(ok, s, _ref.NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.stack([torch.matmul(p[b], vf[b].permute(1, 0, 2)) for b in range(B)])
    return out.reshape(B, 1, H, D).to(q.dtype)


def temporal_attention(
    x_q: torch.Tensor,  # (B, F, HW, H, D) spatial layout
    x_k: torch.Tensor,
    x_v: torch.Tensor,
    *,
    scale: float | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    scale = scale if scale is not None else x_q.shape[-1] ** -0.5
    if resolve_model_impl(impl) != "kernel":
        return _ref.temporal_attention_ref(x_q, x_k, x_v, scale=scale)
    if needs_grad(x_q, x_k, x_v):
        return TemporalAttentionFn.apply(scale, x_q, x_k, x_v)
    return _kernel.temporal_flash_attention(x_q, x_k, x_v, scale=scale)
