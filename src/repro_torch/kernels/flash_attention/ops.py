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

On a mesh (DTensor operands) both run on local shards through the
boundary of ``kernels.shards``: ``attention`` head-parallel over the GQA
group axis, ``temporal_attention`` over the batch and the heads.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import shards
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
    if shards.on_mesh(q, k, v):
        return _attention_on_mesh(q, k, v, causal=causal, window=window, scale=scale,
                                  kv_offset=kv_offset, impl=impl)
    if resolve_model_impl(impl) != "kernel":
        return _ref.attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                                  kv_offset=kv_offset)
    if needs_grad(q, k, v):
        return FlashAttentionFn.apply((causal, window, scale, kv_offset), q, k, v)
    return _kernel.flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                                   kv_offset=kv_offset)


def _attention_on_mesh(q, k, v, *, impl: str, **kw):
    """``attention`` on DTensors: head-parallel over the GQA **group** axis,
    as the reference pins it (``src/repro/kernels/flash_attention/ops.py``
    ``_blocked_attention``): q viewed (B, Sq, KVH, group, D) with its batch on
    the batch axes and its group axis on ``model``, K/V replicated over
    ``model``.  Each rank then runs the tier on (B_loc, Sq, KVH * g_loc, D)
    against its (B_loc, Skv, KVH, D) K/V, where the kernel's ``h // g_loc``
    maps a local head to its own KV head (a flat head split would not)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = shards.mesh_of(q, k, v)
    B, Sq, H, D = q.shape
    KVH = k.shape[2]
    group = H // KVH
    if KVH % shards.shard_count(q, 2):
        # heads sharded wider than the KV heads: DTensor carries no shard
        # from the heads into (KVH, group), so they are gathered first
        heads = shards.sharded_dims(q, 2)
        q = shards.as_placed(q, mesh, tuple(
            Replicate() if i in heads else p for i, p in enumerate(q.placements)))
    out_pl = tuple(shards.pinned((B, Sq, KVH, group, D), ("batch", None, None, "model", None),
                                 mesh))
    q5 = shards.as_placed(q.reshape(B, Sq, KVH, group, D), mesh, out_pl)
    kv_pl = tuple(shards.pinned(tuple(k.shape), ("batch", None, None, None), mesh))
    k, v = (shards.as_placed(t, mesh, kv_pl) for t in (k, v))
    ql, kl, vl = (shards.local(t, out_pl) for t in (q5, k, v))
    b, _, _, g, _ = ql.shape
    out = attention(ql.reshape(b, Sq, KVH * g, D), kl, vl, impl=impl, **kw)
    if KVH == 1:  # the group axis is the head axis
        return shards.wrap(out, mesh, tuple(
            Shard(2) if p.is_shard(3) else p for p in out_pl), (B, Sq, H, D))
    out5 = shards.wrap(out.reshape(b, Sq, KVH, g, D), mesh, out_pl, (B, Sq, KVH, group, D))
    # DTensor has no rule to fold a sharded group axis into the heads: the
    # output is gathered over it first (a named redistribution site)
    return shards.as_placed(out5, mesh, tuple(
        Replicate() if p.is_shard(3) else p for p in out_pl)).reshape(B, Sq, H, D)


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
    if shards.on_mesh(q, k_cache, v_cache):
        return _decode_attention_on_mesh(q, k_cache, v_cache, kv_len=kv_len, scale=scale,
                                         window=window)
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


def _decode_attention_on_mesh(q, k_cache, v_cache, **kw):
    """``decode_attention`` on DTensors, through the kernels' boundary: each
    rank attends its own requests (the batch over the batch axes) in its
    own heads (over ``model``, where both head counts divide it: a rank's
    query heads then group onto its own KV heads) to their whole cache,
    gathered over the sequence, on local tensors.  DTensor runs no
    flash-decoding over a sequence-sharded cache either, and its view rules
    cannot fold a sharded head axis into a batched product's batch (torch
    2.11); indexing a request of the sharded batch, as the per-request loop
    does, would gather the batch whole on every rank."""
    from repro_torch.parallel.sharding import mesh_shape

    mesh = shards.mesh_of(q, k_cache, v_cache)
    m = mesh_shape(mesh).get("model", 1)
    heads = "model" if q.shape[2] % m == 0 and k_cache.shape[2] % m == 0 else None
    q_pl = tuple(shards.pinned(tuple(q.shape), ("batch", None, heads, None), mesh))
    kv_pl = tuple(shards.pinned(tuple(k_cache.shape), ("batch", None, heads, None), mesh))
    ql = shards.local(shards.as_placed(q, mesh, q_pl), q_pl)
    kl, vl = (shards.local(shards.as_placed(t, mesh, kv_pl), q_pl) for t in (k_cache, v_cache))
    kv_len = kw.pop("kv_len")
    if shards.on_mesh(kv_len):  # one length a request: the rank's own requests'
        pl = tuple(shards.pinned(tuple(kv_len.shape), ("batch",), mesh))
        kv_len = shards.local(shards.as_placed(kv_len, mesh, pl), q_pl)
    out = decode_attention(ql, kl, vl, kv_len=kv_len, **kw)
    return shards.wrap(out, mesh, q_pl, tuple(q.shape))


def temporal_attention(
    x_q: torch.Tensor,  # (B, F, HW, H, D) spatial layout
    x_k: torch.Tensor,
    x_v: torch.Tensor,
    *,
    scale: float | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    scale = scale if scale is not None else x_q.shape[-1] ** -0.5
    if shards.on_mesh(x_q, x_k, x_v):
        # per (batch, position, head) independent: the batch on the batch
        # axes and the heads on ``model``, the frames whole on every rank
        mesh = shards.mesh_of(x_q, x_k, x_v)
        pl = tuple(shards.pinned(tuple(x_q.shape), ("batch", None, None, "model", None), mesh))
        ql, kl, vl = (shards.local(shards.as_placed(t, mesh, pl), pl) for t in (x_q, x_k, x_v))
        out = temporal_attention(ql, kl, vl, scale=scale, impl=impl)
        return shards.wrap(out, mesh, pl, tuple(x_q.shape))
    if resolve_model_impl(impl) != "kernel":
        return _ref.temporal_attention_ref(x_q, x_k, x_v, scale=scale)
    if needs_grad(x_q, x_k, x_v):
        return TemporalAttentionFn.apply(scale, x_q, x_k, x_v)
    return _kernel.temporal_flash_attention(x_q, x_k, x_v, scale=scale)
