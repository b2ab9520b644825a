"""Dispatcher of attention, mirroring ``repro.kernels.flash_attention.ops``.

``attention(...)`` is the call-site API of every attention layer.  Tiers
(``repro_torch.kernels.tiers``): ``kernel`` runs the CUDA flash-attention
kernel (its plain version for a CPU tensor), ``torch`` the composite
``ref.attention_ref``.

Shapes: q (B, Sq, H, D); k/v (B, Skv, KVH, D); out (B, Sq, H, D).

``temporal_attention(...)`` attends across frames of (B, F, HW, H, D)
operands: the ``kernel`` tier runs the temporal CUDA kernel in that layout,
the ``torch`` tier the conventional permute to (B*HW, F, H, D), attention
and permute back (``ref.temporal_attention_ref``), as the reference's
``ops.temporal_attention``.  The kernel masks its ragged spatial tail
itself, so the TPU dispatcher's padding of HW has no counterpart.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention as _kernel
from repro_torch.kernels.flash_attention import ref as _ref
from repro_torch.kernels.tiers import resolve_model_impl


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
    fn = _kernel.flash_attention if resolve_model_impl(impl) == "kernel" else _ref.attention_ref
    return fn(q, k, v, causal=causal, window=window, scale=scale, kv_offset=kv_offset)


def temporal_attention(
    x_q: torch.Tensor,  # (B, F, HW, H, D) spatial layout
    x_k: torch.Tensor,
    x_v: torch.Tensor,
    *,
    scale: float | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    scale = scale if scale is not None else x_q.shape[-1] ** -0.5
    if resolve_model_impl(impl) == "kernel":
        return _kernel.temporal_flash_attention(x_q, x_k, x_v, scale=scale)
    return _ref.temporal_attention_ref(x_q, x_k, x_v, scale=scale)
