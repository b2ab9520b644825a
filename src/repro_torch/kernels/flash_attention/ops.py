"""Dispatcher of attention, mirroring ``repro.kernels.flash_attention.ops``.

``attention(...)`` is the call-site API of every attention layer.  Tiers
(``repro_torch.kernels.tiers``): ``kernel`` runs the CUDA flash-attention
kernel (its plain version for a CPU tensor), ``torch`` the composite
``ref.attention_ref``.

Shapes: q (B, Sq, H, D); k/v (B, Skv, KVH, D); out (B, Sq, H, D).
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
