"""Dispatcher of fused GroupNorm + SiLU, mirroring ``repro.kernels.groupnorm_silu.ops``."""

from __future__ import annotations

import torch

from repro_torch.kernels.groupnorm_silu import groupnorm_silu as _kernel
from repro_torch.kernels.groupnorm_silu import ref as _ref
from repro_torch.kernels.tiers import resolve_model_impl


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
    fn = _kernel.groupnorm_silu if resolve_model_impl(impl) == "kernel" else _ref.groupnorm_silu_ref
    return fn(x3, scale, bias, groups=groups, eps=eps, silu=silu).reshape(shape)
