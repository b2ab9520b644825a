"""Plain PyTorch GroupNorm (+ SiLU): the oracle of the GroupNorm CUDA kernel.

Layout: x (B, N, C) with N = H*W flattened spatial, channels last;
``scale``/``bias``: (C,).  As ``repro.kernels.groupnorm_silu.ref``: fp32,
two-pass variance, cast back.  ``groupnorm_silu_onepass_ref`` is the same
function with the kernel's one-pass variance ``E[x^2] - mean^2``: the
kernel tier's backward differentiates it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def groupnorm_silu_ref(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    groups: int,
    eps: float = 1e-5,
    silu: bool = True,
) -> torch.Tensor:
    B, N, C = x.shape
    if C % groups:
        raise ValueError(f"{C} channels over {groups} groups")
    xf = x.float().reshape(B, N, groups, C // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.var(dim=(1, 3), keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y.reshape(B, N, C) * scale.float() + bias.float()
    if silu:
        y = F.silu(y)
    return y.to(x.dtype)


def groupnorm_silu_onepass_ref(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    groups: int,
    eps: float = 1e-5,
    silu: bool = True,
) -> torch.Tensor:
    B, N, C = x.shape
    if C % groups:
        raise ValueError(f"{C} channels over {groups} groups")
    xf = x.float().reshape(B, N, groups, C // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y.reshape(B, N, C) * scale.float() + bias.float()
    if silu:
        y = F.silu(y)
    return y.to(x.dtype)
