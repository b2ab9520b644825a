"""Wrapper of the GroupNorm(+SiLU) CUDA kernel (``csrc/groupnorm_silu.cu``).

The port of ``repro.kernels.groupnorm_silu.groupnorm_silu.groupnorm_silu_pallas``.
Ragged N needs no padding here: a block walks its group's rows itself.  A
CUDA tensor launches the hand-written kernel; a CPU tensor takes the plain
version (``ref.groupnorm_silu_ref``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.groupnorm_silu import ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 4 + [ctypes.c_float] + [_I] * 2 + [_P]


def groupnorm_silu(
    x: torch.Tensor,  # (B, N, C)
    scale: torch.Tensor,  # (C,)
    bias: torch.Tensor,
    *,
    groups: int,
    eps: float = 1e-5,
    silu: bool = True,
) -> torch.Tensor:
    if x.device.type == "cpu":
        return ref.groupnorm_silu_ref(x, scale, bias, groups=groups, eps=eps, silu=silu)
    dev = build.check_device(x, scale, bias)
    if x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"groupnorm kernel takes fp32/bf16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"expected contiguous (B, N, C), got {tuple(x.shape)}")
    B, N, C = x.shape
    if C % groups or scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"{C} channels, {groups} groups, scale {tuple(scale.shape)}")
    if N * C >= 2 ** 31:
        raise ValueError("groupnorm kernel indexes a batch image with 32-bit ints")
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    fn = build.function("rt_groupnorm_silu", _ARGTYPES)
    err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), B, N, C,
             groups, float(eps), int(silu), build.DTYPE_CODES[x.dtype], build.stream(dev))
    build.check_error(err, "groupnorm_silu")
    build.launches["groupnorm_silu"] += 1
    return out
