"""Wrappers of the conv CUDA kernels (``csrc/conv2d.cu``,
``csrc/temporal_conv1d.cu``).

``conv2d`` is the port of ``repro.kernels.conv2d.conv2d.conv2d_pallas``;
``temporal_conv1d`` the port of ``temporal_conv1d_pallas`` there.  A CUDA
tensor launches the hand-written kernel; a CPU tensor takes the plain
version (``ref.conv2d_ref`` / ``ref.temporal_conv1d_ref``), which is how
the CPU tests reach these functions.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.conv2d import ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 10 + [_I] * 12 + [_P]

_TCONV_ARGTYPES = [_P] * 4 + [_I] * 7 + [_P]

BLOCK_M = 64  # output pixels per block (csrc/conv2d.cu BM)
MAX_TAPS = 9  # csrc/temporal_conv1d.cu kMaxTaps


def _f32(t: torch.Tensor | None, shape: tuple) -> torch.Tensor | None:
    if t is None:
        return None
    if tuple(t.shape) != shape:
        raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
    return t.to(torch.float32).contiguous()


def conv2d(
    x: torch.Tensor,  # (B, H, W, C_in)
    w: torch.Tensor,  # (K, K, C_in, C_out)
    *,
    stride: int = 1,
    gn_a: torch.Tensor | None = None,
    gn_b: torch.Tensor | None = None,
    gn_silu: bool = True,
    bias: torch.Tensor | None = None,
    temb: torch.Tensor | None = None,
    silu: bool = False,
    residual: torch.Tensor | None = None,
    emit_stats: bool = False,
):
    """Fused NHWC conv: ``y`` or ``(y, stats)``; see ``ref.conv2d_ref``."""
    if x.device.type == "cpu":
        return ref.conv2d_ref(
            x, w, stride=stride, gn_a=gn_a, gn_b=gn_b, gn_silu=gn_silu, bias=bias,
            temb=temb, silu=silu, residual=residual, emit_stats=emit_stats)
    dev = build.check_device(x, w, gn_a, gn_b, bias, temb, residual)
    if x.dtype not in build.DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"conv2d kernel takes fp32/bf16 x and w of one dtype, got "
                        f"{x.dtype}/{w.dtype}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"expected x (B,H,W,C) and w (K,K,C_in,C_out), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, H, W, C_in = x.shape
    K, K2, w_cin, C_out = w.shape
    if K != K2 or K not in (1, 3) or w_cin != C_in or stride not in (1, 2):
        raise ValueError(f"unsupported conv: w {tuple(w.shape)} for C_in={C_in}, "
                         f"stride {stride}")
    if (gn_a is None) != (gn_b is None):
        raise ValueError("gn_a and gn_b come together")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv2d kernel takes contiguous x and w")
    pad = K // 2
    OH = (H + 2 * pad - K) // stride + 1
    OW = (W + 2 * pad - K) // stride + 1
    if residual is not None:
        if tuple(residual.shape) != (B, OH, OW, C_out) or residual.dtype != x.dtype:
            raise ValueError(f"residual must be {(B, OH, OW, C_out)} {x.dtype}")
        residual = residual.contiguous()
    gn_a = _f32(gn_a, (B, C_in))
    gn_b = _f32(gn_b, (B, C_in))
    bias = _f32(bias, (C_out,))
    temb = _f32(temb, (B, C_out))

    out = torch.empty((B, OH, OW, C_out), dtype=x.dtype, device=dev)
    partial = stats = None
    if emit_stats:
        n_tiles = -(-(OH * OW) // BLOCK_M)
        partial = torch.empty((B, n_tiles, 2, C_out), dtype=torch.float32, device=dev)
        stats = torch.empty((B, 2, C_out), dtype=torch.float32, device=dev)
    p = build.ptr
    fn = build.function("rt_conv2d", _ARGTYPES)
    err = fn(p(x), p(w), p(gn_a), p(gn_b), p(bias), p(temb), p(residual), p(out),
             p(partial), p(stats), B, H, W, C_in, OH, OW, C_out, K, stride,
             int(gn_silu), int(silu), build.DTYPE_CODES[x.dtype], build.stream(dev))
    build.check_error(err, "conv2d")
    build.launches["conv2d"] += 1
    return (out, stats) if emit_stats else out


def temporal_conv1d(
    x: torch.Tensor,  # (B, F, N, C): conv over the frame axis F
    w: torch.Tensor,  # (K, C, C_out), K odd
    bias: torch.Tensor,  # (C_out,)
) -> torch.Tensor:
    """``y[b, f, n] = bias + sum_k x[b, f + k - K//2, n] @ w[k]``, frames
    outside [0, F) zero; see ``ref.temporal_conv1d_ref``."""
    if x.device.type == "cpu":
        B, F, N, C = x.shape
        y = ref.temporal_conv1d_ref(x.reshape(B, F, N, 1, C), w, bias)
        return y.reshape(B, F, N, w.shape[-1])
    dev = build.check_device(x, w, bias)
    if x.dtype not in build.DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"temporal conv kernel takes fp32/bf16 x and w of one dtype, got "
                        f"{x.dtype}/{w.dtype}")
    if x.dim() != 4 or w.dim() != 3:
        raise ValueError(f"expected x (B,F,N,C) and w (K,C,C_out), got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    B, F, N, C = x.shape
    K, w_c, C_out = w.shape
    if w_c != C or K % 2 == 0 or K > MAX_TAPS:
        raise ValueError(f"unsupported temporal conv: w {tuple(w.shape)} for C={C} "
                         f"(odd K <= {MAX_TAPS})")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("temporal conv kernel takes contiguous x and w")
    bias = _f32(bias, (C_out,))
    out = torch.empty((B, F, N, C_out), dtype=x.dtype, device=dev)
    fn = build.function("rt_temporal_conv1d", _TCONV_ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), B, F, N, C, C_out,
             K, build.DTYPE_CODES[x.dtype], build.stream(dev))
    build.check_error(err, "temporal_conv1d")
    build.launches["temporal_conv1d"] += 1
    return out
