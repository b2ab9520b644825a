"""Wrappers of the conv CUDA kernels (``csrc/conv2d.cu``,
``csrc/temporal_conv1d.cu``).

``conv2d`` is the port of ``repro.kernels.conv2d.conv2d.conv2d_pallas``;
``temporal_conv1d`` the port of ``temporal_conv1d_pallas`` there.  A CUDA
tensor launches the hand-written kernel; a CPU tensor takes the plain
version (``ref.conv2d_ref`` / ``ref.temporal_conv1d_ref``), which is how
the CPU tests reach these functions.  ``plan`` picks the conv kernel's
block tile and its split-K slices for each call.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.conv2d import ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 12 + [_I] * 15 + [_P]

_TCONV_ARGTYPES = [_P] * 4 + [_I] * 7 + [_P]

MAX_TAPS = 9  # csrc/temporal_conv1d.cu kMaxTaps

# csrc/conv2d.cu's tiling: the (BM, BN) block tiles it instantiates, the
# reduction depth of one pipeline chunk, and the rows per block of its split-K
# epilogue (the row tiles of the statistics partials when it splits).
TILES = ((128, 128), (128, 64), (64, 128), (128, 16))
CHUNK = 32
SPLIT_ROWS = 16
SMS = 132  # streaming multiprocessors of the H100 SXM: one wave of blocks
MIN_SLICE_CHUNKS = 4  # a split-K slice walks at least this many chunks


def _least_padding(size: int, options: tuple) -> list:
    """``options`` ordered by the padding they leave on ``size``, then larger first."""
    return sorted(options, key=lambda t: (-(-size // t) * t, -t))


def plan(B: int, OH: int, OW: int, C_out: int, R: int) -> tuple[int, int, int]:
    """``(bm, bn, splits)`` of one conv: the block tile and the number of
    reduction slices (split-K).

    The tile is the first of ``TILES`` (least padding of OH*OW and C_out,
    then larger) whose grid of ``B * ceil(OH*OW/bm) * ceil(C_out/bn)`` blocks
    fills the card's ``SMS``; it then runs unsplit.  Where no tile does, the
    least-padded one is split over R: the smallest split count in
    [ceil(SMS/blocks), 2 ceil(SMS/blocks)] that wastes least of its last
    wave, each slice a whole number of ``CHUNK``-deep chunks, at least
    ``MIN_SLICE_CHUNKS`` of them, and no slice empty."""
    P = OH * OW
    bns = (16,) if C_out <= 16 else _least_padding(C_out, (128, 64))
    cands = [(bm, bn) for bm in _least_padding(P, (128, 64)) for bn in bns
             if (bm, bn) in TILES]
    blocks = {c: B * -(-P // c[0]) * -(-C_out // c[1]) for c in cands}
    for c in cands:
        if blocks[c] >= SMS:
            return (*c, 1)
    bm, bn = cands[0]
    n = blocks[cands[0]]
    s_max = max(1, -(-R // CHUNK) // MIN_SLICE_CHUNKS)
    s_min = min(-(-SMS // n), s_max)
    splits = min(range(s_min, min(2 * s_min, s_max) + 1),
                 key=lambda s: (-(-n * s // SMS) / s, s))
    return bm, bn, len(slices(R, splits))


def slices(R: int, splits: int) -> list[tuple[int, int]]:
    """The reduction range ``[start, stop)`` of each non-empty split-K slice:
    ``csrc/conv2d.cu`` gives slice ``blockIdx.z`` the chunks from
    ``blockIdx.z * chunks_per_split`` on, ``chunks_per_split`` =
    ceil(ceil(R / CHUNK) / splits)."""
    chunks = -(-R // CHUNK)
    per = -(-chunks // splits) * CHUNK
    return [(s, min(s + per, R)) for s in range(0, R, per)]


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

    bm, bn, splits = plan(B, OH, OW, C_out, K * K * C_in)
    out = torch.empty((B, OH, OW, C_out), dtype=x.dtype, device=dev)
    partial = stats = ws = x_hat = None
    if gn_a is not None and x.dtype == torch.float32:  # the producer's output (csrc note 3)
        x_hat = torch.empty(x.shape, dtype=torch.float32, device=dev)
    if splits > 1:
        ws = torch.empty((splits, B, OH * OW, C_out), dtype=torch.float32, device=dev)
    if emit_stats:
        n_tiles = -(-(OH * OW) // (SPLIT_ROWS if splits > 1 else bm))
        partial = torch.empty((B, n_tiles, 2, C_out), dtype=torch.float32, device=dev)
        stats = torch.empty((B, 2, C_out), dtype=torch.float32, device=dev)
    p = build.ptr
    fn = build.function("rt_conv2d", _ARGTYPES)
    err = fn(p(x), p(w), p(gn_a), p(gn_b), p(bias), p(temb), p(residual), p(out),
             p(partial), p(stats), p(ws), p(x_hat), B, H, W, C_in, OH, OW, C_out, K, stride,
             int(gn_silu), int(silu), bm, bn, splits, build.DTYPE_CODES[x.dtype],
             build.stream(dev))
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
