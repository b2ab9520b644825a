"""Wrappers of the attention CUDA kernels (``csrc/flash_attention.cu``,
``csrc/temporal_attention.cu``).

``flash_attention`` is the port of
``repro.kernels.flash_attention.flash_attention.flash_attention_bhsd``.
It reads ``(B, S, H, D)`` operands through their strides, so the TPU
wrapper's transpose to ``(B, H, S, D)`` and padding to block multiples have
no counterpart here.  ``temporal_flash_attention`` is the port of
``temporal_flash_attention`` there: attention across the frames of
``(B, F, HW, H, D)`` operands, read and written in that layout, launched
as ``temporal_plan`` gives.  A CUDA tensor launches the hand-written
kernel; a CPU tensor takes the plain version (``ref.attention_ref`` /
``ref.temporal_attention_ref``), and a ``meta`` tensor takes it shape only
(``build.takes_plain``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_P, ctypes.c_float] + [_I] * 4 + [_P]

_TEMPORAL_ARGTYPES = [_P] * 4 + [_I] * 5 + [_P, ctypes.c_float] + [_I] * 8 + [_P]

MAX_HEAD_DIM = 256
MAX_FRAMES = 32  # csrc/temporal_attention.cu kMaxFrames
# csrc/temporal_attention.cu: each warp's ring of q/k/v stages, and at most
# this many warps a block.
TEMPORAL_STAGES = 2
TEMPORAL_WARPS = 4


class TemporalPlan(NamedTuple):
    frames: int  # F rounded up to a power of two: lanes per position
    positions: int  # positions per work item (32 / frames): one item a warp
    row_stride: int  # elements per staged row, = 4 (mod 8)
    warps: int  # warps per block
    stages: int
    smem: int  # bytes of dynamic shared memory per block
    items: int  # B * H * ceil(HW / positions)
    blocks: int
    items_per_warp: int  # the most any warp takes


@functools.lru_cache(maxsize=None)
def temporal_plan(B: int, F: int, HW: int, H: int, D: int, elem_bytes: int) -> TemporalPlan:
    """The launch of one temporal attention call (F <= 32).

    A work item is one warp's ``positions`` spatial positions of one (head,
    batch); each warp keeps ``stages`` items of q, k and v rows (3 x 32 rows
    of ``row_stride`` elements each) in shared memory.  A block takes
    ``TEMPORAL_WARPS`` warps where their rings fit its shared memory, and the
    grid is as many blocks as fit on the card at once (``build.SM_SMEM`` and
    64 warps a SM), or fewer where there are fewer items; each warp then
    walks the items ``warp, warp + all warps, ...``."""
    frames = next(m for m in (4, 8, 16, 32) if F <= m)
    positions = 32 // frames
    row_stride = -(-D // 8) * 8 + 4  # D padded to 8 (two halves of 4s), = 4 (mod 8)
    warp_bytes = TEMPORAL_STAGES * 3 * 32 * row_stride * elem_bytes
    warps = max(1, min(TEMPORAL_WARPS, build.SMEM_LIMIT // warp_bytes))
    smem = warps * warp_bytes
    items = B * H * -(-HW // positions)
    per_sm = max(1, min(build.SM_SMEM // (smem + 1024), 64 // warps))
    blocks = min(-(-items // warps), build.SMS * per_sm)
    return TemporalPlan(frames, positions, row_stride, warps, TEMPORAL_STAGES, smem, items,
                        blocks, -(-items // (blocks * warps)))


@build.counted
def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KVH, D)
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = False,
    window: int | None = None,
    kv_offset: int = 0,
) -> torch.Tensor:
    if build.takes_plain(q):
        return ref.attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                                 kv_offset=kv_offset)
    dev = build.check_device(q, k, v)
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes fp32/bf16 q, k, v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    B, Sq, H, D = q.shape
    _, Skv, KVH, _ = k.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[-1] != D or H % KVH:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash attention needs a unit stride on the head dim")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in (t.stride(0), t.stride(1), t.stride(2))))
    fn = build.function("rt_flash_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv, H,
             KVH, D, ctypes.addressof(strides), float(scale), int(causal),
             0 if window is None else int(window), int(kv_offset),
             build.DTYPE_CODES[q.dtype], build.stream(dev))
    build.check_error(err, "flash_attention")
    build.launches["flash_attention"] += 1
    return out


@build.counted
def temporal_flash_attention(
    q: torch.Tensor,  # (B, F, HW, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    frames_valid: int | None = None,
) -> torch.Tensor:
    """Attention across the frame axis F for every (batch, spatial position,
    head); key frames at or past ``frames_valid`` (default F) are masked."""
    F = q.shape[1]
    fv = F if frames_valid is None else int(frames_valid)
    if not 1 <= fv <= F:
        raise ValueError(f"frames_valid must be in [1, {F}], got {frames_valid}")
    if build.takes_plain(q):
        return ref.temporal_attention_ref(q, k, v, scale=scale, frames_valid=fv)
    dev = build.check_device(q, k, v)
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"temporal attention takes fp32/bf16 q, k, v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 5 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v of one shape (B, F, HW, H, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, F, HW, H, D = q.shape
    if F > MAX_FRAMES or D > MAX_HEAD_DIM:
        raise ValueError(f"F={F}, D={D}: the kernel takes at most {MAX_FRAMES} frames and "
                         f"head dim {MAX_HEAD_DIM}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("temporal attention needs a unit stride on the head dim")
    p = temporal_plan(B, F, HW, H, D, q.element_size())
    if p.smem > build.SMEM_LIMIT:
        raise ValueError(f"F={F}, D={D} needs {p.smem} bytes of shared memory, more than "
                         f"{build.SMEM_LIMIT}")
    out = torch.empty((B, F, HW, H, D), dtype=q.dtype, device=dev)
    tensors = (q, k, v, out)
    strides = [s for t in tensors for s in t.stride()[:4]]
    # 16-byte fp32 / 8-byte bf16 row copies need aligned rows
    align = 4 * q.element_size()
    vec = D % 4 == 0 and all(s % 4 == 0 for s in strides) and all(
        t.data_ptr() % align == 0 for t in tensors)
    fn = build.function("rt_temporal_attention", _TEMPORAL_ARGTYPES)
    st = (ctypes.c_longlong * 16)(*strides)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, F, HW, H, D,
             ctypes.addressof(st), float(scale), fv, int(vec), p.frames, p.row_stride,
             p.warps, p.blocks, p.smem, build.DTYPE_CODES[q.dtype], build.stream(dev))
    build.check_error(err, "temporal_flash_attention")
    build.launches["temporal_flash_attention"] += 1
    return out
