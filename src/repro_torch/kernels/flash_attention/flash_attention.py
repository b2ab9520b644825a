"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

The port of ``repro.kernels.flash_attention.flash_attention.flash_attention_bhsd``.
It reads ``(B, S, H, D)`` operands through their strides, so the TPU
wrapper's transpose to ``(B, H, S, D)`` and padding to block multiples have
no counterpart here.  A CUDA tensor launches the hand-written kernel; a CPU
tensor takes the plain version (``ref.attention_ref``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_P, ctypes.c_float] + [_I] * 4 + [_P]

MAX_HEAD_DIM = 256


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
    if q.device.type == "cpu":
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
