"""Plain PyTorch attention: the oracle of the flash-attention CUDA kernel.

Shapes follow the framework-wide convention, as in
``repro.kernels.flash_attention.ref``:
    q:      (B, Sq, H, D)
    k, v:   (B, Skv, KVH, D)     with H % KVH == 0 (GQA)
    out:    (B, Sq, H, D)
Computed in fp32 whatever the input dtype, then cast back.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
# the most bytes of fp32 scores one chunk of query rows computes at once
SCORE_BYTES = 1 << 30


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: int | None = None,
    scale: float | None = None,
    kv_offset: int = 0,
) -> torch.Tensor:
    """Softmax attention, computed over chunks of query rows whose
    (B, H, rows, Skv) fp32 scores stay within ``SCORE_BYTES``: each row's
    softmax is its own, so chunking leaves the function unchanged and
    bounds its memory (at Sq = Skv = 16384, B = 2, H = 8 the whole score
    block would be 17.2 GB)."""
    B, Sq, H, D = q.shape
    _, Skv, KVH, _ = k.shape
    if H % KVH:
        raise ValueError(f"{H} query heads over {KVH} kv heads")
    group = H // KVH
    scale = scale if scale is not None else D ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=2)
        vf = vf.repeat_interleave(group, dim=2)
    cols = torch.arange(Skv, device=q.device)[None, :]
    step = max(1, SCORE_BYTES // (B * H * Skv * 4))
    out = []
    for r0 in range(0, Sq, step):
        s = torch.einsum("bqhd,bkhd->bhqk", qf[:, r0:r0 + step], kf) * scale
        if causal or window is not None:
            rows = torch.arange(r0, min(Sq, r0 + step), device=q.device)[:, None] + kv_offset
            ok = torch.ones((rows.shape[0], Skv), dtype=torch.bool, device=q.device)
            if causal:
                ok &= cols <= rows
            if window is not None:
                ok &= rows - cols < window
            s = s + torch.where(ok, 0.0, NEG_INF)
        out.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vf))
        del s
    return (out[0] if len(out) == 1 else torch.cat(out, dim=1)).to(q.dtype)


def temporal_attention_ref(
    x_q: torch.Tensor,
    x_k: torch.Tensor,
    x_v: torch.Tensor,
    *,
    scale: float | None = None,
    frames_valid: int | None = None,
) -> torch.Tensor:
    """Attention across frames, as ``repro.kernels.flash_attention.ref``'s
    ``temporal_attention_ref``: inputs in the spatial layout (B, F, HW, H, D)
    are permuted to (B*HW, F, H, D), attended over F and permuted back.

    ``frames_valid`` (default F) masks key frames at or past it, as the
    TPU kernel does with -1e30: their weights are exactly 0 in fp32, so the
    keys are sliced away instead."""
    B, F, HW, H, D = x_q.shape
    fv = F if frames_valid is None else frames_valid

    def perm(t):
        return t.permute(0, 2, 1, 3, 4).reshape(B * HW, t.shape[1], H, D)

    out = attention_ref(perm(x_q), perm(x_k[:, :fv]), perm(x_v[:, :fv]), scale=scale)
    return out.reshape(B, HW, F, H, D).permute(0, 2, 1, 3, 4)
