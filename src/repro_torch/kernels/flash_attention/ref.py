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
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal or window is not None:
        rows = torch.arange(Sq, device=q.device)[:, None] + kv_offset
        cols = torch.arange(Skv, device=q.device)[None, :]
        ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
        if causal:
            ok &= cols <= rows
        if window is not None:
            ok &= rows - cols < window
        s = s + torch.where(ok, 0.0, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
