"""Plain PyTorch version of the fused Conv2D: the oracle of the CUDA kernel.

Semantics of one fused call (all pieces optional), as in
``repro.kernels.conv2d.ref``:

    x_hat = silu?(x * gn_a + gn_b)          # fused GroupNorm producer
    y     = conv2d(x_hat, w, stride, SAME)
    y     = y + bias + temb[:, None, None]
    y     = silu?(y)
    out   = y + residual
    stats = (sum y, sum y^2) per (batch, out-channel)

Layouts: x (B, H, W, C_in), w (K, K, C_in, C_out) HWIO, out NHWC.
Everything is computed in fp32 whatever the input dtype, then cast back.

``temporal_conv1d_ref`` is the oracle of the temporal conv kernel: a K-tap
zero-padded conv over the frame axis of (B, F, H, W, C) video tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    gn_a: torch.Tensor | None = None,  # (B, C_in) fp32
    gn_b: torch.Tensor | None = None,
    gn_silu: bool = True,
    bias: torch.Tensor | None = None,  # (C_out,)
    temb: torch.Tensor | None = None,  # (B, C_out)
    silu: bool = False,
    residual: torch.Tensor | None = None,  # (B, OH, OW, C_out)
    emit_stats: bool = False,
):
    xf = x.float()
    if gn_a is not None:
        xf = xf * gn_a.float()[:, None, None, :] + gn_b.float()[:, None, None, :]
        if gn_silu:
            xf = F.silu(xf)
    pad = w.shape[0] // 2
    y = F.conv2d(xf.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                 stride=stride, padding=pad).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.float()
    if temb is not None:
        y = y + temb.float()[:, None, None, :]
    if silu:
        y = F.silu(y)
    if residual is not None:
        y = y + residual.float()
    out = y.to(x.dtype).contiguous()
    if emit_stats:
        stats = torch.stack([y.sum((1, 2)), (y * y).sum((1, 2))], dim=1)  # (B, 2, C_out)
        return out, stats
    return out


def temporal_conv1d_ref(
    x: torch.Tensor,  # (B, F, H, W, C): conv over the frame axis F
    w: torch.Tensor,  # (K, C, C_out)
    bias: torch.Tensor | None = None,  # (C_out,)
) -> torch.Tensor:
    """The conventional materialized-permute version, as in
    ``repro.kernels.conv2d.ref``: (B,F,H,W,C) -> (B*H*W, C, F) -> conv1d
    (pad K//2, fp32) -> permute back."""
    B, nf, H, W, C = x.shape
    K, _, C_out = w.shape
    xf = x.float().permute(0, 2, 3, 4, 1).reshape(B * H * W, C, nf)
    wf = w.to(x.dtype).float().permute(2, 1, 0)  # (C_out, C, K)
    y = F.conv1d(xf, wf, padding=K // 2)  # (BHW, C_out, F)
    if bias is not None:
        y = y + bias.float()[:, None]
    y = y.reshape(B, H, W, C_out, nf).permute(0, 4, 1, 2, 3)
    return y.to(x.dtype).contiguous()
