"""Rotary position embeddings (``repro.models.layers.rope``): standard RoPE
with partial rotary.  Each head splits into halves (not interleaved pairs),
and the angles are computed in fp32.  M-RoPE comes with the VLM family.
"""

from __future__ import annotations

import functools

import torch


def rope_freqs(head_dim: int, base: float = 10000.0) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, in fp32 on the CPU (so every device
    rotates by the same frequencies)."""
    return 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _freqs_on(rot_d: int, base: float, device: torch.device) -> torch.Tensor:
    # once per width and device: a decode step rotates in every layer
    return rope_freqs(rot_d, base).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, base: float = 10000.0,
               rotary_pct: float = 1.0) -> torch.Tensor:
    """x (B, S, H, D) rotated at ``positions`` (B, S); the first ``rot_d``
    channels of each head rotate, the rest pass through."""
    D = x.shape[-1]
    rot_d = D if rotary_pct >= 1.0 else max(2, int(D * rotary_pct) // 2 * 2)
    xr, x_pass = x[..., :rot_d], x[..., rot_d:]
    inv = _freqs_on(rot_d, base, x.device)
    angles = positions.float()[..., None] * inv  # (B, S, rot_d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = xr.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot_d < D else out
