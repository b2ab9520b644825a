"""Rotary position embeddings (``repro.models.layers.rope``): standard RoPE
with partial rotary, and Qwen2-VL's M-RoPE.  Each head splits into halves
(not interleaved pairs), and the angles are computed in fp32.
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


@functools.lru_cache(maxsize=None)
def _section_ids(sections: tuple, device: torch.device) -> torch.Tensor:
    # the stream each of the D/2 channels reads: the reference's jnp.repeat
    # of arange(3) by the sections
    ids = torch.repeat_interleave(torch.arange(3), torch.tensor(sections))
    return ids.to(device)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections: tuple, *,
                base: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: x (B, S, H, D) rotated at ``positions``
    (3, B, S), the temporal, height and width streams.  The D/2 frequency
    channels split into ``sections`` (summing to D/2), each rotated by its
    own stream; with three equal streams it is ``apply_rope``."""
    D = x.shape[-1]
    if sum(sections) != D // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to D/2 = {D // 2}")
    inv = _freqs_on(D, base, x.device)
    pos = positions.float()[_section_ids(tuple(sections), x.device)]  # (D/2, B, S)
    angles = pos.movedim(0, -1) * inv  # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """(B, S) -> (3, B, S) with identical streams (text-only M-RoPE)."""
    return positions[None].expand(3, *positions.shape)
