"""Analytical memory/FLOPs model of diffusion UNets (the paper's §V math),
the port of ``repro.core.analytical``:

  * self-attention sequence length  (H_L * W_L)
  * cross-attention similarity      H_L*W_L x text_encode
  * similarity-matrix memory        2*H_L*W_L*[H_L*W_L + text_encode]
  * cumulative memory over the UNet with downsampling factor d^n
  * the O(L^4) attention-memory scaling law in image/latent dimension

and the UNet block walk (:func:`unet_block_profile`) that both the Fig. 7
attention profile and the serving HBM-demand profile
(``workload.diffusion.unet_demand``) are derived from.
"""

from __future__ import annotations

import math


def self_attn_seq_len(h_l: int, w_l: int) -> int:
    return h_l * w_l


def similarity_matrix_bytes(
    h_l: int, w_l: int, text_encode: int, bytes_per_el: int = 2
) -> float:
    """Paper §V:  2 * (HL*WL)^2 + 2 * (HL*WL) * text_encode   (FP16)."""
    hw = h_l * w_l
    return bytes_per_el * hw * hw + bytes_per_el * hw * text_encode


def cumulative_similarity_bytes(
    h_l: int,
    w_l: int,
    text_encode: int,
    unet_depth: int,
    d: int = 2,
    bytes_per_el: int = 2,
    blocks_per_stage: int = 2,
) -> float:
    """Paper §V cumulative formula: the down stages (x2 for the up path) plus
    the bottleneck stage."""
    total = 0.0
    for n in range(unet_depth):
        hw = (h_l * w_l) / (d ** (2 * n))  # area scales with d^2 per stage
        total += 2 * blocks_per_stage * bytes_per_el * hw * (hw + text_encode)
    hw = (h_l * w_l) / (d ** (2 * unet_depth))
    total += blocks_per_stage * bytes_per_el * hw * (hw + text_encode)
    return total


def attn_memory_scaling_exponent(sizes: list[int], text_encode: int = 77) -> float:
    """Fit log(mem) ~ k*log(L): the paper reports k -> 4 (O(L^4))."""
    xs = [math.log(s) for s in sizes]
    ys = [math.log(similarity_matrix_bytes(s, s, text_encode)) for s in sizes]
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    num = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    den = sum((x - mx) ** 2 for x in xs)
    return num / den


def unet_block_profile(
    latent_hw: int, channel_mult: tuple, num_res_blocks: int,
    attn_levels: tuple, weight,
) -> list:
    """Walk one UNet pass (down -> mid -> up) and collect
    ``weight(hw, mult, has_attn)`` per block; ``None`` skips the block.

    The UNet block topology: hw halves per level, ``num_res_blocks`` blocks
    down and ``num_res_blocks + 1`` up per level, and a mid block that
    always attends."""
    prof = []
    hw = latent_hw
    n = len(channel_mult)
    for level in range(n):  # down
        prof += [weight(hw, channel_mult[level], level in attn_levels)] * num_res_blocks
        if level != n - 1:
            hw //= 2
    prof.append(weight(hw, channel_mult[-1], True))  # mid (always attends)
    for level in reversed(range(n)):  # up
        prof += [weight(hw, channel_mult[level], level in attn_levels)] * (num_res_blocks + 1)
        if level != 0:
            hw *= 2
    return [v for v in prof if v is not None]


def unet_seq_profile(
    latent_hw: int, channel_mult: tuple, num_res_blocks: int, attn_levels: tuple
) -> list[int]:
    """Predicted per-attention-call sequence lengths over one UNet pass
    (down -> mid -> up): the analytic counterpart of the Fig. 7 U-shape."""
    return unet_block_profile(
        latent_hw, channel_mult, num_res_blocks, attn_levels,
        lambda hw, mult, attn: hw * hw if attn else None)
