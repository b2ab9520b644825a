"""CPU-sized cascade configs, structure over size (``repro.configs.tiny``).

A pixel diffusion-SR cascade and a keyframe/temporal TTV, small enough for
the fast test tier yet carrying the full multi-stage structure.
``TINY_SR_UNET`` is the only small config with the structure of Imagen's
1024 px SR UNet: a 6-channel ``[z, upsampled image]`` input, no per-level
attention and no cross-attention."""

from __future__ import annotations

from repro_torch.models.diffusion import DiffusionConfig, SRStage
from repro_torch.models.text_encoder import TextEncoderConfig
from repro_torch.models.ttv import TTVConfig
from repro_torch.models.unet import UNetConfig

TINY_TEXT = TextEncoderConfig(vocab=128, max_len=8, n_layers=1, d_model=32,
                              n_heads=2, d_ff=64)
TINY_BASE_UNET = UNetConfig(
    in_channels=3, out_channels=3, model_channels=16, channel_mult=(1, 2),
    num_res_blocks=1, attn_levels=(0,), cross_attn=True, context_dim=32,
    head_channels=8, groups=8)
TINY_SR_UNET = UNetConfig(
    in_channels=6, out_channels=3, model_channels=8, channel_mult=(1, 2),
    num_res_blocks=1, attn_levels=(), cross_attn=False, context_dim=32,
    head_channels=8, groups=8)

TINY_TTI_CASCADE = DiffusionConfig(
    name="tiny-tti-cascade", kind="pixel", image_size=8, latent_down=1,
    unet=TINY_BASE_UNET, text=TINY_TEXT, vae=None,
    sr_stages=(SRStage(out_size=16, unet=TINY_SR_UNET, steps=2),),
    denoise_steps=3)

TINY_TTV_CASCADE = TTVConfig(
    name="tiny-ttv-cascade", unet=TINY_BASE_UNET, text=TINY_TEXT, frames=2,
    image_size=8, denoise_steps=2, temporal_head_channels=8)


def tiny_cascade_configs() -> tuple:
    return TINY_TTI_CASCADE, TINY_TTV_CASCADE
