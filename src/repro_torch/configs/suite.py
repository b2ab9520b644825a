"""The ported configs of the paper's suite (``repro.configs.suite``)."""

from __future__ import annotations

from repro_torch.configs import register
from repro_torch.models.diffusion import DiffusionConfig
from repro_torch.models.text_encoder import TextEncoderConfig
from repro_torch.models.unet import UNetConfig
from repro_torch.models.vae import DecoderConfig

# Stable Diffusion (latent; Table I: 1.45B, attn res [4,2,1], mult [1,2,4,4],
# 2 res blocks, 8 heads, embed dim 768)
STABLE_DIFFUSION = DiffusionConfig(
    name="stable-diffusion",
    kind="latent",
    image_size=512,
    latent_down=8,
    unet=UNetConfig(
        in_channels=4, out_channels=4, model_channels=320,
        channel_mult=(1, 2, 4, 4), num_res_blocks=2, attn_levels=(0, 1, 2),
        cross_attn=True, context_dim=768, head_channels=8, n_heads=8,
    ),
    text=TextEncoderConfig(vocab=49408, max_len=77, n_layers=12, d_model=768,
                           n_heads=12, d_ff=3072),
    vae=DecoderConfig(latent_channels=4, base_channels=128,
                      channel_mult=(1, 2, 4, 4), num_res_blocks=2),
    denoise_steps=50,
    source="[arXiv:2112.10752 / paper Table I]",
)
register(STABLE_DIFFUSION)
