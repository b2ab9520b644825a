"""The ported configs of the paper's suite (``repro.configs.suite``): the
eight models of Table I plus the LLaMA2 baseline."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import register
from repro_torch.configs.base import LMConfig
from repro_torch.models.ar_image import ARImageConfig
from repro_torch.models.diffusion import DiffusionConfig, SRStage
from repro_torch.models.text_encoder import TextEncoderConfig
from repro_torch.models.ttv import PhenakiConfig, TTVConfig
from repro_torch.models.unet import UNetConfig
from repro_torch.models.vae import DecoderConfig, VQDecoderConfig

# LLaMA2-7B, the text-generation baseline the paper compares against
LLAMA2_7B = LMConfig(
    name="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=32000,
    norm="rmsnorm",
    mlp_activation="silu",
    mlp_gated=True,
    dtype=torch.float32,
    source="[arXiv:2307.09288; hf:meta-llama/Llama-2-7b]",
)
register(LLAMA2_7B)

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

# Imagen (pixel; Table I: 3B, attn res [32,16,8], mult [1,2,4,4], 3 res
# blocks, per-head channels 64, text embed 512) + 2 SR stages, the
# reference's 64 -> 256 -> 1024 cascade.
IMAGEN = DiffusionConfig(
    name="imagen",
    kind="pixel",
    image_size=64,
    latent_down=1,
    unet=UNetConfig(
        in_channels=3, out_channels=3, model_channels=512,
        channel_mult=(1, 2, 4, 4), num_res_blocks=3, attn_levels=(1, 2, 3),
        cross_attn=True, context_dim=512, head_channels=64,
    ),
    text=TextEncoderConfig(vocab=32128, max_len=128, n_layers=24, d_model=512,
                           n_heads=8, d_ff=2048),
    vae=None,
    sr_stages=(
        SRStage(
            out_size=256,
            unet=UNetConfig(
                in_channels=6, out_channels=3, model_channels=128,
                channel_mult=(1, 2, 4, 8), num_res_blocks=2, attn_levels=(3,),
                cross_attn=True, context_dim=512, head_channels=64,
            ),
            steps=20,
        ),
        SRStage(
            out_size=1024,
            unet=UNetConfig(
                in_channels=6, out_channels=3, model_channels=64,
                channel_mult=(1, 2, 4, 8), num_res_blocks=2,
                # no per-level attention; the mid block still attends, over
                # the 128x128 = 16384 tokens of the lowest level
                attn_levels=(),
                cross_attn=False, context_dim=512, head_channels=64,
            ),
            steps=20,
        ),
    ),
    denoise_steps=64,
    source="[arXiv:2205.11487 / paper Table I]",
)
register(IMAGEN)

# Prod-Image: the paper's production latent-diffusion TTI (higher-res
# latents, a bigger text stack)
PROD_IMAGE = DiffusionConfig(
    name="prod-image",
    kind="latent",
    image_size=768,
    latent_down=8,
    unet=UNetConfig(
        in_channels=8, out_channels=8, model_channels=384,
        channel_mult=(1, 2, 4, 4), num_res_blocks=2, attn_levels=(0, 1, 2),
        cross_attn=True, context_dim=1024, head_channels=64, n_heads=8,
    ),
    text=TextEncoderConfig(vocab=49408, max_len=77, n_layers=24, d_model=1024,
                           n_heads=16, d_ff=4096),
    vae=DecoderConfig(latent_channels=8, base_channels=128,
                      channel_mult=(1, 2, 4, 4), num_res_blocks=2),
    denoise_steps=50,
    source="[production-representative latent TTI; paper §III]",
)
register(PROD_IMAGE)

# Muse (Table I: 3B, 48 layers, model dim 2048, parallel decoding)
MUSE = ARImageConfig(
    name="muse",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    d_ff=8192,
    image_vocab=8192,
    image_tokens=256,  # 16x16 base grid
    decode="parallel",
    parallel_steps=12,
    text=TextEncoderConfig(vocab=32128, max_len=77, n_layers=24, d_model=1024,
                           n_heads=16, d_ff=4096),
    vq=VQDecoderConfig(codebook_size=8192, token_hw=16, embed_dim=256),
    source="[arXiv:2301.00704 / paper Table I]",
)
register(MUSE)

# Parti (Table I: 20B, 80 layers, model dim 4096, autoregressive)
PARTI = ARImageConfig(
    name="parti",
    n_layers=80,
    d_model=4096,
    n_heads=32,
    d_ff=16384,
    image_vocab=8192,
    image_tokens=1024,  # 32x32 ViT-VQGAN grid
    decode="ar",
    text=TextEncoderConfig(vocab=32128, max_len=128, n_layers=24, d_model=1024,
                           n_heads=16, d_ff=4096),
    vq=VQDecoderConfig(codebook_size=8192, token_hw=32, embed_dim=256),
    source="[arXiv:2206.10789 / paper Table I]",
)
register(PARTI)

# Make-A-Video (diffusion TTV: SD-like UNet + temporal attn/conv, 16 frames)
MAKE_A_VIDEO = TTVConfig(
    name="make-a-video",
    unet=UNetConfig(
        in_channels=4, out_channels=4, model_channels=320,
        # attention at ds 32/16/8 (levels 1-3), Imagen-style 64px decoder --
        # the 64x64 level is conv-only (memory), per the MAV/DALLE2 lineage
        channel_mult=(1, 2, 4, 4), num_res_blocks=2, attn_levels=(1, 2, 3),
        cross_attn=True, context_dim=768, head_channels=64, n_heads=8,
    ),
    text=TextEncoderConfig(vocab=49408, max_len=77, n_layers=12, d_model=768,
                           n_heads=12, d_ff=3072),
    frames=16,
    image_size=64,
    denoise_steps=50,
    temporal_head_channels=64,
    source="[arXiv:2209.14792]",
)
register(MAKE_A_VIDEO)

# Phenaki (transformer TTV over C-ViViT tokens, parallel decode)
PHENAKI = PhenakiConfig(
    name="phenaki",
    n_layers=20,
    d_model=1536,
    n_heads=24,
    d_ff=6144,
    video_vocab=8192,
    frames=11,
    tokens_per_frame=256,
    parallel_steps=24,
    text=TextEncoderConfig(vocab=32128, max_len=77, n_layers=12, d_model=768,
                           n_heads=12, d_ff=3072),
    source="[arXiv:2210.02399]",
)
register(PHENAKI)


def with_dtype(cfg, dtype):
    """``cfg`` with every ``dtype`` field of its dataclass tree replaced
    (``repro.configs.suite.with_dtype``): serving runs in bf16, and Parti's
    87.6 GB of fp32 weights fit one 80 GB card only so (43.8 GB)."""
    if not dataclasses.is_dataclass(cfg):
        return cfg
    changes = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "dtype":
            changes[f.name] = dtype
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            changes[f.name] = with_dtype(v, dtype)
        elif isinstance(v, tuple) and v and dataclasses.is_dataclass(v[0]):
            changes[f.name] = tuple(with_dtype(x, dtype) for x in v)
    return dataclasses.replace(cfg, **changes) if changes else cfg


# the paper's eight-model suite, in the reference's order
SUITE = [
    "llama2-7b",
    "imagen",
    "stable-diffusion",
    "muse",
    "parti",
    "prod-image",
    "make-a-video",
    "phenaki",
]


def reduced_suite_config(cfg):
    """Tiny same-structure suite config for the CPU (the workload's own
    reduction rules, ``GenerativeWorkload.reduced``)."""
    from repro_torch.workload import workload_for

    return workload_for(cfg).reduced()


def build_suite_model(cfg):
    """Config -> model instance, its parameters on ``meta`` (the workload
    registry's ``build_model``)."""
    from repro_torch.workload import workload_for

    return workload_for(cfg).model
