"""Diffusion TTI workloads (Stable Diffusion / Imagen / Prod-Image), the port
of ``repro.workload.diffusion``.

Stage structure: text encoder -> base-UNet denoise loop -> (latent) VAE
decode or (pixel) SR-UNet cascade.  The denoise and SR stages carry the
UNet's per-tick HBM-demand profile (``unet_demand``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.analytical import unet_block_profile
from repro_torch.models.diffusion import DiffusionConfig, DiffusionPipeline, SRStage
from repro_torch.models.text_encoder import TextEncoderConfig
from repro_torch.parallel.mesh_exec import run_stage_on_mesh
from repro_torch.workload.base import (
    CostDescriptor,
    GenerativeWorkload,
    Stage,
    register_workload,
    stage_noise,
)

REDUCED_TEXT = TextEncoderConfig(vocab=512, max_len=16, n_layers=2, d_model=64,
                                 n_heads=4, d_ff=128)


def unet_demand(latent_hw: int, unet_cfg) -> tuple:
    """Per-tick relative HBM demand over one UNet pass (the U-shape): every
    block reads and writes its ``hw^2 x channels`` activations, and an
    attention level pays one more activation round trip."""
    return tuple(unet_block_profile(
        latent_hw, unet_cfg.channel_mult, unet_cfg.num_res_blocks, unet_cfg.attn_levels,
        lambda hw, mult, attn: hw * hw * mult * (2.0 if attn else 1.0)))


def upsample_bilinear(img: torch.Tensor, size: int) -> torch.Tensor:
    """NHWC bilinear resize to ``size`` x ``size`` with half-pixel centres and
    no antialias (``jax.image.resize(..., "bilinear")`` when upsampling)."""
    up = F.interpolate(img.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                       align_corners=False, antialias=False)
    return up.permute(0, 2, 3, 1)


@register_workload(DiffusionConfig)
class DiffusionWorkload(GenerativeWorkload):
    route = "pod"
    modality = "image"

    def build_model(self, cfg: DiffusionConfig) -> DiffusionPipeline:
        return DiffusionPipeline(cfg)

    def reduced(self) -> DiffusionConfig:
        """Tiny same-structure config (``repro.workload.diffusion``
        ``reduced``): one SR stage at most, whose ``out_size`` reads the full
        config's image size, as the reference's does."""
        cfg = self.cfg
        small_unet = dataclasses.replace(
            cfg.unet, model_channels=32, channel_mult=cfg.unet.channel_mult[:3] or (1, 2),
            num_res_blocks=1, attn_levels=(0, 1), context_dim=64, head_channels=8,
            groups=8)
        sr = tuple(
            SRStage(out_size=cfg.image_size // 2 * 4,
                    unet=dataclasses.replace(
                        s.unet, model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
                        attn_levels=(), context_dim=64, groups=8),
                    steps=2)
            for s in cfg.sr_stages[:1])
        vae = None
        if cfg.vae is not None:
            vae = dataclasses.replace(cfg.vae, base_channels=16, channel_mult=(1, 2),
                                      num_res_blocks=1, groups=8)
        return dataclasses.replace(
            cfg, name=cfg.name + "-reduced",
            image_size=32 if cfg.kind == "latent" else 16,
            latent_down=8 if cfg.kind == "latent" else 1,
            unet=small_unet, text=REDUCED_TEXT, vae=vae, sr_stages=sr, denoise_steps=3)

    def cost_descriptor(self) -> CostDescriptor:
        cfg = self.cfg
        stages = [Stage("text_encoder", 1, cfg.text.max_len),
                  Stage("denoise", cfg.denoise_steps, cfg.latent_size ** 2,
                        demand=unet_demand(cfg.latent_size, cfg.unet))]
        for i, s in enumerate(cfg.sr_stages):
            stages.append(Stage(f"sr{i}", s.steps, s.out_size ** 2,
                                demand=unet_demand(s.out_size, s.unet)))
        if cfg.vae is not None:
            stages.append(Stage("vae", 1, cfg.image_size ** 2))
        return CostDescriptor(arch=cfg.name, route=self.route, stages=tuple(stages))

    def run_stage(self, params, stage, state, gens, *, impl="auto", temperature=0.0, mesh=None):
        if mesh is not None:
            return run_stage_on_mesh(self, params, stage, state, gens, impl=impl,
                                     temperature=temperature, mesh=mesh)
        del temperature  # denoising samples no tokens
        cfg = self.cfg
        if stage.name == "text_encoder":
            return {"ctx": params.encode_text(state["tokens"], impl=impl)}
        if stage.name == "denoise":
            ctx = state["ctx"]
            hw = cfg.latent_size
            # per-request noise from the (seed, rid, stage) contract
            z = stage_noise(gens, (hw, hw, cfg.unet.in_channels), cfg.unet.dtype, ctx.device)
            z = params.denoise_loop(params.unet, z, ctx, stage.steps, impl=impl)
            if cfg.kind == "latent":
                return {"z": z} if cfg.vae is not None else {"out": z}
            return {"ctx": ctx, "img": z}
        if stage.name.startswith("sr"):
            i = int(stage.name[2:])
            s = cfg.sr_stages[i]
            img, ctx = state["img"], state["ctx"]
            up = upsample_bilinear(img, s.out_size)
            noise = stage_noise(gens, (s.out_size, s.out_size, 3), img.dtype, img.device)
            img = params.denoise_loop(params.sr_unets[i], noise, ctx, s.steps, cond=up,
                                      impl=impl)
            last = i == len(cfg.sr_stages) - 1
            return {"out": img} if last else {"ctx": ctx, "img": img}
        if stage.name == "vae":
            return {"out": params.vae(state["z"], impl=impl)}
        raise ValueError(f"unknown diffusion stage {stage.name!r}")

    def stage_output(self, state: dict):
        for k in ("out", "img", "z"):
            if k in state:
                return state[k]
        raise KeyError("no output in cascade state")
