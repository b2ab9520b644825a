"""Diffusion TTI workload (Stable Diffusion), the port of
``repro.workload.diffusion``: text encoder -> base-UNet denoise loop -> VAE
decode.  The per-tick ``demand`` profile and the pixel ``sr*`` stages come
with the serving and SR-cascade slices."""

from __future__ import annotations

import dataclasses

from repro_torch.models.diffusion import DiffusionConfig, DiffusionPipeline
from repro_torch.models.text_encoder import TextEncoderConfig
from repro_torch.workload.base import (
    CostDescriptor,
    GenerativeWorkload,
    Stage,
    register_workload,
    stage_noise,
)

REDUCED_TEXT = TextEncoderConfig(vocab=512, max_len=16, n_layers=2, d_model=64,
                                 n_heads=4, d_ff=128)


@register_workload(DiffusionConfig)
class DiffusionWorkload(GenerativeWorkload):
    route = "pod"
    modality = "image"

    def build_model(self, cfg: DiffusionConfig) -> DiffusionPipeline:
        return DiffusionPipeline(cfg)

    def reduced(self) -> DiffusionConfig:
        """Tiny same-structure config (``repro.workload.diffusion`` ``reduced``;
        its SR-stage cut comes with the SR slice)."""
        cfg = self.cfg
        small_unet = dataclasses.replace(
            cfg.unet, model_channels=32, channel_mult=cfg.unet.channel_mult[:3] or (1, 2),
            num_res_blocks=1, attn_levels=(0, 1), context_dim=64, head_channels=8,
            groups=8)
        vae = None
        if cfg.vae is not None:
            vae = dataclasses.replace(cfg.vae, base_channels=16, channel_mult=(1, 2),
                                      num_res_blocks=1, groups=8)
        return dataclasses.replace(
            cfg, name=cfg.name + "-reduced",
            image_size=32 if cfg.kind == "latent" else 16,
            latent_down=8 if cfg.kind == "latent" else 1,
            unet=small_unet, text=REDUCED_TEXT, vae=vae, denoise_steps=3)

    def cost_descriptor(self) -> CostDescriptor:
        cfg = self.cfg
        stages = [Stage("text_encoder", 1, cfg.text.max_len),
                  Stage("denoise", cfg.denoise_steps, cfg.latent_size ** 2)]
        if cfg.vae is not None:
            stages.append(Stage("vae", 1, cfg.image_size ** 2))
        return CostDescriptor(arch=cfg.name, route=self.route, stages=tuple(stages))

    def run_stage(self, params, stage, state, gens, *, impl="auto"):
        cfg = self.cfg
        if stage.name == "text_encoder":
            return {"ctx": params.encode_text(state["tokens"], impl=impl)}
        if stage.name == "denoise":
            ctx = state["ctx"]
            hw = cfg.latent_size
            # per-request noise from the (seed, rid, stage) contract
            z = stage_noise(gens, (hw, hw, cfg.unet.in_channels), cfg.unet.dtype, ctx.device)
            z = params.denoise_loop(params.unet, z, ctx, stage.steps, impl=impl)
            return {"z": z} if cfg.vae is not None else {"out": z}
        if stage.name == "vae":
            return {"out": params.vae(state["z"], impl=impl)}
        raise ValueError(f"unknown diffusion stage {stage.name!r}")
