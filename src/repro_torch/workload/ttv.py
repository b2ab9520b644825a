"""Text-to-video workloads, the port of ``repro.workload.ttv``.

Make-A-Video is a factorized sampler over one DDIM schedule:
``keyframe_denoise`` runs the first half spatial-only (frames folded into the
batch, no temporal layers), ``temporal_denoise`` resumes the schedule with
the VideoUNet.  Phenaki parallel-decodes a constant-length (frames x tokens)
grid, like Muse.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.diffusion import ddim_range
from repro_torch.models.ttv import MakeAVideoPipeline, PhenakiConfig, PhenakiModel, TTVConfig
from repro_torch.workload.base import (
    CostDescriptor,
    GenerativeWorkload,
    Stage,
    register_workload,
    stage_noise,
)
from repro_torch.workload.diffusion import REDUCED_TEXT, unet_demand


@register_workload(TTVConfig)
class MakeAVideoWorkload(GenerativeWorkload):
    route = "pod"
    modality = "video"

    def build_model(self, cfg: TTVConfig) -> MakeAVideoPipeline:
        return MakeAVideoPipeline(cfg)

    def reduced(self) -> TTVConfig:
        cfg = self.cfg
        return dataclasses.replace(
            cfg, name=cfg.name + "-reduced",
            unet=dataclasses.replace(
                cfg.unet, model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                attn_levels=(0,), context_dim=64, head_channels=8, groups=8),
            text=REDUCED_TEXT, frames=4, image_size=16, denoise_steps=2,
            temporal_head_channels=8)

    # Temporal attention and conv add one q/k/v/out round trip over the
    # spatial activations at every attention site: a flat traffic factor on
    # the temporal stage's demand profile, as in the reference.
    TEMPORAL_TRAFFIC = 1.5

    def _denoise_split(self) -> tuple[int, int]:
        """(keyframe, temporal) step counts: the first half of the schedule
        spatial-only, the rest with the temporal layers.  A 1-step schedule
        runs as one temporal stage."""
        steps = self.cfg.denoise_steps
        if steps < 2:
            return 0, steps
        kf = steps // 2
        return kf, steps - kf

    def cost_descriptor(self) -> CostDescriptor:
        cfg = self.cfg
        hw = cfg.image_size // cfg.latent_down
        # frames fold into the batch of the spatial UNet: demand scales by F
        spatial = tuple(d * cfg.frames for d in unet_demand(hw, cfg.unet))
        temporal = tuple(d * self.TEMPORAL_TRAFFIC for d in spatial)
        kf, tp = self._denoise_split()
        stages = [Stage("text_encoder", 1, cfg.text.max_len)]
        if kf:
            stages.append(Stage("keyframe_denoise", kf, cfg.frames * hw * hw, demand=spatial))
        stages.append(Stage("temporal_denoise", tp, cfg.frames * hw * hw, demand=temporal))
        return CostDescriptor(arch=cfg.name, route=self.route, stages=tuple(stages))

    def run_stage(self, params, stage, state, gens, *, impl="auto"):
        cfg = self.cfg
        if stage.name == "text_encoder":
            return {"ctx": params.encode_text(state["tokens"], impl=impl)}
        kf, tp = self._denoise_split()
        total = kf + tp
        ctx = state["ctx"]
        hw = cfg.image_size // cfg.latent_down

        def initial_noise():
            # per-request noise from the (seed, rid, stage) contract
            return stage_noise(gens, (cfg.frames, hw, hw, cfg.unet.in_channels), cfg.dtype,
                               ctx.device)

        if stage.name == "keyframe_denoise":
            ctx_frames = ctx.repeat_interleave(cfg.frames, dim=0)

            def spatial_eps(z, t):
                # frames folded into the batch; temporal layers inactive
                Bz, F, H, W, C = z.shape
                tb = torch.full((Bz * F,), float(t), dtype=torch.float32, device=z.device)
                eps = params.vunet.unet(z.reshape(Bz * F, H, W, C), tb, ctx_frames, impl=impl)
                return eps.reshape(Bz, F, H, W, C)

            return {"ctx": ctx, "z": ddim_range(spatial_eps, initial_noise(), total, 0, kf)}
        if stage.name == "temporal_denoise":
            z = state["z"] if kf else initial_noise()

            def video_eps(z, t):
                tb = torch.full((z.shape[0],), float(t), dtype=torch.float32, device=z.device)
                return params.vunet(z, tb, ctx, impl=impl)

            return {"out": ddim_range(video_eps, z, total, kf, total)}
        raise ValueError(f"unknown TTV stage {stage.name!r}")


@register_workload(PhenakiConfig)
class PhenakiWorkload(GenerativeWorkload):
    route = "pod"
    modality = "video"

    def build_model(self, cfg: PhenakiConfig) -> PhenakiModel:
        return PhenakiModel(cfg)

    def reduced(self) -> PhenakiConfig:
        cfg = self.cfg
        return dataclasses.replace(
            cfg, name=cfg.name + "-reduced", n_layers=2, d_model=64, n_heads=4, d_ff=128,
            video_vocab=128, frames=3, tokens_per_frame=16, parallel_steps=3, text=REDUCED_TEXT)

    def cost_descriptor(self) -> CostDescriptor:
        cfg = self.cfg
        S = cfg.frames * cfg.tokens_per_frame
        return CostDescriptor(arch=cfg.name, route=self.route, stages=(
            Stage("text_encoder", 1, cfg.text.max_len),
            Stage("parallel_decode", cfg.parallel_steps, S, demand=(S,))))

    def run_stage(self, params, stage, state, gens, *, impl="auto"):
        del gens  # confidence-ranked unmasking draws nothing
        if stage.name == "text_encoder":
            return {"ctx": params.encode_text(state["tokens"], impl=impl)}
        if stage.name == "parallel_decode":
            return {"out": params.decode_tokens(state["ctx"], stage.steps, impl=impl)}
        raise ValueError(f"unknown Phenaki stage {stage.name!r}")
