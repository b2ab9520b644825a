"""Transformer text-to-image workloads (Muse parallel decode, Parti
autoregressive decode), the port of ``repro.workload.ar_image``.

Muse's constant-length unmasking steps give a flat demand profile; Parti's
decode grows its KV cache by one token a step (Fig. 7, Parti panel), so its
demand is a linear ramp.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.ar_image import ARImageConfig, ARImageModel
from repro_torch.models.vae import DecoderConfig, VQDecoderConfig
from repro_torch.workload.base import CostDescriptor, GenerativeWorkload, Stage, register_workload
from repro_torch.workload.diffusion import REDUCED_TEXT


@register_workload(ARImageConfig)
class ARImageWorkload(GenerativeWorkload):
    route = "pod"
    modality = "image"

    def build_model(self, cfg: ARImageConfig) -> ARImageModel:
        return ARImageModel(cfg)

    def reduced(self) -> ARImageConfig:
        cfg = self.cfg
        return dataclasses.replace(
            cfg, name=cfg.name + "-reduced", n_layers=2, d_model=64, n_heads=4, d_ff=128,
            image_vocab=128, image_tokens=16, parallel_steps=3, text=REDUCED_TEXT,
            vq=VQDecoderConfig(
                codebook_size=128, token_hw=4, embed_dim=32,
                decoder=DecoderConfig(latent_channels=32, base_channels=16, channel_mult=(1, 2),
                                      num_res_blocks=1, groups=8)))

    def cost_descriptor(self) -> CostDescriptor:
        cfg = self.cfg
        S = cfg.image_tokens
        if cfg.decode == "parallel":
            decode = Stage("parallel_decode", cfg.parallel_steps, S,
                           demand=(S,))  # constant length (Fig. 7 Muse)
        else:
            decode = Stage("ar_decode", S, S, demand=tuple(range(1, S + 1)))  # KV growth
        return CostDescriptor(arch=cfg.name, route=self.route, stages=(
            Stage("text_encoder", 1, cfg.text.max_len), decode,
            Stage("vq_decoder", 1, cfg.vq.token_hw ** 2)))

    def run_stage(self, params, stage, state, gens, *, impl="auto", temperature=0.0):
        del gens, temperature  # greedy and confidence-ranked decoding draw nothing
        if stage.name == "text_encoder":
            return {"ctx": params.encode_text(state["tokens"], impl=impl)}
        if stage.name == "parallel_decode":
            return {"img_tokens": params.decode_parallel(state["ctx"], stage.steps, impl=impl)}
        if stage.name == "ar_decode":
            return {"img_tokens": params.decode_ar(state["ctx"], stage.steps)}
        if stage.name == "vq_decoder":
            return {"out": params.vq(state["img_tokens"], impl=impl)}
        raise ValueError(f"unknown AR-image stage {stage.name!r}")
