"""Transformer text-to-image workloads (Muse parallel decode, Parti
autoregressive decode), the port of ``repro.workload.ar_image``.

Muse's constant-length unmasking steps give a flat demand profile; Parti's
decode grows its KV cache by one token a step (Fig. 7, Parti panel), so its
demand is a linear ramp.  Characterization reproduces the paper's method,
as the reference's: the parallel decode traces one step scaled by the step
count (``GenerativeWorkload.trace_events``); the autoregressive decode
traces steps at 8 sampled cache lengths, each scaled to its share.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import characterize, tracer
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

    def trace_events(self, impl: str = "auto") -> list:
        """Muse: ``generate`` traced.  Parti: the text encoder and the VQ-GAN
        once, plus decode steps against caches of ``max(1, i * S // 8)``
        rows for i < 8, each scaled by ``S // 8`` and renamed
        ``ar_decode/...``; each part under its stage's name."""
        cfg = self.cfg
        if cfg.decode == "parallel":
            return super().trace_events(impl)
        model = characterize.abstract_params(self.model)
        (toks,) = self.trace_inputs()

        def text(p, t):
            with tracer.scope("text_encoder"):
                p.text(t, impl=impl)

        def vq(p, t):
            with tracer.scope("vq_decoder"):
                p.vq(t, impl=impl)

        ev = characterize.trace_workload(text, model, toks)
        S = cfg.image_tokens
        sample_points = 8
        for i in range(sample_points):
            cur = max(1, (i * S) // sample_points)
            step_ev = [dataclasses.replace(e, name=f"ar_decode/{e.name}")
                       for e in self._ar_step_events(model, cur)]
            ev += tracer.scale_events(step_ev, S // sample_points)
        img_tokens = torch.empty((1, S), dtype=torch.int64, device="meta")
        return ev + characterize.trace_workload(vq, model, img_tokens)

    def _ar_step_events(self, model, cur: int) -> list:
        """One decode step against caches of ``cur`` rows, on ``meta``: each
        layer's cross keys and values projected from a (1, L, d_model)
        context, then its decode at position ``cur - 1``, as the
        reference's recipe (its events carry no layer scope)."""
        cfg = self.cfg

        def step(p, tok, ctx):
            x = p.embed(tok)
            x = x + p.pos[cur - 1: cur].to(x.dtype)[None]
            for block in p.blocks():
                cache = {"attn": block.attn.init_cache(1, cur, dtype=cfg.dtype)}
                x, _ = block.decode(x, cache, cur - 1,
                                    cross_cache=block.cross_attn.project_kv(ctx))
            return p.head(p.final_ln(x))

        tok = torch.empty((1, 1), dtype=torch.int64, device="meta")
        ctx = torch.empty((1, cfg.text.max_len, cfg.d_model), dtype=cfg.dtype, device="meta")
        return characterize.trace_workload(step, model, tok, ctx)
