"""Make-A-Video text-to-video model, the port of ``repro.models.ttv``.

A diffusion VideoUNet: the spatial UNet runs with frames folded into the
batch, and temporal attention + temporal conv layers run after every
spatial attention block (paper Fig. 3/10).  Temporal attention attends
across frames: sequence length F, batch B * H * W.  Inference only; the
training loss and Phenaki come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.models.layers.basic import Dense
from repro_torch.models.layers.conv import TemporalConv1D
from repro_torch.models.layers.norms import LayerNorm
from repro_torch.models.text_encoder import TextEncoder, TextEncoderConfig
from repro_torch.models.unet import UNet2D, UNetConfig, unet_plan
from repro_torch.nn import Module


class TemporalAttention(Module):
    """Attention across the frame axis of (B, F, H, W, C) tensors, with a
    residual: ``x + out(attn(ln(x)))``.  The ``kernel`` tier reads the
    (B, F, HW, heads, head_dim) projections in place; ``torch`` permutes."""

    def __init__(self, channels: int, head_channels: int = 64, dtype=torch.float32):
        super().__init__()
        self.n_heads = max(1, channels // head_channels)
        self.head_channels = head_channels
        inner = self.n_heads * head_channels
        self.ln = LayerNorm(channels, dtype=dtype)
        self.wq = Dense(channels, inner, True, dtype)
        self.wk = Dense(channels, inner, True, dtype)
        self.wv = Dense(channels, inner, True, dtype)
        self.out = Dense(inner, channels, True, dtype)

    def forward(self, x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        B, F, H, W, C = x.shape
        hx = self.ln(x).reshape(B, F, H * W, C)
        nh, hd = self.n_heads, self.head_channels

        def heads(proj):
            return proj(hx).reshape(B, F, H * W, nh, hd)

        out = attn_ops.temporal_attention(heads(self.wq), heads(self.wk), heads(self.wv),
                                          impl=impl)
        y = self.out(out.reshape(B, F, H * W, nh * hd)).reshape(B, F, H, W, C)
        return x + y


@dataclasses.dataclass(frozen=True)
class TTVConfig:
    name: str
    unet: UNetConfig
    text: TextEncoderConfig
    frames: int = 16
    image_size: int = 64
    latent_down: int = 1
    denoise_steps: int = 50
    temporal_head_channels: int = 64
    family: str = "ttv_diffusion"
    dtype: Any = torch.float32
    source: str = ""


def attention_sites(cfg: UNetConfig) -> list[tuple[str, int]]:
    """(block name, channels) of every spatial attention block, in the
    reference's order: down, mid, up."""
    plan = unet_plan(cfg)

    def named(prefix, blocks):
        return [(f"{prefix}_{bi}_{kind}", co)
                for bi, (kind, _, co) in enumerate(blocks) if kind == "attn"]

    sites = [s for si, blocks in enumerate(plan["down"]) for s in named(f"down_{si}", blocks)]
    sites += named("mid", plan["mid"])
    sites += [s for si, blocks in enumerate(plan["up"]) for s in named(f"up_{si}", blocks)]
    return sites


class VideoUNet(Module):
    """UNet2D with temporal attention + temporal conv after each spatial
    attention block.  The temporal layers are registered as
    ``tattn/<block>`` and ``tconv/<block>``, the JAX tree's keys."""

    def __init__(self, cfg: TTVConfig):
        super().__init__()
        self.cfg = cfg
        self.unet = UNet2D(cfg.unet)
        self.attn_sites = attention_sites(cfg.unet)
        for name, ch in self.attn_sites:
            self.add_module(f"tattn/{name}",
                            TemporalAttention(ch, cfg.temporal_head_channels, cfg.dtype))
            self.add_module(f"tconv/{name}", TemporalConv1D(ch, 3, cfg.dtype))

    def forward(self, x, t, context, *, impl="auto"):
        """x: (B, F, H, W, C) video; t: (B,); context: (B, L, ctx)."""
        B, F, H, W, C = x.shape

        def temporal_hook(name, h, frames):
            bh, hh, wh, ch = h.shape
            hv = h.reshape(bh // frames, frames, hh, wh, ch)
            hv = getattr(self, f"tattn/{name}")(hv, impl=impl)
            hv = hv + getattr(self, f"tconv/{name}")(hv, impl=impl)
            return hv.reshape(bh, hh, wh, ch)

        # jnp.repeat(t, F): each element F times in place
        out = self.unet(x.reshape(B * F, H, W, C), t.repeat_interleave(F),
                        context.repeat_interleave(F, dim=0), impl=impl,
                        temporal_hook=temporal_hook, frames=F)
        return out.reshape(B, F, H, W, -1)


class MakeAVideoPipeline(Module):
    """Text -> 16-frame video; parameter tree ``{"text", "vunet"}``.
    Inference is driven by ``MakeAVideoWorkload.run_stage`` only."""

    def __init__(self, cfg: TTVConfig):
        super().__init__()
        self.cfg = cfg
        self.text = TextEncoder(cfg.text)
        self.vunet = VideoUNet(cfg)

    def encode_text(self, tokens, *, impl="auto"):
        return self.text(tokens, impl=impl)
