"""Convolutional VAE decoder (latent -> pixels), the port of
``repro.models.vae.ConvDecoder``.  The VQ-GAN decoder comes with the
transformer TTI slice."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.models.layers.conv import Conv2D, fused_gn_producer
from repro_torch.models.layers.norms import GroupNorm
from repro_torch.models.unet import ResBlock, Upsample
from repro_torch.nn import Module


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    latent_channels: int = 4
    out_channels: int = 3
    base_channels: int = 128
    channel_mult: tuple = (1, 2, 4, 4)  # deepest first when decoding
    num_res_blocks: int = 2
    groups: int = 32
    dtype: Any = torch.float32


def decoder_plan(cfg: DecoderConfig) -> list:
    """[(name, c_in, c_out)] from the latent to the image."""
    mults = list(reversed(cfg.channel_mult))
    c_cur = cfg.base_channels * mults[0]
    blocks = [("conv_in", cfg.latent_channels, c_cur)]
    for li, m in enumerate(mults):
        c_out = cfg.base_channels * m
        for i in range(cfg.num_res_blocks):
            blocks.append((f"res_{li}_{i}", c_cur, c_out))
            c_cur = c_out
        if li != len(mults) - 1:
            blocks.append((f"up_{li}", c_cur, c_cur))
    blocks.append(("out", c_cur, cfg.out_channels))
    return blocks


class ConvDecoder(Module):
    """Latent (B, h, w, C_lat) -> image (B, h*2^(L-1), w*2^(L-1), 3)."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.plan = decoder_plan(cfg)
        for name, ci, co in self.plan:
            if name.startswith("res"):
                # decoders have no time conditioning: a ResBlock with temb = 0
                mod = ResBlock(ci, co, 4, cfg.groups, cfg.dtype)
            elif name.startswith("up"):
                mod = Upsample(co, cfg.dtype)
            else:
                mod = Conv2D(ci, co, 3, dtype=cfg.dtype)
            self.add_module(name, mod)
        c_last = self.plan[-1][1]
        self.gn_out = GroupNorm(c_last, min(cfg.groups, c_last), fuse_silu=True,
                                dtype=cfg.dtype)

    def forward(self, z, *, impl="auto"):
        temb = torch.zeros((z.shape[0], 4), dtype=z.dtype, device=z.device)
        h = z
        for name, _, _ in self.plan:
            mod = getattr(self, name)
            if name.startswith("res"):
                h = mod(h, temb, impl=impl)
            elif name == "out":
                if conv_ops.is_fused(impl):
                    a, b = fused_gn_producer(h, self.gn_out, groups=self.gn_out.groups)
                    h = mod(h, impl=impl, gn_affine=(a, b))
                else:
                    h = mod(self.gn_out(h, impl=impl), impl=impl)
            else:
                h = mod(h, impl=impl)
        return h
