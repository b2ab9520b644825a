"""Diffusion UNet (SD / Imagen style), the port of ``repro.models.unet``.

Alternating ResNet blocks (GroupNorm -> SiLU -> Conv3x3, time-embedding
injection) and attention blocks (spatial self-attention over HW tokens +
cross-attention to the text encoding) across a downsample/upsample pyramid.
Layout is NHWC throughout.  Sub-layers are registered under the reference
``defs()`` keys, so the state dict is the JAX tree's flattened paths, and
carry the reference's names, so their tracer events do too; each block runs
under ``tracer.scope(<block key>)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core import tracer
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.models.layers.attention import Attention
from repro_torch.models.layers.basic import Dense, sinusoidal_embedding
from repro_torch.models.layers.conv import Conv2D, fused_gn_producer
from repro_torch.models.layers.norms import GroupNorm, LayerNorm
from repro_torch.nn import Module
from repro_torch.parallel.sharding import concat_unsharded


def _record_pointwise(name, x, reads=1):
    """A standalone elementwise op (an unfused epilogue): reads + one write."""
    if not tracer.active():
        return
    n = tracer.numel(x.shape)
    tracer.record("pointwise", name, flops=float(n),
                  bytes_hbm=(reads + 1) * n * tracer.dtype_bytes(x.dtype))


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: tuple = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_levels: tuple = (0, 1, 2)  # pyramid levels with attention blocks
    cross_attn: bool = True
    context_dim: int = 768
    head_channels: int = 8  # per-head channels
    n_heads: int = 0  # if set, fixed head count (SD-style: head_dim = C/heads)
    tf_depth: int = 1
    groups: int = 32
    dtype: Any = torch.float32

    @property
    def temb_dim(self):
        return self.model_channels * 4


class ResBlock(Module):
    def __init__(self, c_in: int, c_out: int, temb_dim: int, groups: int = 32,
                 dtype=torch.float32):
        super().__init__()
        self.c_in, self.c_out = c_in, c_out
        self.g1, self.g2 = min(groups, c_in), min(groups, c_out)
        self.gn1 = GroupNorm(c_in, self.g1, fuse_silu=True, dtype=dtype, name="gn1")
        self.conv1 = Conv2D(c_in, c_out, 3, dtype=dtype, name="conv1")
        self.temb = Dense(temb_dim, c_out, True, dtype, name="temb_proj", axes=(None, "conv_out"))
        self.gn2 = GroupNorm(c_out, self.g2, fuse_silu=True, dtype=dtype, name="gn2")
        self.conv2 = Conv2D(c_out, c_out, 3, dtype=dtype, name="conv2")
        if c_in != c_out:
            self.skip = Conv2D(c_in, c_out, 1, dtype=dtype, name="skip")

    def forward(self, x, temb, *, impl="auto"):
        t = self.temb(F.silu(temb))
        if conv_ops.is_fused(impl):
            # gn1 -> conv1 -> (+temb) -> gn2 -> conv2 -> (+skip) in two conv
            # passes: gn1 is an affine applied inside conv1, conv1 emits gn2's
            # channel statistics, conv2 applies gn2's affine and adds the skip.
            a1, b1 = fused_gn_producer(x, self.gn1, groups=self.g1, name="gn1_stats")
            skip = x if self.c_in == self.c_out else self.skip(x, impl=impl)
            h, stats = self.conv1(x, impl=impl, gn_affine=(a1, b1), temb=t.float(),
                                  emit_stats=True)
            a2, b2 = conv_ops.affine_from_stats(
                stats, self.gn2.scale, self.gn2.bias, groups=self.g2,
                count=h.shape[1] * h.shape[2])
            return self.conv2(h, impl=impl, gn_affine=(a2, b2), residual=skip)
        h = self.gn1(x, impl=impl)
        h = self.conv1(h, impl=impl)
        h = h + t[:, None, None, :].to(h.dtype)
        _record_pointwise("temb_add", h)
        h = self.gn2(h, impl=impl)
        h = self.conv2(h, impl=impl)
        skip = x if self.c_in == self.c_out else self.skip(x, impl=impl)
        _record_pointwise("residual_add", h, reads=2)
        return skip + h


class _TransformerLayer(Module):
    """One ``layer{i}`` entry of a SpatialTransformer (a plain dict in the
    reference's parameter tree)."""

    def __init__(self, channels, n_heads, head_dim, cross, dtype):
        super().__init__()

        def attn(is_cross, name):
            return Attention(channels, n_heads, head_dim, cross=is_cross, dtype=dtype, name=name)

        self.ln1 = LayerNorm(channels, dtype=dtype, name="ln1")
        self.self_attn = attn(False, "self_attn")
        self.ln3 = LayerNorm(channels, dtype=dtype, name="ln3")
        self.ff_in = Dense(channels, 4 * channels, True, dtype, name="ff_in", axes=("embed", "mlp"))
        self.ff_gate = Dense(channels, 4 * channels, True, dtype, name="ff_gate",
                             axes=("embed", "mlp"))
        self.ff_out = Dense(4 * channels, channels, True, dtype, name="ff_out",
                            axes=("mlp", "embed"))
        if cross:
            self.ln2 = LayerNorm(channels, dtype=dtype, name="ln2")
            self.cross_attn = attn(True, "cross_attn")


class SpatialTransformer(Module):
    """norm -> proj_in -> depth x (self-attn, cross-attn, GeGLU-FF) -> proj_out."""

    def __init__(self, channels: int, head_channels: int, context_dim: int, *,
                 cross: bool = True, depth: int = 1, groups: int = 32,
                 fixed_heads: int = 0, dtype=torch.float32):
        super().__init__()
        self.cross, self.depth = cross, depth
        n_heads = fixed_heads or max(1, channels // head_channels)
        self.gn = GroupNorm(channels, min(groups, channels), dtype=dtype, name="gn")
        self.proj_in = Dense(channels, channels, True, dtype, name="proj_in",
                             axes=("embed", "embed2"))
        self.proj_out = Dense(channels, channels, True, dtype, name="proj_out",
                              axes=("embed", "embed2"))
        if cross:
            self.ctx_proj = Dense(context_dim, channels, False, dtype, name="ctx_proj",
                                  axes=(None, "embed"))
        for i in range(depth):
            self.add_module(f"layer{i}", _TransformerLayer(
                channels, n_heads, channels // n_heads, cross, dtype))

    def forward(self, x, context=None, *, impl="auto"):
        B, H, W, C = x.shape
        h = self.gn(x, impl=impl)
        tokens = self.proj_in(h.reshape(B, H * W, C))
        ctx = self.ctx_proj(context) if self.cross and context is not None else None
        for i in range(self.depth):
            p = getattr(self, f"layer{i}")
            tokens = tokens + p.self_attn(p.ln1(tokens), impl=impl)
            if ctx is not None:
                tokens = tokens + p.cross_attn(p.ln2(tokens), context=ctx, impl=impl)
            t = p.ln3(tokens)
            ff = F.gelu(p.ff_gate(t), approximate="tanh") * p.ff_in(t)
            tokens = tokens + p.ff_out(ff)
        return x + self.proj_out(tokens).reshape(B, H, W, C)


class Downsample(Module):
    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2D(channels, channels, 3, stride=2, dtype=dtype, name="down")

    def forward(self, x, *, impl="auto"):
        return self.conv(x, impl=impl)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC nearest-neighbour 2x resize (``jax.image.resize(..., "nearest")``
    at an exact factor of 2: output pixel i reads input pixel i // 2)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class Upsample(Module):
    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2D(channels, channels, 3, dtype=dtype, name="up")

    def forward(self, x, *, impl="auto"):
        up = upsample_nearest2x(x)
        if tracer.active():
            # the resize writes the 4x tensor before the conv reads it back
            tracer.record("pointwise", "upsample_resize", flops=0.0,
                          bytes_hbm=tracer.nbytes((x.shape, x.dtype), (up.shape, up.dtype)))
        return self.conv(up, impl=impl)


def unet_plan(cfg: UNetConfig) -> dict:
    """Static block structure: ``{"down": [[(kind, c_in, c_out)...]...],
    "mid": [...], "up": [...]}`` (``repro.models.unet.UNet2D._plan``)."""
    ch = cfg.model_channels
    plan = {"down": [], "mid": None, "up": []}
    c_cur = ch
    skip_chans = [ch]
    for level, mult in enumerate(cfg.channel_mult):
        c_out = ch * mult
        blocks = []
        for _ in range(cfg.num_res_blocks):
            blocks.append(("res", c_cur, c_out))
            c_cur = c_out
            if level in cfg.attn_levels:
                blocks.append(("attn", c_cur, c_cur))
            skip_chans.append(c_cur)
        if level != len(cfg.channel_mult) - 1:
            blocks.append(("down", c_cur, c_cur))
            skip_chans.append(c_cur)
        plan["down"].append(blocks)
    plan["mid"] = [("res", c_cur, c_cur), ("attn", c_cur, c_cur), ("res", c_cur, c_cur)]
    for level in reversed(range(len(cfg.channel_mult))):
        c_out = ch * cfg.channel_mult[level]
        blocks = []
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(("res", c_cur + skip_chans.pop(), c_out))
            c_cur = c_out
            if level in cfg.attn_levels:
                blocks.append(("attn", c_cur, c_cur))
        if level != 0:
            blocks.append(("up", c_cur, c_cur))
        plan["up"].append(blocks)
    return plan


class UNet2D(Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        dt, mc = cfg.dtype, cfg.model_channels
        self.conv_in = Conv2D(cfg.in_channels, mc, 3, dtype=dt, name="conv_in")
        self.temb1 = Dense(mc, cfg.temb_dim, True, dt, axes=(None, "mlp"))
        self.temb2 = Dense(cfg.temb_dim, cfg.temb_dim, True, dt, axes=("mlp", "mlp2"))
        self.gn_out = GroupNorm(mc, min(cfg.groups, mc), fuse_silu=True, dtype=dt)
        self.conv_out = Conv2D(mc, cfg.out_channels, 3, dtype=dt, name="conv_out")
        self.plan = unet_plan(cfg)
        for part in ("down", "up"):
            for si, blocks in enumerate(self.plan[part]):
                for bi, (kind, ci, co) in enumerate(blocks):
                    self.add_module(f"{part}_{si}_{bi}_{kind}", self._block(kind, ci, co))
        for bi, (kind, ci, co) in enumerate(self.plan["mid"]):
            self.add_module(f"mid_{bi}_{kind}", self._block(kind, ci, co))

    def _block(self, kind, c_in, c_out):
        cfg = self.cfg
        if kind == "res":
            return ResBlock(c_in, c_out, cfg.temb_dim, cfg.groups, cfg.dtype)
        if kind == "attn":
            return SpatialTransformer(
                c_out, cfg.head_channels, cfg.context_dim, cross=cfg.cross_attn,
                depth=cfg.tf_depth, groups=cfg.groups, fixed_heads=cfg.n_heads,
                dtype=cfg.dtype)
        if kind == "down":
            return Downsample(c_out, cfg.dtype)
        if kind == "up":
            return Upsample(c_out, cfg.dtype)
        raise ValueError(kind)

    def forward(self, x, t, context=None, *, impl="auto", temporal_hook=None, frames: int = 1):
        """x: (B, H, W, C_in); t: (B,) timesteps; context: (B, L, ctx_dim).

        ``temporal_hook(name, h, frames)`` runs right after each spatial
        attention block (the VideoUNet's temporal layers), inside the block
        step, so the skip an attention block refines is the hooked output."""
        cfg = self.cfg
        temb = sinusoidal_embedding(t, cfg.model_channels)
        temb = self.temb2(F.silu(self.temb1(temb)))

        def run(name, kind, h):
            mod = getattr(self, name)
            with tracer.scope(name):
                if kind == "res":
                    return mod(h, temb, impl=impl)
                if kind == "attn":
                    h = mod(h, context, impl=impl)
                    return h if temporal_hook is None else temporal_hook(name, h, frames)
                return mod(h, impl=impl)

        h = self.conv_in(x, impl=impl)
        skips = [h]
        for si, blocks in enumerate(self.plan["down"]):
            for bi, (kind, _, _) in enumerate(blocks):
                h = run(f"down_{si}_{bi}_{kind}", kind, h)
                if kind == "attn":
                    skips[-1] = h  # attention refines the last skip
                else:
                    skips.append(h)
        for bi, (kind, _, _) in enumerate(self.plan["mid"]):
            h = run(f"mid_{bi}_{kind}", kind, h)
        for si, blocks in enumerate(self.plan["up"]):
            for bi, (kind, _, _) in enumerate(blocks):
                if kind == "res":
                    # channel concat pinned unsharded: conv-channel TP
                    # shards the skip's channels
                    h = concat_unsharded([h, skips.pop()], axis=-1)
                h = run(f"up_{si}_{bi}_{kind}", kind, h)

        if conv_ops.is_fused(impl):
            a, b = fused_gn_producer(h, self.gn_out, groups=self.gn_out.groups,
                                     name="gn_out_stats")
            return self.conv_out(h, impl=impl, gn_affine=(a, b))
        return self.conv_out(self.gn_out(h, impl=impl), impl=impl)
