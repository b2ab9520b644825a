"""Text-to-video models, the port of ``repro.models.ttv``.

* Make-A-Video: a diffusion VideoUNet.  The spatial UNet runs with frames
  folded into the batch, and temporal attention + temporal conv layers run
  after every spatial attention block (paper Fig. 3/10).  Temporal
  attention attends across frames: sequence length F, batch B * H * W.
* Phenaki: a masked transformer over (frames x spatial) video tokens with
  factorized spatial / temporal attention, sampled by parallel decoding
  (the MaskGIT rule of ``models/ar_image.py``).

Both train with the reference's losses: Make-A-Video the DDPM
noise-prediction MSE on (B, F, H, W, C) video (``train_noise`` draws ``t``
and ``eps`` on the CPU, ``denoise_loss`` takes them as given), Phenaki the
masked cross-entropy on video tokens (``train_mask`` draws the mask on the
CPU, ``masked_loss`` takes it as given), so a test can hand in the
reference's own draws.  Tracer events, names and scopes are the
reference's: ``temporal/<block>`` around a VideoUNet site's temporal
layers, ``layer<i>`` around a Phenaki layer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core import tracer
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.tiers import event_impl
from repro_torch.models.ar_image import draw_mask, mask_inputs, parallel_decode
from repro_torch.models.diffusion import q_sample, train_noise
from repro_torch.models.layers.attention import Attention
from repro_torch.models.layers.basic import Dense, Embedding
from repro_torch.models.layers.conv import TemporalConv1D
from repro_torch.models.layers.norms import LayerNorm
from repro_torch.models.text_encoder import TextEncoder, TextEncoderConfig
from repro_torch.models.transformer import masked_nll
from repro_torch.models.unet import UNet2D, UNetConfig, _record_pointwise, unet_plan
from repro_torch.nn import Module, normal_init


class TemporalAttention(Module):
    """Attention across the frame axis of (B, F, H, W, C) tensors, with a
    residual: ``x + out(attn(ln(x)))``.  The ``kernel`` tier reads the
    (B, F, HW, heads, head_dim) projections in place; ``torch`` permutes,
    which the event counts (8 more passes over q/k/v/out, strided: half the
    bandwidth)."""

    def __init__(self, channels: int, head_channels: int = 64, dtype=torch.float32,
                 name: str = "temporal_attn"):
        super().__init__()
        self.n_heads = max(1, channels // head_channels)
        self.head_channels, self.name = head_channels, name
        inner = self.n_heads * head_channels
        self.ln = LayerNorm(channels, dtype=dtype, name="ln")
        self.wq, self.wk, self.wv = (Dense(channels, inner, True, dtype, name=n,
                                           axes=("embed", "heads")) for n in ("wq", "wk", "wv"))
        self.out = Dense(inner, channels, True, dtype, name="out", axes=("heads", "embed"))

    def forward(self, x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        B, F, H, W, C = x.shape
        hx = self.ln(x).reshape(B, F, H * W, C)
        nh, hd = self.n_heads, self.head_channels

        def heads(proj):
            return proj(hx).reshape(B, F, H * W, nh, hd)

        out = attn_ops.temporal_attention(heads(self.wq), heads(self.wk), heads(self.wv),
                                          impl=impl)
        if tracer.active():
            elem = tracer.dtype_bytes(x.dtype)
            qkv_o = 4 * B * F * H * W * nh * hd * elem
            name = event_impl(impl)
            fused = name in ("pallas", "interpret")
            tracer.record("attention", self.name, flops=4.0 * B * H * W * nh * F * F * hd,
                          bytes_hbm=qkv_o + (0 if fused else 2 * qkv_o), seq_len=F,
                          temporal=True, q_len=F, impl=name,
                          bw_efficiency=1.0 if fused else 0.5)
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
            with tracer.scope(f"temporal/{name}"):
                hv = getattr(self, f"tattn/{name}")(hv, impl=impl)
                hv = hv + getattr(self, f"tconv/{name}")(hv, impl=impl)
                _record_pointwise("tconv_residual_add", hv, reads=2)
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

    train_noise = staticmethod(train_noise)

    def train_loss(self, batch: dict, gen: torch.Generator, *, impl="auto") -> torch.Tensor:
        """Denoising loss of ``batch`` (``{"video": (B, F, H, W, C), "text":
        (B, L)}``), noise from ``gen``."""
        t, eps = self.train_noise(tuple(batch["video"].shape), gen)
        return self.denoise_loss(batch, t, eps, impl=impl)

    def denoise_loss(self, batch: dict, t, eps, *, impl="auto") -> torch.Tensor:
        """The reference's formula for given ``t`` (B,) and ``eps``: the
        noised video in the config's dtype and ``t`` in fp32 through the
        VideoUNet (which repeats ``t`` per frame), then the fp32 mean squared
        error of its noise prediction."""
        v0 = torch.as_tensor(batch["video"]).float()
        dev = v0.device
        t, eps = torch.as_tensor(t).to(dev).long(), torch.as_tensor(eps).to(dev).float()
        x_t = q_sample(v0, t, eps)
        ctx = self.text(torch.as_tensor(batch["text"], device=dev), impl=impl)
        pred = self.vunet(x_t.to(self.cfg.dtype), t.float(), ctx, impl=impl)
        return torch.mean((pred.float() - eps) ** 2)


# ---------------------------------------------------------------------------
# Phenaki: masked transformer over video tokens, factorized attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PhenakiConfig:
    name: str
    n_layers: int = 20
    d_model: int = 1536
    n_heads: int = 24
    d_ff: int = 6144
    video_vocab: int = 8192
    frames: int = 11
    tokens_per_frame: int = 256  # 16x16
    parallel_steps: int = 24
    text: TextEncoderConfig = TextEncoderConfig()
    family: str = "ttv_transformer"
    dtype: Any = torch.float32
    source: str = ""


class _PhenakiLayer(Module):
    """One ``layer{i}``: ``ln_s``, ``spatial``, ``temporal``, ``ln_c``,
    ``cross``, ``ln_f``, ``ff_in``, ``ff_out``."""

    def __init__(self, c: PhenakiConfig):
        super().__init__()
        self.frames = c.frames
        hd = c.d_model // c.n_heads
        self.ln_s = LayerNorm(c.d_model, dtype=c.dtype, name="ln_s")
        self.spatial = Attention(c.d_model, c.n_heads, hd, dtype=c.dtype, name="spatial")
        self.temporal = TemporalAttention(c.d_model, hd, c.dtype)
        self.ln_c = LayerNorm(c.d_model, dtype=c.dtype, name="ln_c")
        self.cross = Attention(c.d_model, c.n_heads, hd, cross=True, dtype=c.dtype, name="cross")
        self.ln_f = LayerNorm(c.d_model, dtype=c.dtype, name="ln_f")
        self.ff_in = Dense(c.d_model, c.d_ff, True, c.dtype, name="ff_in", axes=("embed", "mlp"))
        self.ff_out = Dense(c.d_ff, c.d_model, True, c.dtype, name="ff_out", axes=("mlp", "embed"))

    def forward(self, x, ctx, *, impl="auto"):
        B, S, d = x.shape
        frames = self.frames
        hw = S // frames
        side = math.isqrt(hw)
        # spatial: attend within each frame (frames fold into the batch)
        h = self.spatial(self.ln_s(x).reshape(B * frames, hw, d), impl=impl)
        x = x + h.reshape(B, S, d)
        # temporal: across frames at each position; the layer adds its own
        # residual
        x = self.temporal(x.reshape(B, frames, side, side, d), impl=impl).reshape(B, S, d)
        x = x + self.cross(self.ln_c(x), context=ctx, impl=impl)
        # jax.nn.gelu defaults to the tanh approximation
        h = torch.nn.functional.gelu(self.ff_in(self.ln_f(x)), approximate="tanh")
        return x + self.ff_out(h)


class PhenakiModel(Module):
    """Bidirectional transformer over (F, HW) video tokens; parameter tree
    ``{"text", "ctx_proj", "embed", "pos", "final_ln", "head", "layer{i}"}``.
    Inference is driven by ``PhenakiWorkload.run_stage`` only."""

    def __init__(self, cfg: PhenakiConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.text = TextEncoder(c.text)
        self.ctx_proj = Dense(c.text.d_model, c.d_model, False, c.dtype, name="ctx_proj",
                              axes=(None, "embed"))
        # +1: the mask token
        self.embed = Embedding(c.video_vocab + 1, c.d_model, c.dtype, name="vid_embed")
        self.param("pos", (c.frames * c.tokens_per_frame, c.d_model), normal_init(0.01),
                   c.dtype, axes=(None, "embed"))
        self.final_ln = LayerNorm(c.d_model, dtype=c.dtype, name="final_ln")
        self.head = Dense(c.d_model, c.video_vocab, False, c.dtype, name="head",
                          axes=("embed", "vocab"))
        for i in range(c.n_layers):
            self.add_module(f"layer{i}", _PhenakiLayer(c))

    @property
    def mask_token(self) -> int:
        return self.cfg.video_vocab

    def encode_text(self, tokens, *, impl="auto"):
        """The text encoding projected to the model width: (B, L, d_model)."""
        return self.ctx_proj(self.text(tokens, impl=impl))

    def backbone(self, tokens, ctx, *, impl="auto"):
        """tokens (B, F*HW) -> logits (B, F*HW, video_vocab)."""
        x = self.embed(tokens)
        x = x + self.pos[: tokens.shape[1]].to(x.dtype)[None]
        for i in range(self.cfg.n_layers):
            with tracer.scope(f"layer{i}"):
                x = getattr(self, f"layer{i}")(x, ctx, impl=impl)
        return self.head(self.final_ln(x))

    MASK_FRACTION = (0.3, 0.9)  # the masked share of a row, U(lo, hi)

    def train_mask(self, shape: tuple, gen: torch.Generator) -> torch.Tensor:
        """The mask for video tokens of ``shape`` (B, F*HW), drawn on the CPU
        from ``gen``."""
        return draw_mask(shape, *self.MASK_FRACTION, gen)

    def train_loss(self, batch: dict, gen: torch.Generator, *, impl="auto") -> torch.Tensor:
        """The reference's loss of ``batch`` (``{"video_tokens": (B, F*HW),
        "text": (B, L)}``), the mask drawn from ``gen``."""
        return self.masked_loss(batch, self.train_mask(tuple(batch["video_tokens"].shape), gen),
                                impl=impl)

    def masked_loss(self, batch: dict, mask, *, impl="auto") -> torch.Tensor:
        """Cross-entropy of the masked video tokens for a given ``mask``:
        masked inputs take the mask token, the NLL in fp32 over the masked
        positions."""
        tokens = torch.as_tensor(batch["video_tokens"]).long()
        ctx = self.encode_text(torch.as_tensor(batch["text"], device=tokens.device), impl=impl)
        inp, labels = mask_inputs(tokens, mask, self.mask_token)
        return masked_nll(self.backbone(inp, ctx, impl=impl), labels)

    def decode_tokens(self, ctx, steps: int, *, impl="auto"):
        """MaskGIT parallel decode of ``steps`` unmasking steps from a
        projected text context (the workload passes its stage's steps)."""
        c = self.cfg
        return parallel_decode(lambda t, cx: self.backbone(t, cx, impl=impl), ctx,
                               c.frames * c.tokens_per_frame, steps, self.mask_token)
