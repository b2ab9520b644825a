"""Transformer text-to-image (Muse and Parti), the port of
``repro.models.ar_image``: a decoder-only transformer over image tokens,
conditioned on a text encoder through cross-attention, then a VQ-GAN
decoder to pixels.  Two decode disciplines, as the paper's Table III maps
them:

  * Muse: parallel decoding (MaskGIT).  Every step runs the whole
    constant-length token sequence (the paper's Fig. 7 "Muse" profile).
  * Parti: autoregressive decoding with a KV cache, one greedy token a step
    through causal blocks (the LLM Decode regime; the sequence grows
    linearly, Fig. 7 "Parti").

The MaskGIT rule, which the reference writes out twice (``ar_image.py``
``decode_parallel`` and ``ttv.py`` ``decode_tokens``), is written once here
(:func:`maskgit_step`, :func:`parallel_decode`); Phenaki calls it too.  So
is the masked-modeling draw of the training losses (:func:`draw_mask`,
:func:`mask_inputs`; Muse's fraction from U(0.2, 0.9), Phenaki's from
U(0.3, 0.9)), whose NLL is ``transformer.masked_nll``.

Under an active trace both loops stand one pass for the loop, as the
reference's: the parallel decode runs one backbone pass, scales its events
by the step count and returns its argmax; the autoregressive decode runs its
first step.  Neither reads a tensor's values, so both run on ``meta``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.core import tracer
from repro_torch.models.layers.attention import AttentionCache
from repro_torch.models.layers.basic import Dense, Embedding
from repro_torch.models.layers.norms import LayerNorm
from repro_torch.models.text_encoder import TextEncoder, TextEncoderConfig
from repro_torch.models.transformer import Block, masked_nll
from repro_torch.models.vae import VQDecoderConfig, VQGANDecoder
from repro_torch.nn import Module, normal_init


@dataclasses.dataclass(frozen=True)
class ARImageConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    image_vocab: int = 8192
    image_tokens: int = 1024  # 32x32 grid
    decode: str = "ar"  # "ar" (Parti) | "parallel" (Muse)
    parallel_steps: int = 12
    text: TextEncoderConfig = TextEncoderConfig()
    vq: VQDecoderConfig = VQDecoderConfig()
    family: str = "transformer_tti"
    dtype: Any = torch.float32
    source: str = ""

    def lm_config(self) -> LMConfig:
        """The LMConfig the image-transformer blocks are built from."""
        return LMConfig(
            name=self.name + "-img", family="dense", n_layers=self.n_layers,
            d_model=self.d_model, n_heads=self.n_heads, n_kv_heads=self.n_heads,
            d_ff=self.d_ff, vocab=self.image_vocab + 1,  # +1: the mask token (Muse)
            norm="layernorm", mlp_activation="gelu", mlp_gated=False, dtype=self.dtype)


# ---------------------------------------------------------------------------
# MaskGIT parallel decoding (deterministic: greedy predictions, unmasked by
# confidence on a cosine schedule; no random draw)
# ---------------------------------------------------------------------------


def keep_count(i: int, steps: int, seq_len: int) -> int:
    """Positions left masked after step ``i``: ``cos((i + 1) / steps * pi / 2)
    * seq_len``, truncated, computed in float32 in the reference's order of
    operations.  Python's float64 gives another count where the product
    lands near an integer (e.g. 128 for 127 at seq_len 256, 12 steps, i 7).
    Always on the CPU, so every device takes the same schedule."""
    frac = torch.tensor(i + 1, dtype=torch.int32) / steps
    frac = torch.cos(frac * math.pi / 2)
    return int((frac * seq_len).to(torch.int32))


def maskgit_step(tokens: torch.Tensor, logits: torch.Tensor, i: int, steps: int,
                 mask_token: int) -> torch.Tensor:
    """One unmasking step: the still-masked positions whose confidence (the
    max log-probability) is at least the n-th best take their argmax, where
    n brings the masked count down to :func:`keep_count`.  Every position
    tied with the n-th best is unmasked, as in the reference (a top-k would
    take exactly n)."""
    S = tokens.shape[1]
    pred = logits.argmax(-1)  # the first maximum, as jnp.argmax
    conf = torch.log_softmax(logits, dim=-1).amax(-1)
    still = tokens == mask_token
    conf = conf.masked_fill(~still, -math.inf)
    order = conf.sort(dim=-1, descending=True).values
    n_unmask = (S - keep_count(i, steps, S) - (~still).sum(-1)).clamp(min=0)
    cutoff = order.gather(-1, (n_unmask - 1).clamp(min=0)[:, None])
    unmask = still & (conf >= cutoff) & (n_unmask > 0)[:, None]
    return torch.where(unmask, pred, tokens)


def parallel_decode(backbone: Callable, ctx: torch.Tensor, seq_len: int, steps: int,
                    mask_token: int) -> torch.Tensor:
    """All-masked tokens (B, seq_len) -> decoded tokens: ``steps`` MaskGIT
    steps, then one more backbone pass fills any position still masked
    with its argmax (``steps + 1`` passes in all).  Under an active trace:
    one pass, its events scaled by ``steps``, and its argmax."""
    tokens = torch.full((ctx.shape[0], seq_len), mask_token, dtype=torch.int64,
                        device=ctx.device)
    if tracer.active():
        t0 = len(tracer.innermost().events)
        logits = backbone(tokens, ctx)
        tracer.scale_since(t0, steps)
        return logits.argmax(-1)
    for i in range(steps):
        tokens = maskgit_step(tokens, backbone(tokens, ctx), i, steps, mask_token)
    pred = backbone(tokens, ctx).argmax(-1)
    return torch.where(tokens == mask_token, pred, tokens)


# ---------------------------------------------------------------------------
# Masked modeling, the training side of MaskGIT
# ---------------------------------------------------------------------------


def draw_mask(shape: tuple, lo: float, hi: float, gen: torch.Generator) -> torch.Tensor:
    """A (B, S) bool mask drawn on the CPU from ``gen``: a fraction per row
    from U(lo, hi), then a position is masked where a uniform draw is below
    its row's fraction (the reference's ``uniform(key, (B, 1), lo, hi)`` and
    ``uniform(fold_in(key, 1), (B, S)) < frac``)."""
    B, S = shape
    frac = lo + (hi - lo) * torch.rand((B, 1), generator=gen)
    return torch.rand((B, S), generator=gen) < frac


def mask_inputs(tokens: torch.Tensor, mask: torch.Tensor, mask_token: int) -> tuple:
    """(inputs, labels): masked positions take ``mask_token`` in the inputs,
    and only they keep their label (-1 elsewhere)."""
    mask = torch.as_tensor(mask, device=tokens.device)
    return (torch.where(mask, mask_token, tokens),
            torch.where(mask, tokens, -1))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class ARImageModel(Module):
    """Parameter tree ``{"text", "ctx_proj", "embed", "pos", "final_ln",
    "head", "vq", "layer{i}"}``, as the reference's; the blocks are causal
    for ``decode == "ar"``.  Inference is driven by
    ``ARImageWorkload.run_stage`` only; ``train_loss`` is the reference's
    (the VQ-GAN decoder takes no part in it)."""

    MASK_FRACTION = (0.2, 0.9)  # Muse's masked share of a row, U(lo, hi)

    def __init__(self, cfg: ARImageConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.text = TextEncoder(c.text)
        self.ctx_proj = Dense(c.text.d_model, c.d_model, False, c.dtype, name="ctx_proj")
        # +1: the mask token
        self.embed = Embedding(c.image_vocab + 1, c.d_model, c.dtype, name="img_embed")
        self.param("pos", (c.image_tokens, c.d_model), normal_init(0.01), c.dtype)
        self.final_ln = LayerNorm(c.d_model, dtype=c.dtype, name="final_ln")
        self.head = Dense(c.d_model, c.image_vocab, False, c.dtype, name="head")
        self.vq = VQGANDecoder(c.vq)
        lm = c.lm_config()
        for i in range(c.n_layers):
            self.add_module(f"layer{i}", Block(lm, "dense", causal=c.decode == "ar",
                                               with_cross=True))

    def blocks(self) -> list[Block]:
        return [getattr(self, f"layer{i}") for i in range(self.cfg.n_layers)]

    @property
    def mask_token(self) -> int:
        return self.cfg.image_vocab  # the last id

    def encode_text(self, tokens, *, impl="auto"):
        """The text encoding projected to the model width: (B, L, d_model)."""
        return self.ctx_proj(self.text(tokens, impl=impl))

    def backbone(self, tokens, ctx, *, impl="auto"):
        """tokens (B, S) -> logits (B, S, image_vocab) over the whole
        sequence (causal for Parti).  No positions reach the blocks, so their
        RoPE is a no-op here, as in the reference."""
        x = self.embed(tokens)
        x = x + self.pos[: tokens.shape[1]].to(x.dtype)[None]
        for i, block in enumerate(self.blocks()):
            with tracer.scope(f"layer{i}"):
                x = block(x, context=ctx, impl=impl)
        return self.head(self.final_ln(x))

    # -- training: next-token AR (Parti) or masked modeling (Muse) -----------

    def train_mask(self, shape: tuple, gen: torch.Generator) -> torch.Tensor | None:
        """Muse's mask for image tokens of ``shape`` (B, S), drawn on the CPU
        from ``gen``; Parti draws nothing (None)."""
        if self.cfg.decode == "ar":
            return None
        return draw_mask(shape, *self.MASK_FRACTION, gen)

    def train_loss(self, batch: dict, gen: torch.Generator, *, impl="auto") -> torch.Tensor:
        """The reference's loss of ``batch`` (``{"image_tokens": (B, S),
        "text": (B, L)}``), Muse's mask drawn from ``gen``."""
        mask = self.train_mask(tuple(batch["image_tokens"].shape), gen)
        return self.token_loss(batch, mask, impl=impl)

    def token_loss(self, batch: dict, mask, *, impl="auto") -> torch.Tensor:
        """The loss for a given ``mask`` (Muse; None for Parti): Parti
        predicts every token from its predecessors (inputs shifted right,
        BOS 0), Muse the masked tokens from the rest; the NLL in fp32 over
        the counted labels."""
        tokens = torch.as_tensor(batch["image_tokens"]).long()
        if self.cfg.decode == "ar":
            inp, labels = torch.nn.functional.pad(tokens[:, :-1], (1, 0)), tokens
        else:
            inp, labels = mask_inputs(tokens, mask, self.mask_token)
        ctx = self.encode_text(torch.as_tensor(batch["text"], device=tokens.device), impl=impl)
        return masked_nll(self.backbone(inp, ctx, impl=impl), labels)

    def decode_parallel(self, ctx, steps: int, *, impl="auto"):
        """Muse parallel decoding of ``steps`` unmasking steps from a
        projected text context (the workload passes its stage's steps)."""
        return parallel_decode(lambda t, cx: self.backbone(t, cx, impl=impl), ctx,
                               self.cfg.image_tokens, steps, self.mask_token)

    # -- Parti: autoregressive decoding with a KV cache ----------------------

    def ar_init(self, ctx):
        """The decode loop's state for a projected context (B, L, d_model):
        per layer a zero self-attention cache of ``image_tokens`` rows in the
        model's dtype, and the cross-attention keys and values of ``ctx``,
        computed once."""
        B, S = ctx.shape[0], self.cfg.image_tokens
        caches = [{"attn": b.attn.init_cache(B, S, dtype=self.cfg.dtype)} for b in self.blocks()]
        cross = [b.cross_attn.project_kv(ctx) for b in self.blocks()]
        return caches, cross

    def ar_step(self, prev: torch.Tensor, t: int, caches: list, cross: list[AttentionCache]):
        """Decode step ``t``: the previous token ``prev`` (B, 1) (BOS 0 at
        t = 0) plus the position embedding ``pos[max(t - 1, 0)]``, as the
        reference (so steps 0 and 1 both add ``pos[0]``), through every
        block against its cache (written in place) -> logits (B, image_vocab)."""
        x = self.embed(prev)
        x = x + self.pos[max(t - 1, 0)].to(x.dtype)
        for i, block in enumerate(self.blocks()):
            x, caches[i] = block.decode(x, caches[i], t, cross_cache=cross[i])
        return self.head(self.final_ln(x))[:, 0]

    def decode_ar(self, ctx, steps: int | None = None):
        """Parti greedy decoding of ``steps`` tokens (default all
        ``image_tokens``; the workload passes its stage's steps) from a
        projected text context.  Positions not decoded stay 0, as the
        reference's token buffer starts.  Decode attention is plain PyTorch
        on every tier, so no kernel tier applies.  Under an active trace the
        first step runs, as the reference's (the workload's ``trace_events``
        samples the steps)."""
        B, S = ctx.shape[0], self.cfg.image_tokens
        tokens = torch.zeros((B, S), dtype=torch.int64, device=ctx.device)
        caches, cross = self.ar_init(ctx)
        if tracer.active():
            steps = 1
        for t in range(S if steps is None else steps):
            prev = tokens[:, max(t - 1, 0): max(t - 1, 0) + 1]  # column 0 is still BOS 0 at t = 0
            tokens[:, t] = self.ar_step(prev, t, caches, cross).argmax(-1)  # the first maximum
        return tokens
