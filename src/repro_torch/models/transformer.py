"""Transformer blocks and the decoder-only LM (``repro.models.transformer``),
the dense and MoE branches: the image transformers' blocks (Muse, Parti),
the LLM baseline (LLaMA2-7B) and the assigned dense and MoE LMs.

``Block`` is built from an ``LMConfig`` as the reference's: RMSNorm or
LayerNorm, GQA self-attention with RoPE (causal or not) and optional
qk-norm, optional cross-attention to a context, and the plain or gated MLP,
or in a ``"moe"`` block the MoE FFN (key ``moe``); ``decode`` runs one token
against the block's KV cache.  A ``"moe"`` block's forward (the prefill)
drops assignments past capacity, as the reference's; its decode runs with
``no_drop``; the auxiliary loss is dropped in both, as there.

``TransformerLM`` is the paper's Table III Prefill / Decode pair:
``prefill`` processes a prompt through the causal flash-attention kernel
and leaves the caches padded to decode capacity,
``decode_step`` runs one token against them.

The LM keeps the reference's scanned parameter layout: each run of
identical blocks is one group ``blocks.g{i}_{type}`` whose leaves carry a
leading layer axis (``nn.stack_params``), so a JAX tree bridges unchanged;
the Python loop over layers reads each layer's slice as a view
(``nn.layer_views``): deepseek-moe's stack is ``g0_dense`` (its first
layer) and ``g1_moe``.  SSM, RG-LRU, local-window, enc-dec and VLM blocks
come with their own slices (``configs.base.check_ported``).

Tracer scopes are the reference's unrolled ones: ``layer_g{i}_{j}_{type}``
around each layer of the LM's prefill and decode step.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import PORTED_BLOCKS, LMConfig, check_ported
from repro_torch.core import tracer
from repro_torch.models.layers.attention import Attention, AttentionCache
from repro_torch.models.layers.basic import Dense, Embedding
from repro_torch.models.layers.mlp import MLP
from repro_torch.models.layers.moe import MoE
from repro_torch.models.layers.norms import LayerNorm, RMSNorm
from repro_torch.nn import Module, layer_views, stack_params


def _norm(c: LMConfig, name: str) -> Module:
    """The config's norm: RMSNorm, LayerNorm, or OLMo's non-parametric LN
    (a LayerNorm with no leaves)."""
    if c.norm == "rmsnorm":
        return RMSNorm(c.d_model, dtype=c.dtype, name=name)
    if c.norm == "layernorm":
        return LayerNorm(c.d_model, dtype=c.dtype, name=name)
    if c.norm == "nonparametric_ln":
        return LayerNorm(c.d_model, dtype=c.dtype, name=name, with_scale=False,
                         with_bias=False)
    raise ValueError(c.norm)


class Block(Module):
    """norm1 -> self-attention -> (norm_cross -> cross-attention) -> norm2 ->
    MLP (or MoE), each with its residual, under the reference's keys
    ``norm1``, ``attn``, ``norm_cross``, ``cross_attn``, ``norm2``, ``mlp``
    (``moe``).  RoPE is on (``rope=not cfg.is_encdec``), and rotates only
    where positions are given."""

    def __init__(self, cfg: LMConfig, block_type: str = "dense", causal: bool = True,
                 with_cross: bool = False):
        super().__init__()
        check_ported(cfg)
        if block_type not in PORTED_BLOCKS:
            raise NotImplementedError(f"{block_type!r} blocks come with their LM family")
        c = cfg
        self.block_type, self.with_cross = block_type, with_cross
        self.norm1 = _norm(c, "norm1")
        self.attn = Attention(
            c.d_model, c.n_heads, c.resolved_head_dim, n_kv_heads=c.n_kv_heads,
            qkv_bias=c.qkv_bias, qk_norm=c.qk_norm, rope=not c.is_encdec,
            rope_base=c.rope_base, rope_pct=c.rope_pct, causal=causal, dtype=c.dtype)
        self.norm2 = _norm(c, "norm2")
        if block_type == "moe":
            m = c.moe
            self.moe = MoE(c.d_model, m.d_ff_expert, m.n_experts, m.top_k,
                           n_shared=m.n_shared, d_ff_shared=m.d_ff_shared,
                           capacity_factor=m.capacity_factor, activation=c.mlp_activation,
                           dtype=c.dtype)
        else:
            self.mlp = MLP(c.d_model, c.d_ff, dtype=c.dtype, activation=c.mlp_activation,
                           gated=c.mlp_gated)
        if with_cross:
            self.cross_attn = Attention(
                c.d_model, c.n_heads, c.resolved_head_dim, n_kv_heads=c.n_kv_heads,
                qkv_bias=c.qkv_bias, cross=True, dtype=c.dtype, name="cross_attn")
            self.norm_cross = _norm(c, "norm_cross")

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor | None = None,
                context: torch.Tensor | None = None, impl: str = "auto",
                return_state: bool = False):
        """x (B, S, d) -> x, or (x, {"attn": the layer's k, v}) with
        ``return_state``."""
        h = self.norm1(x)
        if return_state:
            a, kv = self.attn(h, positions=positions, impl=impl, return_kv=True)
        else:
            a = self.attn(h, positions=positions, impl=impl)
        x = x + a
        if self.with_cross:
            x = x + self.cross_attn(self.norm_cross(x), context=context, impl=impl)
        x = x + self._ffn(self.norm2(x), no_drop=False)
        return (x, {"attn": kv}) if return_state else x

    def _ffn(self, h: torch.Tensor, no_drop: bool) -> torch.Tensor:
        """The MLP, or the MoE without its auxiliary loss."""
        if self.block_type == "moe":
            return self.moe(h, no_drop=no_drop)[0]
        return self.mlp(h)

    def decode(self, x: torch.Tensor, state: dict, cur_len: int, *,
               cross_cache: AttentionCache | None = None):
        """x (B, 1, d) against ``state["attn"]`` -> (x, state); the cache is
        written in place."""
        a, kv = self.attn.decode(self.norm1(x), state["attn"], cur_len)
        x = x + a
        if self.with_cross:
            y, _ = self.cross_attn.decode(self.norm_cross(x), None, cur_len,
                                          cross_cache=cross_cache)
            x = x + y
        return x + self._ffn(self.norm2(x), no_drop=True), {"attn": kv}


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    """0..S-1 for each row of tokens (B, S)."""
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)


def _zero_cache(group: list, batch: int, cap: int) -> AttentionCache:
    """Zeros (n, batch, cap, KVH, D) for the n layers of a group."""
    a = group[0].attn
    shape = (len(group), batch, cap, a.n_kv_heads, a.head_dim)
    return AttentionCache(*(torch.zeros(shape, dtype=a.dtype, device=a.wq.kernel.device)
                            for _ in range(2)))


class TransformerLM(Module):
    """Parameter tree ``{"embed", "final_norm", "lm_head", "blocks":
    {"g0_dense": ...}}`` with stacked groups, as the reference's; with
    ``tie_embeddings`` there is no ``lm_head`` and the logits go through the
    embedding table (``Embedding.attend``)."""

    def __init__(self, cfg: LMConfig):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.groups: list[tuple[str, int]] = []  # contiguous runs of one block type
        for t in cfg.block_types():
            if self.groups and self.groups[-1][0] == t:
                self.groups[-1] = (t, self.groups[-1][1] + 1)
            else:
                self.groups.append((t, 1))
        self.embed = Embedding(cfg.vocab, cfg.d_model, cfg.dtype)
        self.final_norm = _norm(cfg, "final_norm")
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.vocab, False, cfg.dtype, name="lm_head")
        self.blocks = Module()
        for i, (t, n) in enumerate(self.groups):
            self.blocks.add_module(f"g{i}_{t}", stack_params(Block(cfg, t, causal=True), n))
        self._views: tuple = (None, None)

    def layers(self) -> list[list[Block]]:
        """Each group's layers as views of their slices, rebuilt when the
        parameters are replaced (a load) or their storage changes."""
        groups = [getattr(self.blocks, f"g{i}_{t}") for i, (t, _) in enumerate(self.groups)]
        key = tuple(p.data_ptr() for g in groups for p in g.parameters())
        if self._views[0] != key:
            self._views = (key, [layer_views(g, n) for g, (_, n) in zip(groups, self.groups)])
        return self._views[1]

    def forward(self, tokens: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        """Full causal forward: tokens (B, S) -> logits (B, S, vocab)."""
        x = self.embed(tokens)
        positions = _positions(tokens)
        for i, group in enumerate(self.layers()):
            for j, layer in enumerate(group):
                with tracer.scope(self._scope(i, j)):
                    x = layer(x, positions=positions, impl=impl)
        return self._logits(self.final_norm(x))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.embed.attend(x) if self.cfg.tie_embeddings else self.lm_head(x)

    def prefill(self, tokens: torch.Tensor, *, impl: str = "auto",
                max_len: int | None = None):
        """Process a prompt (B, S) -> (last-position logits (B, 1, vocab),
        caches): each group's keys and values stacked (n, B, cap, KVH, D),
        padded with zeros to ``cap = max_len`` (default S), or cut to it, as
        the reference's ``_to_capacity``."""
        B, S = tokens.shape
        cap = S if max_len is None else max_len
        x = self.embed(tokens)
        positions = _positions(tokens)
        caches = []
        for i, group in enumerate(self.layers()):
            kv = _zero_cache(group, B, cap)
            for j, layer in enumerate(group):
                with tracer.scope(self._scope(i, j)):
                    x, st = layer(x, positions=positions, impl=impl, return_state=True)
                kv.k[j, :, :min(S, cap)] = st["attn"].k[:, :cap]
                kv.v[j, :, :min(S, cap)] = st["attn"].v[:, :cap]
            caches.append({"attn": kv})
        # the norm over every position, as the reference's (its event counts
        # them all); the last position's logits
        logits = self._logits(self.final_norm(x)[:, -1:])
        return logits, caches

    def init_cache(self, batch: int, max_len: int) -> list:
        """Zero caches of ``max_len`` rows, one ``{"attn": (k, v)}`` a group
        of shape (n, batch, max_len, KVH, D), beside the weights."""
        return [{"attn": _zero_cache(group, batch, max_len)} for group in self.layers()]

    def decode_step(self, token: torch.Tensor, caches: list, cur_len: int, *,
                    impl: str = "auto"):
        """token (B, 1) at position ``cur_len`` -> (logits (B, 1, vocab),
        caches), the caches written in place."""
        del impl  # decode attention is plain PyTorch on every tier
        x = self.embed(token)
        for i, (group, cache) in enumerate(zip(self.layers(), caches)):
            for j, layer in enumerate(group):
                with tracer.scope(self._scope(i, j)):
                    x, _ = layer.decode(x, {"attn": AttentionCache(cache["attn"].k[j],
                                                                   cache["attn"].v[j])}, cur_len)
        return self._logits(self.final_norm(x)), caches

    def _scope(self, i: int, j: int) -> str:
        return f"layer_g{i}_{j}_{self.groups[i][0]}"
