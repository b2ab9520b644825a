"""Transformer blocks and the LM (``repro.models.transformer``): the image
transformers' blocks (Muse, Parti), the LLM baseline (LLaMA2-7B) and every
assigned LM family: dense, MoE, SSM, hybrid, enc-dec (whisper) and the VLM
(Qwen2-VL).

``Block`` is built from an ``LMConfig`` as the reference's, one residual
layer of a block type:

  - ``"dense"`` / ``"moe"`` / ``"local_attn"``: RMSNorm or LayerNorm, GQA
    self-attention with RoPE or M-RoPE (causal or not, a local window in
    ``"local_attn"``) and optional qk-norm, optional cross-attention to a
    context, then the plain or gated MLP, or in a ``"moe"`` block the MoE
    FFN (key ``moe``).  A ``"moe"`` block's forward (the prefill) drops
    assignments past capacity, as the reference's; its decode runs with
    ``no_drop``; the auxiliary loss is dropped in both, as there, and
    summed over the layers by ``TransformerLM.forward_train``.
  - ``"mamba2"``: the Mamba-2 mixer (key ``mixer``), no MLP.
  - ``"rglru"``: the Griffin recurrent block (key ``rglru``), then the MLP.

``decode`` runs one token against the block's state: a KV cache, written in
place, or a recurrent state (``Mamba2State``, ``RGLRUState``), returned new.

``TransformerLM`` is the paper's Table III Prefill / Decode pair:
``prefill`` processes a prompt (through the causal flash-attention kernel,
windowed in ``"local_attn"`` blocks) and leaves each group's states:
``{"attn": AttentionCache}`` padded to decode capacity, a local window's as
a ring of ``min(window, max_len)`` rows rolled by ``S % cap`` (the
reference's ``_to_capacity``), ``{"ssm": Mamba2State}`` or ``{"rnn":
RGLRUState}``, each leaf stacked (n, B, ...); ``decode_step`` runs one token
against them, writing each layer's slice in place.

The enc-dec model (``cfg.encoder``) adds an ``encoder`` subtree (stacked
non-causal dense blocks with RoPE off, then ``encoder.final_norm``) and
decoder blocks with ``norm_cross`` / ``cross_attn``: ``encode`` turns
precomputed frame embeddings into the context, the decoder adds sinusoidal
positions to its input (``cur_len`` in decode), and each ``decode_step``
projects every layer's cross K/V from the context anew, as the reference's
does.  The VLM (``embed_inputs``, ``mrope_sections``) takes embeddings
(B, S, d) with (3, B, S) M-RoPE streams, or token ids (three equal
streams); its ``decode_step`` takes (B, 1, d) embeddings or (B, 1) tokens.

``TransformerLM.loss`` is the reference's training loss: the masked NLL of
the labels (labels < 0 masked; :func:`masked_nll`, which the image and
video token models' losses call too) plus the MoE layers' auxiliary losses, from
``forward_train`` (the reference's ``forward``: logits and the summed
auxiliary loss), each layer optionally rematerialized (``remat``:
``none``, ``dots`` saving the matmul outputs, ``full`` saving nothing),
which changes memory only.

The LM keeps the reference's scanned parameter layout: each run of
identical blocks is one group ``blocks.g{i}_{type}`` whose leaves carry a
leading layer axis (``nn.stack_params``), so a JAX tree bridges unchanged;
the Python loop over layers reads each layer's slice as a view
(``nn.layer_views``), cached for inference and taken anew in each forward
that records a graph (a view made before ``requires_grad`` was on, or
shared across optimizer steps, would cut or stale the stacked leaf's
gradient): deepseek-moe's stack is ``g0_dense`` (its first
layer) and ``g1_moe``, recurrentgemma's alternates ``g0_rglru``,
``g1_local_attn``, ``g2_rglru``, ...; whisper's encoder is
``encoder.blocks``.

Tracer scopes are the reference's unrolled ones: ``layer_g{i}_{j}_{type}``
around each layer of the LM's forward, prefill and decode step (none in the
enc-dec decode step, as there), ``enc{i}`` around each encoder layer, and
``encoder`` around ``forward``'s encoding (not ``prefill``'s).
"""

from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.core import tracer
from repro_torch.models.layers.attention import Attention, AttentionCache
from repro_torch.models.layers.basic import Dense, Embedding, sinusoidal_embedding
from repro_torch.models.layers.mlp import MLP
from repro_torch.models.layers.moe import MoE
from repro_torch.models.layers.norms import LayerNorm, RMSNorm
from repro_torch.models.layers.rglru import RGLRUBlock, RGLRUState
from repro_torch.models.layers.ssm import Mamba2Mixer, Mamba2State
from repro_torch.nn import Module, layer_views, stack_params
from repro_torch.parallel.sharding import constrain, place

# each recurrent block type: its state's key and type
RECURRENT = {"mamba2": ("ssm", Mamba2State), "rglru": ("rnn", RGLRUState)}
BLOCK_TYPES = ("dense", "moe", "local_attn", *RECURRENT)


def masked_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean negative log-likelihood of ``labels`` under ``logits`` (B,
    S, V), in fp32, over the positions whose label is >= 0: the sum over
    ``max(count, 1)``, so a batch with no such position gives 0.  On a
    mesh the logits are gathered over the vocab first (DTensor has no rule
    for a gather over a sharded vocab: a named redistribution site)."""
    logits = constrain(logits, ("batch", None, None)).float()
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((logz - label_logit) * mask).sum() / mask.sum().clamp(min=1.0)


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
    """One residual layer under the reference's keys: ``norm1``, ``attn``,
    ``norm_cross``, ``cross_attn``, ``norm2``, ``mlp`` (``moe``) in the
    attention blocks; ``norm1``, ``mixer`` in ``"mamba2"``; ``norm1``,
    ``rglru``, ``norm2``, ``mlp`` in ``"rglru"``.  RoPE (M-RoPE with
    ``cfg.mrope_sections``) is on unless the model is enc-dec (``rope=not
    cfg.is_encdec``), and rotates only where positions are given."""

    def __init__(self, cfg: LMConfig, block_type: str = "dense", causal: bool = True,
                 with_cross: bool = False):
        super().__init__()
        if block_type not in BLOCK_TYPES:
            raise ValueError(block_type)
        c = cfg
        self.block_type, self.with_cross = block_type, with_cross
        self.norm1 = _norm(c, "norm1")
        if block_type == "mamba2":
            s = c.ssm
            self.mixer = Mamba2Mixer(c.d_model, s.d_state, s.d_conv, s.expand, s.head_dim,
                                     s.chunk, dtype=c.dtype)
        elif block_type == "rglru":
            self.rglru = RGLRUBlock(c.d_model, c.d_model, dtype=c.dtype)
        else:
            self.attn = Attention(
                c.d_model, c.n_heads, c.resolved_head_dim, n_kv_heads=c.n_kv_heads,
                qkv_bias=c.qkv_bias, qk_norm=c.qk_norm, rope=not c.is_encdec,
                rope_base=c.rope_base, rope_pct=c.rope_pct, mrope_sections=c.mrope_sections,
                causal=causal,
                window=c.window if block_type == "local_attn" else None, dtype=c.dtype)
        if block_type != "mamba2":
            self.norm2 = _norm(c, "norm2")
        if block_type == "moe":
            m = c.moe
            self.moe = MoE(c.d_model, m.d_ff_expert, m.n_experts, m.top_k,
                           n_shared=m.n_shared, d_ff_shared=m.d_ff_shared,
                           capacity_factor=m.capacity_factor, activation=c.mlp_activation,
                           dtype=c.dtype)
        elif block_type != "mamba2":
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
        """x (B, S, d) -> x, or (x, the layer's state) with ``return_state``:
        ``{"attn": its k, v}``, ``{"ssm": Mamba2State}`` or ``{"rnn":
        RGLRUState}``."""
        x, _, st = self.forward_aux(x, positions=positions, context=context, impl=impl,
                                    return_state=return_state)
        return (x, st) if return_state else x

    def forward_aux(self, x: torch.Tensor, *, positions: torch.Tensor | None = None,
                    context: torch.Tensor | None = None, impl: str = "auto",
                    return_state: bool = False):
        """x (B, S, d) -> (x, aux, state), as the reference's block: ``aux``
        the MoE's auxiliary loss (0 in the other blocks), ``state`` the
        layer's state with ``return_state``, else None."""
        t = self.block_type
        if t in RECURRENT:
            y, st = self.recurrent()(self.norm1(x))
            x = x + y
            if t == "rglru":
                x = x + self.mlp(self.norm2(x))
            return x, 0.0, {RECURRENT[t][0]: st} if return_state else None
        h = self.norm1(x)
        kv = None
        if return_state:
            a, kv = self.attn(h, positions=positions, impl=impl, return_kv=True)
        else:
            a = self.attn(h, positions=positions, impl=impl)
        x = x + a
        if self.with_cross:
            x = x + self.cross_attn(self.norm_cross(x), context=context, impl=impl)
        y, aux = self._ffn(self.norm2(x), no_drop=False)
        return x + y, aux, {"attn": kv} if return_state else None

    def recurrent(self) -> Module:
        """The recurrent layer of a ``"mamba2"`` or ``"rglru"`` block."""
        return self.mixer if self.block_type == "mamba2" else self.rglru

    def _ffn(self, h: torch.Tensor, no_drop: bool) -> tuple:
        """(the MLP's or the MoE's output, the MoE's auxiliary loss or 0)."""
        if self.block_type == "moe":
            return self.moe(h, no_drop=no_drop)
        return self.mlp(h), 0.0

    def decode(self, x: torch.Tensor, state: dict, cur_len: int, *,
               cross_cache: AttentionCache | None = None):
        """x (B, 1, d) against ``state`` -> (x, state): the KV cache
        ``state["attn"]`` is written in place; a recurrent state comes back
        new."""
        t = self.block_type
        if t in RECURRENT:
            key = RECURRENT[t][0]
            y, st = self.recurrent().step(self.norm1(x), state[key])
            x = x + y
            if t == "rglru":
                x = x + self.mlp(self.norm2(x))
            return x, {key: st}
        a, kv = self.attn.decode(self.norm1(x), state["attn"], cur_len)
        x = x + a
        if self.with_cross:
            y, _ = self.cross_attn.decode(self.norm_cross(x), None, cur_len,
                                          cross_cache=cross_cache)
            x = x + y
        return x + self._ffn(self.norm2(x), no_drop=True)[0], {"attn": kv}


# the outputs ``remat="dots"`` saves, as ``jax.checkpoint_policies.checkpoint_dots``
# saves every ``dot_general``'s: the matmuls as they reach the dispatcher
_DOTS = frozenset(getattr(torch.ops.aten, op).default
                  for op in ("mm", "bmm", "addmm", "baddbmm"))


def _save_dots(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    return (torch_checkpoint.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


REMAT = ("none", "dots", "full")


def _remat(fn, remat: str):
    """``fn`` (tensors -> tensors) rematerialized in the backward: ``full``
    recomputes all of it, ``dots`` all but the matmul outputs; ``none`` is
    ``fn``.  A hand kernel in ``fn`` launches again in the recompute."""
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r} (expected one of {REMAT})")
    if remat == "none":
        return fn
    kw = dict(use_reentrant=False)
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(torch_checkpoint.checkpoint, fn, **kw)


def _zero_cache(group: list, batch: int, cap: int) -> AttentionCache:
    """Zeros (n, batch, cap, KVH, D) for the n layers of a group."""
    a = group[0].attn
    shape = (len(group), batch, cap, a.n_kv_heads, a.head_dim)
    return AttentionCache(*(place(torch.zeros(shape, dtype=a.dtype, device=a.wq.kernel.device),
                                  (None, "batch", None, None, None)) for _ in range(2)))


def _zero_state(group: list, batch: int, max_len: int) -> dict:
    """The zero decode state of a group's n layers, each leaf (n, batch,
    ...): a KV cache of ``max_len`` rows (``min(window, max_len)`` in a
    local window's ring), or zero recurrent states."""
    t = group[0].block_type
    if t in RECURRENT:
        key, cls = RECURRENT[t]
        one = group[0].recurrent().init_state(batch)
        return {key: cls(*(place(torch.stack([a] * len(group)), (None, "batch"))
                           for a in one))}
    window = group[0].attn.window
    return {"attn": _zero_cache(group, batch, max_len if window is None
                                else min(window, max_len))}


def _ring(t: torch.Tensor, S: int, cap: int) -> torch.Tensor:
    """A prefill's rows (B, S, ...) laid out as a window's ring of ``cap``
    rows (the reference's ``_to_capacity``): position p in row p % cap, so
    the last ``cap`` rows rolled by ``S % cap``; a shorter prompt fills the
    first S rows."""
    if S <= cap:
        return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, cap - S))
    return torch.roll(t[:, S - cap:], S % cap, dims=1)


class TransformerLM(Module):
    """Parameter tree ``{"embed", "final_norm", "lm_head", "blocks":
    {"g0_dense": ...}}`` with stacked groups, as the reference's, and an
    enc-dec model's ``"encoder": {"blocks", "final_norm"}``; with
    ``tie_embeddings`` there is no ``lm_head`` and the logits go through the
    embedding table (``Embedding.attend``)."""

    def __init__(self, cfg: LMConfig):
        super().__init__()
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
            self.lm_head = Dense(cfg.d_model, cfg.vocab, False, cfg.dtype, name="lm_head",
                                 axes=("embed", "vocab"))
        self.blocks = Module()
        for i, (t, n) in enumerate(self.groups):
            self.blocks.add_module(f"g{i}_{t}", stack_params(
                Block(cfg, t, causal=True, with_cross=cfg.is_encdec), n))
        if cfg.is_encdec:  # non-causal dense blocks, RoPE off
            self.encoder = Module()
            self.encoder.add_module("blocks", stack_params(Block(cfg, "dense", causal=False),
                                                           cfg.encoder.n_layers))
            self.encoder.add_module("final_norm", _norm(cfg, "final_norm"))
        self._views: tuple = (None, None)

    def _stacks(self) -> list[list[Block]]:
        """Each stacked group's layers (the decoder's groups, then an
        encoder's) as views of their slices, rebuilt when the parameters are
        replaced (a load) or their storage changes, and taken anew in a
        forward that records a graph of trainable leaves."""
        stacks = [(getattr(self.blocks, f"g{i}_{t}"), n) for i, (t, n) in enumerate(self.groups)]
        if self.cfg.is_encdec:
            stacks.append((self.encoder.blocks, self.cfg.encoder.n_layers))
        if torch.is_grad_enabled() and any(p.requires_grad for g, _ in stacks
                                           for p in g.parameters()):
            return [layer_views(g, n) for g, n in stacks]  # views in this graph
        key = tuple(p.data_ptr() for g, _ in stacks for p in g.parameters())
        if self._views[0] != key:
            self._views = (key, [layer_views(g, n) for g, n in stacks])
        return self._views[1]

    def layers(self) -> list[list[Block]]:
        """Each decoder group's layers, as views."""
        return self._stacks()[:len(self.groups)]

    def _inputs(self, tokens, embeds, mrope_positions):
        """The first layer's input x (B, S, d) and the positions the layers
        rotate at: token embeddings, or ``embeds`` in the config's dtype;
        the M-RoPE streams (3, B, S) where given, else 0..S-1; an enc-dec
        decoder adds the positions' sinusoidal embedding (no RoPE)."""
        c = self.cfg
        x = self.embed(tokens) if embeds is None else embeds.to(c.dtype)
        B, S = x.shape[:2]
        positions = mrope_positions
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        if c.is_encdec:
            x = x + sinusoidal_embedding(positions, c.d_model).to(x.dtype)
        return x, positions

    def encode(self, enc_embeds: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        """Precomputed frame embeddings (B, S_enc, d) (the stub frontend) ->
        the context (B, S_enc, d): the encoder's non-causal blocks, each in
        its ``enc{i}`` scope, then its final norm."""
        if enc_embeds is None:
            raise ValueError(f"{self.cfg.name}: the encoder needs enc_embeds (B, S_enc, d)")
        x = enc_embeds
        for i, layer in enumerate(self._stacks()[len(self.groups)]):
            with tracer.scope(f"enc{i}"):
                x = layer(x, impl=impl)
        return self.encoder.final_norm(x)

    def forward(self, tokens: torch.Tensor | None = None, *, embeds=None, enc_embeds=None,
                mrope_positions=None, impl: str = "auto") -> torch.Tensor:
        """Full forward: tokens (B, S) or ``embeds`` (B, S, d) -> logits (B,
        S, vocab); causal self-attention, and in an enc-dec model
        cross-attention to ``encode(enc_embeds)`` (in an ``encoder`` scope):
        ``forward_train``'s logits."""
        return self.forward_train(tokens, embeds=embeds, enc_embeds=enc_embeds,
                                  mrope_positions=mrope_positions, impl=impl)[0]

    def forward_train(self, tokens: torch.Tensor | None = None, *, embeds=None,
                      enc_embeds=None, mrope_positions=None, impl: str = "auto",
                      remat: str = "none"):
        """The reference's ``forward``: (logits (B, S, vocab), the MoE layers'
        auxiliary losses summed in fp32), each decoder layer wrapped by
        ``remat``."""
        x, positions = self._inputs(tokens, embeds, mrope_positions)
        context = None
        if self.cfg.is_encdec:
            with tracer.scope("encoder"):
                context = self.encode(enc_embeds, impl=impl)
        x = constrain(x, ("batch", None, None))
        aux = 0.0  # a tensor from the first MoE layer on: no op where there is none
        for i, group in enumerate(self.layers()):
            for j, layer in enumerate(group):
                def body(x, aux, layer=layer):
                    y, a, _ = layer.forward_aux(x, positions=positions, context=context, impl=impl)
                    return constrain(y, ("batch", None, None)), aux + a

                with tracer.scope(self._scope(i, j)):
                    x, aux = _remat(body, remat)(x, aux)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
        return constrain(self._logits(self.final_norm(x)), ("batch", None, "model")), aux

    def loss(self, batch: dict, *, impl: str = "auto", remat: str = "none") -> torch.Tensor:
        """The reference's training loss of ``batch`` (``tokens`` or
        ``embeds``, ``labels``, and ``enc_embeds`` / ``mrope_positions``
        where the model takes them): the mean NLL of the labels in fp32 over
        the positions whose label is >= 0, plus the auxiliary loss."""
        logits, aux = self.forward_train(
            batch.get("tokens"), embeds=batch.get("embeds"),
            enc_embeds=batch.get("enc_embeds"), mrope_positions=batch.get("mrope_positions"),
            impl=impl, remat=remat)
        return masked_nll(logits, torch.as_tensor(batch["labels"], device=logits.device)) + aux

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.embed.attend(x) if self.cfg.tie_embeddings else self.lm_head(x)

    def prefill(self, tokens: torch.Tensor | None = None, *, embeds=None, enc_embeds=None,
                mrope_positions=None, impl: str = "auto", max_len: int | None = None):
        """Process a prompt, tokens (B, S) or ``embeds`` (B, S, d) with
        optional M-RoPE streams (3, B, S) -> (last-position logits (B, 1,
        vocab), caches, context): each group's states, leaves stacked (n, B,
        ...), and an enc-dec model's ``encode(enc_embeds)`` (else None).
        Keys and values are padded with zeros to ``cap = max_len`` (default
        S), or cut to it, or in a local window laid out as its ring of
        ``min(window, max_len)`` rows, as the reference's ``_to_capacity``."""
        x, positions = self._inputs(tokens, embeds, mrope_positions)
        B, S = x.shape[:2]
        context = self.encode(enc_embeds, impl=impl) if self.cfg.is_encdec else None
        # the residual stream pinned as ``forward_train`` pins it: on a mesh
        # DTensor would otherwise carry a row-parallel output's partial sums
        # into the next column-parallel product, which then runs on the
        # whole gathered weight on every model rank
        x = constrain(x, ("batch", None, None))
        caches = []
        for i, group in enumerate(self.layers()):
            t = group[0].block_type
            key = RECURRENT[t][0] if t in RECURRENT else "attn"
            window = None if t in RECURRENT else group[0].attn.window
            ring = key == "attn" and max_len is not None and window is not None
            cap = S if max_len is None else max_len
            kv = _zero_cache(group, B, cap) if key == "attn" and not ring else None
            states = []
            for j, layer in enumerate(group):
                with tracer.scope(self._scope(i, j)):
                    x, st = layer(x, positions=positions, context=context, impl=impl,
                                  return_state=True)
                x = constrain(x, ("batch", None, None))
                st = st[key]
                if kv is not None:  # written into the padded cache at once
                    kv.k[j, :, :min(S, cap)] = st.k[:, :cap]
                    kv.v[j, :, :min(S, cap)] = st.v[:, :cap]
                elif ring:
                    states.append(AttentionCache(*(_ring(a, S, min(window, max_len))
                                                   for a in st)))
                else:
                    states.append(st)
            caches.append({key: kv if kv is not None else type(states[0])(
                *(torch.stack(a) for a in zip(*states)))})
        # the norm over every position, as the reference's (its event counts
        # them all); the last position's logits
        logits = self._logits(self.final_norm(x)[:, -1:])
        return logits, caches, context

    def init_cache(self, batch: int, max_len: int) -> list:
        """Zero decode states for ``max_len`` positions, one a group, each
        leaf (n, batch, ...), beside the weights (``_zero_state``)."""
        return [_zero_state(group, batch, max_len) for group in self.layers()]

    def decode_step(self, token: torch.Tensor, caches: list, cur_len: int, *,
                    context: torch.Tensor | None = None, impl: str = "auto"):
        """token (B, 1), or embeddings (B, 1, d) with ``embed_inputs``, at
        position ``cur_len`` -> (logits (B, 1, vocab), caches), each layer's
        slice of the caches written in place.  An enc-dec model attends to
        all of ``context`` (B, S_enc, d), each layer's cross K/V projected
        from it in this step, as the reference's (whose ``cross_len``
        argument reaches no layer, so the port's step has none)."""
        del impl  # decode attention is plain PyTorch on every tier
        c = self.cfg
        x = token.to(c.dtype) if c.embed_inputs and token.ndim == 3 else self.embed(token)
        if c.is_encdec:
            if context is None:
                raise ValueError(f"{c.name}: an enc-dec decode step needs the context")
            pos = torch.full((x.shape[0], 1), cur_len, dtype=torch.int32, device=x.device)
            x = x + sinusoidal_embedding(pos, c.d_model).to(x.dtype)
        x = constrain(x, ("batch", None, None))  # as ``prefill`` pins it
        for i, (group, cache) in enumerate(zip(self.layers(), caches)):
            (key, stacked), = cache.items()
            for j, layer in enumerate(group):
                st = {key: type(stacked)(*(a[j] for a in stacked))}
                if c.is_encdec:  # no layer scope, as the reference's unrolled enc-dec step
                    x, st = layer.decode(x, st, cur_len,
                                         cross_cache=layer.cross_attn.project_kv(context))
                else:
                    with tracer.scope(self._scope(i, j)):
                        x, st = layer.decode(x, st, cur_len)
                x = constrain(x, ("batch", None, None))
                if key != "attn":  # a recurrent state: its new value into the slice
                    for a, new in zip(stacked, st[key]):
                        a[j].copy_(new)
        return self._logits(self.final_norm(x)), caches

    def _scope(self, i: int, j: int) -> str:
        return f"layer_g{i}_{j}_{self.groups[i][0]}"
