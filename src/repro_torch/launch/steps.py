"""Step builders and per-(arch x shape) input specs, the mesh-free part of
``repro.launch.steps``: the entry points that drive a ``TransformerLM``
through its own ``prefill`` / ``decode_step``, with the inputs each model
kind takes.  That is how an enc-dec model (whisper) runs, as in the
reference: the LM workload's stages carry no encoder input.

    step = make_prefill_step(model, cfg, max_len=S_dec + new)
    logits, caches, context = step(batch)         # batch: input_specs' names
    serve = make_serve_step(model, cfg)
    logits, caches = serve(token, caches, cur_len, context=context)

``input_specs(cfg, shape)`` gives the reference's names, shapes and dtypes
as ``meta`` tensors: token ids; embeddings with (3, B, S) M-RoPE streams
(the VLM's stub frontend); frame embeddings with ``dec_len_for`` decoder
tokens (enc-dec); one new token or embedding for decode, with the context
an enc-dec step attends to.

    step = make_train_step(model, cfg, microbatches=2)
    params, opt_state, metrics = step(params, opt_state, batch)

``make_train_step`` is the reference's: the model's loss on its default
``impl="blocked_jax"`` (the port's ``torch`` tier) and ``remat="dots"``,
gradients accumulated in fp32 over ``microbatches``, then AdamW.  ``params``
are the model's own leaves (``nn.trainable``), updated in place.  With a
``mesh`` the leaves are DTensors placed by :func:`param_shardings` (the
active profile's rules: FSDP + TP under ``2d``, ZeRO-3 over the grid under
``fsdp``), each microbatch is sharded over the profile's batch axes, and
the step runs inside ``mesh_scope``.

The mesh layouts, as the reference's: :func:`param_shardings` of a model,
:func:`cache_shardings` of its decode state in the ``decode`` (sequence over
``model``) or ``prefill`` (head dim over ``model``) layout, over the
``meta`` state :func:`abstract_cache` gives.  They take a torch
``DeviceMesh`` or a shape-only ``parallel.sharding.AbstractMesh``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import LMConfig, ShapeSpec
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn import specs_of
from repro_torch.parallel import sharding as shlib
from repro_torch.parallel.mesh_exec import mesh_scope, shard_batch
from repro_torch.training.optimizer import AdamWConfig, adamw_update
from repro_torch.training.trainer import accumulate_grads, split_microbatches


def dec_len_for(cfg: LMConfig, seq_len: int) -> int:
    """Enc-dec (whisper): the decoder's length, ~ seq/8 (the frame-to-token
    ratio), at least 64."""
    return max(64, seq_len // 8)


def input_specs(cfg: LMConfig, shape: ShapeSpec) -> dict:
    """The model's inputs for ``shape`` as ``meta`` tensors, by the names
    ``TransformerLM.prefill`` / ``decode_step`` (and a train step's
    ``labels``) take them."""
    B, S = shape.global_batch, shape.seq_len

    def tok(b, s):
        return torch.empty((b, s), dtype=torch.int32, device="meta")

    def emb(b, s):
        return torch.empty((b, s, cfg.d_model), dtype=cfg.dtype, device="meta")

    batch: dict = {}
    if shape.kind in ("train", "prefill"):
        if cfg.embed_inputs:  # vlm stub frontend
            batch["embeds"] = emb(B, S)
            batch["mrope_positions"] = torch.empty((3, B, S), dtype=torch.int32, device="meta")
        elif cfg.is_encdec:  # audio stub frontend
            batch["enc_embeds"] = emb(B, S)
            batch["tokens"] = tok(B, dec_len_for(cfg, S))
        else:
            batch["tokens"] = tok(B, S)
        if shape.kind == "train":
            batch["labels"] = tok(B, dec_len_for(cfg, S) if cfg.is_encdec else S)
        return batch
    # decode: one new token against a cache of length S
    batch["token"] = emb(B, 1) if cfg.embed_inputs else tok(B, 1)
    if cfg.is_encdec:  # the encoder output the cross-attention reads
        batch["context"] = emb(B, S)
    return batch


def make_prefill_step(model: TransformerLM, cfg: LMConfig, *, impl: str = "auto",
                      max_len: int | None = None):
    """``prefill_step(batch) -> (logits, caches, context)``: the model's
    prefill on ``batch`` (``input_specs``' prefill names), its caches padded
    to ``max_len`` positions for the decode steps that follow, and the
    context an enc-dec model's serve steps take (None otherwise)."""
    del cfg  # the model holds its config

    def prefill_step(batch: dict):
        return model.prefill(batch.get("tokens"), embeds=batch.get("embeds"),
                             enc_embeds=batch.get("enc_embeds"),
                             mrope_positions=batch.get("mrope_positions"), impl=impl,
                             max_len=max_len)

    return prefill_step


def make_serve_step(model: TransformerLM, cfg: LMConfig, *, impl: str = "auto"):
    """``serve_step(token, caches, cur_len, context=None) -> (logits,
    caches)``: one decode step, the caches written in place."""
    del cfg

    def serve_step(token, caches, cur_len: int, context=None):
        return model.decode_step(token, caches, cur_len, context=context, impl=impl)

    return serve_step


def abstract_cache(model: TransformerLM, batch: int, max_len: int) -> list:
    """The model's zero decode state for ``batch`` x ``max_len`` on ``meta``
    (the reference's ``eval_shape`` of ``init_cache``)."""
    bad = [k for k, p in model.named_parameters() if p.device.type != "meta"]
    if bad:
        raise ValueError(f"abstract_cache takes a model built on meta; {bad[0]} is not")
    return model.init_cache(batch, max_len)


def cache_shardings(caches_abs: list, mesh, global_batch: int, layout: str = "decode") -> list:
    """Path-aware shardings of a decode state (a tree like ``caches_abs``):

    ``decode`` layout: KV caches (L, B, S, KVH, D) shard (batch -> data,
    seq -> model), the flash-decoding layout; ``prefill`` layout: (batch ->
    data, head_dim -> model), the layout the TP projection produces.
    SSM / RNN states shard (batch -> data, width -> model) in both.  Dim 1
    shards over the batch axes only where ``global_batch`` divides them,
    as the reference's (which reads the leaf's own batch dim)."""
    ba = shlib.batch_axes(mesh)
    bax = ba if len(ba) > 1 else (ba[0] if ba else None)
    sizes = shlib.mesh_shape(mesh)
    del global_batch  # the reference reads each leaf's own dim 1

    def batch_ok(dim):
        n = 1
        for a in ba:
            n *= sizes[a]
        return dim % n == 0

    def model_ok(dim):
        return "model" in sizes and dim % sizes["model"] == 0

    def spec(kind, shape):
        b = bax if (len(shape) > 1 and batch_ok(shape[1])) else None
        if kind == "attn":  # (L, B, S, KVH, D)
            if layout == "prefill":
                return (None, b, None, None, "model" if model_ok(shape[4]) else None)
            return (None, b, "model" if model_ok(shape[2]) else None, None, None)
        if kind == "ssm":
            if len(shape) == 5:  # (L, B, H, P, N)
                return (None, b, "model" if model_ok(shape[2]) else None, None, None)
            return (None, b, None, "model" if model_ok(shape[-1]) else None)
        if kind == "rnn":
            if len(shape) == 3:  # (L, B, D)
                return (None, b, "model" if model_ok(shape[-1]) else None)
            return (None, b, None, "model" if model_ok(shape[-1]) else None)
        return (None,) * len(shape)

    def group(g):
        (kind, st), = g.items()
        return {kind: type(st)(*(shlib.NamedSharding(mesh, spec(kind, tuple(a.shape)))
                                 for a in st))}

    return [group(g) for g in caches_abs]


def param_shardings(model, mesh) -> dict:
    """``{key: NamedSharding}`` of every leaf under the active profile's
    rules (``parallel.sharding.set_profile``)."""
    return shlib.logical_to_sharding(specs_of(model), model, mesh)


def make_train_step(model: TransformerLM, cfg: LMConfig, mesh=None, *, remat: str = "dots",
                    impl: str = "blocked_jax", opt_cfg: AdamWConfig = AdamWConfig(),
                    microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients over ``microbatches`` slices of
    the batch (axis 0, axis 1 of ``mrope_positions``), averaged in fp32,
    then ``adamw_update``.  With a ``mesh``, ``params`` are the model's
    DTensor leaves (``param_shardings``), each slice is sharded over the
    batch axes, and the step runs in ``mesh_scope``."""
    del cfg  # the model holds its config
    axes = {"mrope_positions": 1}

    def train_step(params: dict, opt_state: dict, batch: dict):
        mbs = split_microbatches(batch, microbatches, axes)
        if mesh is not None:
            mbs = [shard_batch(mb, mesh, axes) for mb in mbs]
        with mesh_scope(mesh):
            loss, grads = accumulate_grads(
                lambda i, mb: model.loss(mb, impl=impl, remat=remat), params, mbs)
            params, opt_state, metrics = adamw_update(params, grads, opt_state, opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
