"""Multi-head (GQA) attention layer (``repro.models.layers.attention.Attention``):
self-attention, causal or bidirectional, with RoPE and optional qk-norm;
cross-attention to a context; decode of one token against a KV cache (the
paper's Table III Decode regime).

The forward pass dispatches through ``kernels.flash_attention.ops.attention``
(the CUDA flash-attention kernel on the ``kernel`` tier, causal mask
included); decode through ``ops.decode_attention``, plain PyTorch on every
tier as in the reference.  RoPE rotates q and k only where ``positions`` are
given: the image transformers' ``backbone`` passes none, so their RoPE is a
no-op there, while ``decode`` always rotates at the cache position.

``decode`` writes the new key and value into the cache in place (the
reference's ``dynamic_update_slice`` returns a new cache; copying Parti's
80 caches every token would move 2.7 GB a step) and returns the same cache.
qk-norm (Qwen3) is an RMSNorm over ``head_dim`` on q and k (leaves
``q_norm``, ``k_norm``) after the head split and before RoPE, as the
reference's ``_qk_norm``; a cross-attention decode normalizes q only.
A local window (RecurrentGemma's ``local_attn`` blocks) masks keys more
than ``window - 1`` positions before the query in the prefill (the flash
kernel's window mask); in decode, a cache of at most ``window`` rows is a
ring buffer, as the reference's: row ``cur_len % cap`` takes the new key,
``min(cur_len + 1, cap)`` rows are attended with no further mask (RoPE has
placed every key, and softmax does not depend on the rows' order), and a
longer cache is read through the window mask instead.  With
``mrope_sections`` (Qwen2-VL) q and k rotate by M-RoPE: (3, B, S) positions
as given, or (B, S) ones as three equal streams, so a decode step rotates
at ``cur_len`` in all three, as the reference's.

Each attention call records the reference's event (``_attention_event``),
computed from the caller's ``impl`` string (``tiers.event_impl``): the
``naive`` path counts the materialized (Sq, Skv) traffic, every other the
flash traffic, whatever tier the port runs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import tracer
from repro_torch.kernels import shards
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.tiers import event_impl
from repro_torch.models.layers import rope as rope_lib
from repro_torch.models.layers.basic import Dense
from repro_torch.models.layers.norms import RMSNorm
from repro_torch.nn import Module
from repro_torch.parallel.sharding import constrain, is_dtensor, place

# The TP width the K/V projections' logical axis is chosen for (the
# reference's ``Attention.TP_WIDTH_HINT``).
TP_WIDTH_HINT = 16


class AttentionCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, KVH, D)
    v: torch.Tensor
    # the current length is the caller's (one for the whole batch)


def _attention_event(name, impl, B, Sq, Skv, H, D, dtype, causal, window=None):
    """The reference's attention event; a local window narrower than the
    keys keeps ``window / Skv`` of the pairs."""
    if not tracer.active():
        return
    elem = tracer.dtype_bytes(dtype)
    qkv_bytes = (B * Sq * H * D + 2 * B * Skv * H * D) * elem
    out_bytes = B * Sq * H * D * elem
    frac = 0.5 if causal else 1.0
    if window is not None and Skv > window:
        frac = min(frac, window / Skv)
    flops = 4.0 * B * H * Sq * Skv * D * frac
    if impl == "naive":
        # the (Sq, Skv) similarity matrix makes two fp32 HBM round trips
        # (scores, probabilities): the traffic flash attention removes
        inter = 4.0 * B * H * Sq * Skv * 4 * frac
        traffic = qkv_bytes + out_bytes + inter
    else:
        # flash: K/V are re-streamed once per query block of 512
        kv_repasses = max(1, Sq // 512) * frac
        traffic = qkv_bytes + out_bytes + (2 * B * Skv * H * D * elem) * (kv_repasses - 1)
    tracer.record("attention", name, flops=flops, bytes_hbm=traffic, seq_len=int(Skv),
                  impl=impl, temporal=False, q_len=int(Sq))


class Attention(Module):
    def __init__(self, d_model: int, n_heads: int, head_dim: int, *, n_kv_heads: int | None = None,
                 qkv_bias: bool = False, out_bias: bool = False, qk_norm: bool = False,
                 rope: bool = False, rope_base: float = 10000.0, rope_pct: float = 1.0,
                 mrope_sections: tuple | None = None, causal: bool = False,
                 window: int | None = None, cross: bool = False, dtype=torch.float32,
                 name: str = "attn"):
        super().__init__()
        self.n_heads, self.head_dim, self.cross, self.name = n_heads, head_dim, cross, name
        self.window = window
        self.n_kv_heads = n_heads if n_kv_heads is None else n_kv_heads
        self.rope, self.rope_base, self.rope_pct = rope, rope_base, rope_pct
        self.mrope_sections = mrope_sections
        self.causal, self.dtype = causal, dtype
        # GQA-TP (the reference's ``TP_WIDTH_HINT``): K/V projections with
        # fewer KV heads than the TP width stay replicated over ``model``.
        kv_axis = "kv_heads" if self.n_kv_heads >= TP_WIDTH_HINT else "kv_heads_small"
        self.wq = Dense(d_model, n_heads * head_dim, qkv_bias, dtype, name="wq",
                        axes=("embed", "heads"))
        self.wk = Dense(d_model, self.n_kv_heads * head_dim, qkv_bias, dtype, name="wk",
                        axes=("embed", kv_axis))
        self.wv = Dense(d_model, self.n_kv_heads * head_dim, qkv_bias, dtype, name="wv",
                        axes=("embed", kv_axis))
        self.wo = Dense(n_heads * head_dim, d_model, out_bias, dtype, name="wo",
                        axes=("heads", "embed"))
        self.qk_norm = qk_norm
        if qk_norm:
            self.q_norm = RMSNorm(head_dim, dtype=dtype)
            self.k_norm = RMSNorm(head_dim, dtype=dtype)

    def _heads(self, t: torch.Tensor, n: int) -> torch.Tensor:
        if is_dtensor(t) and n % shards.shard_count(t, -1):
            # a projection sharded over more ranks than it has heads: DTensor
            # carries no shard into the head axis, so it is gathered first
            t = constrain(t, ("batch", None, None))
        return t.reshape(t.shape[0], t.shape[1], n, self.head_dim)

    def _rope(self, x: torch.Tensor, positions: torch.Tensor | None) -> torch.Tensor:
        if positions is None or not self.rope:
            return x
        if self.mrope_sections is not None:
            if positions.ndim == 2:
                positions = rope_lib.text_mrope_positions(positions)
            return rope_lib.apply_mrope(x, positions, self.mrope_sections, base=self.rope_base)
        return rope_lib.apply_rope(x, positions, base=self.rope_base, rotary_pct=self.rope_pct)

    def project_kv(self, src: torch.Tensor) -> AttentionCache:
        """Keys and values of ``src`` (B, S, d_model), unrotated: the cross
        cache a decode loop computes once from its context."""
        return AttentionCache(self._heads(self.wk(src), self.n_kv_heads),
                              self._heads(self.wv(src), self.n_kv_heads))

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor | None = None,
                context: torch.Tensor | None = None, impl: str = "auto",
                return_kv: bool = False):
        """x (B, S, d_model) -> (B, S, d_model); with ``return_kv`` also the
        (rotated) keys and values, the cache a prefill leaves."""
        B, S, _ = x.shape
        q = self._heads(self.wq(x), self.n_heads)
        k, v = self.project_kv(context if self.cross else x)
        # pin batch x head sharding on the projections, as the reference
        q = constrain(q, ("batch", None, "model", None))
        kv_spec = ("batch", None, "model" if self.n_kv_heads >= TP_WIDTH_HINT else None, None)
        k, v = constrain(k, kv_spec), constrain(v, kv_spec)
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        if not self.cross:
            q, k = self._rope(q, positions), self._rope(k, positions)
        causal = self.causal and not self.cross
        out = attn_ops.attention(q, k, v, causal=causal, window=self.window, impl=impl)
        _attention_event(self.name, event_impl(impl), B, S, k.shape[1], self.n_heads,
                         self.head_dim, x.dtype, causal, self.window)
        y = self.wo(out.reshape(B, S, self.n_heads * self.head_dim))
        return (y, AttentionCache(k, v)) if return_kv else y

    # -- decode (one token against a cache) --------------------------------

    def init_cache(self, batch: int, max_len: int, dtype=None) -> AttentionCache:
        """Zeros (batch, max_len, KVH, D) beside the weights."""
        shape = (batch, max_len, self.n_kv_heads, self.head_dim)
        kw = dict(dtype=dtype or self.dtype, device=self.wq.kernel.device)
        spec = ("batch", None, None, None)
        return AttentionCache(place(torch.zeros(shape, **kw), spec),
                              place(torch.zeros(shape, **kw), spec))

    def decode(self, x: torch.Tensor, cache: AttentionCache | None, cur_len: int, *,
               cross_cache: AttentionCache | None = None, cross_len=None):
        """x (B, 1, d_model), ``cur_len`` tokens already in ``cache`` ->
        (y, cache).  Self-attention rotates q and the new k at ``cur_len``,
        writes k and v at row ``cur_len`` (cast to the cache's dtype) and
        attends to ``cur_len + 1`` rows, or, in a window's ring buffer, at
        row ``cur_len % cap`` and to ``min(cur_len + 1, cap)`` rows;
        cross-attention attends to the first ``cross_len`` rows (an int, or
        one length a request; default all) of the precomputed
        ``cross_cache`` and leaves ``cache`` as it is."""
        B = x.shape[0]
        q = self._heads(self.wq(x), self.n_heads)
        if self.cross:
            if cross_cache is None:
                raise ValueError("cross-attention decode needs a cross_cache")
            if self.qk_norm:
                q = self.q_norm(q)
            kv_len = cross_cache.k.shape[1] if cross_len is None else cross_len
            out = attn_ops.decode_attention(q, cross_cache.k, cross_cache.v, kv_len=kv_len)
            _attention_event(self.name, "decode", B, 1, cross_cache.k.shape[1], self.n_heads,
                             self.head_dim, x.dtype, False)
            return self.wo(out.reshape(B, 1, self.n_heads * self.head_dim)), cache
        k_new, v_new = self.project_kv(x)
        if self.qk_norm:
            q, k_new = self.q_norm(q), self.k_norm(k_new)
        pos = torch.full((B, 1), cur_len, dtype=torch.int32, device=x.device)
        q, k_new = self._rope(q, pos), self._rope(k_new, pos)
        cap = cache.k.shape[1]
        if self.window is not None and cap <= self.window:  # the ring buffer
            row, kv_len, window = cur_len % cap, min(cur_len + 1, cap), None
        else:
            row, kv_len, window = cur_len, cur_len + 1, self.window
        cache.k[:, row] = k_new[:, 0].to(cache.k.dtype)
        cache.v[:, row] = v_new[:, 0].to(cache.v.dtype)
        out = attn_ops.decode_attention(q, cache.k, cache.v, kv_len=kv_len, window=window)
        _attention_event(self.name, "decode", B, 1, cap, self.n_heads, self.head_dim, x.dtype,
                         True, self.window)
        return self.wo(out.reshape(B, 1, self.n_heads * self.head_dim)), cache
