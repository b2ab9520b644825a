"""Mixture-of-Experts FFN (``repro.models.layers.moe.MoE``): shared and
routed experts, top-k routing, capacity-bounded scatter dispatch.

Covers qwen3-moe (128 routed experts, top-8, no shared) and deepseek-moe (64
routed, top-6, 2 shared, fine-grained d_ff).  The computation is the
reference's, step for step:

  - router logits and their softmax in fp32 (the router leaf is fp32 in
    every model dtype), then the top k, lower expert index first on ties as
    ``jax.lax.top_k`` (a stable descending sort: ``torch.topk`` promises no
    order on ties); with ``norm_topk`` the k probabilities renormalized;
  - the Switch auxiliary loss on each token's first choice;
  - capacity ``ceil(T * k / E * capacity_factor)`` per expert, or ``T * k``
    with ``no_drop`` (decode); each assignment's position in its expert is
    the count of earlier assignments to it in token-major, then k, order,
    and one at or past capacity goes to the sink row ``E * C``;
  - the tokens scattered into an ``(E * C + 1, d)`` buffer, three batched
    expert products on ``(E, C, d)`` (``torch.bmm``: the reference's
    ``einsum``, outside any Pallas kernel), gathered back weighted by
    ``top_p * keep`` (a dropped assignment gives 0, and the rest are not
    renormalized), plus the shared experts' dense path.

The reference's sharding calls (``constrain``, ``concat_unsharded``) pin
expert parallelism on a mesh; on one card they are no-ops and are left out.

Routing, scatter and gather run under the tracer scope ``{name}_dispatch``,
which opens a ``record_function`` range only while a profile runs: the
card's profile reader (``core.profiler_analysis.by_category``) counts the
device time launched there as ``dispatch``, the category the reference adds
to the paper's taxonomy for MoE.  The events are the reference's three:
``linear {name}_experts``, ``linear {name}_shared`` (with shared experts) and
``dispatch {name}_dispatch``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import tracer
from repro_torch.models.layers.mlp import _ACTS
from repro_torch.nn import Module, scaled_init


def top_k_lower_index_first(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values and their
    indices, in descending order, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _position_in_expert(eid: torch.Tensor, n_experts: int) -> torch.Tensor:
    """For each assignment of the flat ``eid`` (its expert), the number of
    earlier assignments to the same expert: the reference's exclusive cumsum
    of the one-hot assignments down the (T k, E) matrix, computed from a
    stable sort by expert instead.  (On an H100 the scan down that matrix
    took 4.6 ms a layer of deepseek-moe-16b's 2 x 2048-token prefill, a
    fifth of the prefill.)"""
    order = torch.argsort(eid, stable=True)  # by expert, in flat order within one
    count = F.one_hot(eid, n_experts).sum(dim=0)
    first = torch.cumsum(count, dim=0) - count  # each expert's first row in ``order``
    pos = torch.empty_like(eid)
    pos[order] = torch.arange(eid.numel(), device=eid.device) - first[eid[order]]
    return pos


class MoE(Module):
    def __init__(self, d_model: int, d_ff_expert: int, n_experts: int, top_k: int, *,
                 n_shared: int = 0, d_ff_shared: int = 0, capacity_factor: float = 1.25,
                 activation: str = "silu", router_aux_weight: float = 0.01,
                 norm_topk: bool = True, dtype=torch.float32, name: str = "moe"):
        super().__init__()
        self.d_model, self.d_ff_expert, self.n_experts, self.top_k = (
            d_model, d_ff_expert, n_experts, top_k)
        self.n_shared, self.capacity_factor = n_shared, capacity_factor
        self.act = _ACTS[activation]
        self.router_aux_weight, self.norm_topk, self.name = router_aux_weight, norm_topk, name
        # d_ff_shared defaults to n_shared * d_ff_expert, as the reference's
        self.shared_ff = d_ff_shared or n_shared * d_ff_expert
        E, d, f = n_experts, d_model, d_ff_expert
        self.param("router", (d, E), scaled_init((0,)), torch.float32)
        self.param("wi", (E, d, f), scaled_init((1,)), dtype)
        self.param("wg", (E, d, f), scaled_init((1,)), dtype)
        self.param("wo", (E, f, d), scaled_init((1,)), dtype)
        if n_shared > 0:
            sf = self.shared_ff
            self.param("shared_wi", (d, sf), scaled_init((0,)), dtype)
            self.param("shared_wg", (d, sf), scaled_init((0,)), dtype)
            self.param("shared_wo", (sf, d), scaled_init((0,)), dtype)

    def capacity(self, tokens: int, no_drop: bool = False) -> int:
        """Rows per expert for ``tokens`` tokens: every assignment fits with
        ``no_drop``."""
        if no_drop:
            return tokens * self.top_k
        return int(math.ceil(tokens * self.top_k / self.n_experts * self.capacity_factor))

    def route(self, xt: torch.Tensor):
        """xt (T, d) -> (probs (T, E), top_p (T, k), top_i (T, k)), in fp32;
        ``top_p`` renormalized with ``norm_topk``."""
        probs = torch.softmax(xt.float() @ self.router, dim=-1)
        top_p, top_i = top_k_lower_index_first(probs, self.top_k)
        if self.norm_topk:
            top_p = top_p / top_p.sum(dim=-1, keepdim=True)
        return probs, top_p, top_i

    def forward(self, x: torch.Tensor, no_drop: bool = False):
        """x (B, S, d) -> (y (B, S, d), the auxiliary loss)."""
        B, S, d = x.shape
        T, E, k = B * S, self.n_experts, self.top_k
        xt = x.reshape(T, d)
        C = self.capacity(T, no_drop)
        with tracer.scope(f"{self.name}_dispatch"):
            probs, top_p, top_i = self.route(xt)
            # load-balance auxiliary loss (Switch-style), on the first choice
            ce = F.one_hot(top_i[:, 0], E).float().mean(dim=0)
            aux = self.router_aux_weight * E * torch.sum(probs.mean(dim=0) * ce)
            eid = top_i.reshape(T * k)
            pos = _position_in_expert(eid, E)
            keep = pos < C
            dest = torch.where(keep, eid * C + pos, E * C)
            buf = x.new_zeros((E * C + 1, d))
            buf[dest] = xt.repeat_interleave(k, dim=0)
            expert_in = buf[:-1].view(E, C, d)
        h = torch.bmm(expert_in, self.wi.to(x.dtype))
        g = torch.bmm(expert_in, self.wg.to(x.dtype))
        expert_out = torch.bmm(self.act(g) * h, self.wo.to(x.dtype))  # (E, C, d)
        with tracer.scope(f"{self.name}_dispatch"):
            out_flat = torch.cat([expert_out.reshape(E * C, d), x.new_zeros((1, d))])
            weights = (top_p.reshape(T * k) * keep).to(x.dtype)
            y = (out_flat[dest] * weights[:, None]).reshape(T, k, d).sum(dim=1)
        if self.n_shared > 0:  # the shared experts' always-on dense path (DeepSeekMoE)
            sh = self.act(xt @ self.shared_wg.to(x.dtype)) * (xt @ self.shared_wi.to(x.dtype))
            y = y + sh @ self.shared_wo.to(x.dtype)
        if tracer.active():
            self._record(T, C, x.dtype)
        return y.reshape(B, S, d), aux

    def _record(self, T: int, C: int, dtype) -> None:
        """The three events the reference's ``MoE.__call__`` records."""
        E, d, f, k = self.n_experts, self.d_model, self.d_ff_expert, self.top_k
        tracer.record("linear", f"{self.name}_experts", flops=2.0 * E * C * d * f * 3,
                      bytes_hbm=tracer.nbytes(((E, C, d), dtype)) * 2
                      + tracer.nbytes(((E, d, f), dtype)) * 3)
        if self.n_shared > 0:
            sf = self.shared_ff
            tracer.record("linear", f"{self.name}_shared", flops=2.0 * T * d * sf * 3,
                          bytes_hbm=tracer.nbytes(((T, d), dtype)) * 2
                          + tracer.nbytes(((d, sf), dtype)) * 3)
        # the router matmul is tiny; scatter + gather traffic and the (T, E) probabilities
        tracer.record("dispatch", f"{self.name}_dispatch", flops=2.0 * T * d * E / 1e3,
                      bytes_hbm=tracer.nbytes(((T, d), dtype)) * 2 * k + T * E * 4,
                      seq_len=None)
