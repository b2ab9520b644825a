"""LM workload: ``TransformerLM`` behind the ``GenerativeWorkload`` protocol,
the port of ``repro.workload.lm``.

The paper's text baseline (LLaMA2-7B) in the Table III Prefill / Decode
regime, as two stages: ``prefill`` processes the prompt once and leaves the
KV caches padded to ``S + max_new``; ``decode`` runs ``max_new`` steps from
``cur = S``.  The paper's workload is a 2048-token prompt and 64 new tokens.

The next token is the greedy argmax at temperature 0, and above it a
Gumbel-max draw (an exact sample of ``softmax(logits / T)``) per request: a
request's ``t``-th sampled token of a stage takes the ``t``-th draw of its
own ``stage_generator(seed, rid, stage_index)`` (prefill: stage 0, decode:
stage 1), drawn on the CPU, so a seed gives the same draws on every device
and in every batch.  A stage draws its whole budget as one block and sends
it to the device once; the draws are sequential, so row ``t`` does not
depend on the budget.  The reference's ``jax.random.categorical`` bits are not
reproduced: sampled tokens agree with it in distribution only.

Characterization (``trace_events``) follows the paper's profile, as the
reference's: a 2048-token prefill once, then decode steps at 4 sampled cache
lengths, each scaled to its share of the 64 new tokens.

The VLM (qwen2-vl-2b) runs these stages on token prompts, as the
reference's does (three equal M-RoPE streams).  An enc-dec model (whisper)
has no prompt for its encoder here: the stages carry no ``enc_embeds``, and
its prefill raises, as the reference's fails; it runs through the model's
own entry points (``launch/steps.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import reduced
from repro_torch.configs.base import LMConfig
from repro_torch.core import characterize, tracer
from repro_torch.models.transformer import TransformerLM
from repro_torch.parallel.sharding import whole
from repro_torch.parallel.mesh_exec import run_stage_on_mesh
from repro_torch.workload.base import (
    CostDescriptor,
    GenerativeWorkload,
    Stage,
    register_workload,
    tree_map,
)

TRACE_PREFILL = 2048  # paper workload: a 2k prompt
TRACE_DECODE = 64  # + 64 generated tokens
TRACE_BATCH = 1  # the paper profiles single-request inference


@register_workload(LMConfig)
class LMWorkload(GenerativeWorkload):
    route = "lm"
    modality = "text"

    def build_model(self, cfg: LMConfig) -> TransformerLM:
        return TransformerLM(cfg)

    def reduced(self) -> LMConfig:
        return reduced(self.cfg)

    @property
    def prompt_vocab(self) -> int:
        return self.cfg.vocab

    @property
    def max_prompt_len(self) -> int:
        return TRACE_PREFILL

    def generate(self, params, tokens, seed: int, *, max_new_tokens=TRACE_DECODE,
                 **kw) -> torch.Tensor:
        """``GenerativeWorkload.generate`` with the paper's 64-token decode
        budget as the default."""
        return super().generate(params, tokens, seed, max_new_tokens=max_new_tokens, **kw)

    def cost_descriptor(self) -> CostDescriptor:
        return CostDescriptor(arch=self.cfg.name, route=self.route, stages=(
            Stage("prefill", 1, TRACE_PREFILL),
            # decode demand grows with the KV cache (Fig. 7 linear ramp)
            Stage("decode", TRACE_DECODE, 1,
                  demand=tuple(TRACE_PREFILL + i for i in range(TRACE_DECODE)))))

    def init_stage_state(self, tokens, device, *, max_new_tokens: int = 0) -> dict:
        return {"tokens": torch.as_tensor(tokens, dtype=torch.int64).to(device),
                "max_new": torch.tensor(int(max_new_tokens), device=device)}

    @staticmethod
    def _gumbel(gens: list, steps: int, vocab: int, device) -> torch.Tensor:
        """(B, steps, V) Gumbel noise ``-log(-log(u))``: row ``t`` of request
        ``b`` from the ``t``-th V uniforms of ``gens[b]``, drawn on the CPU
        as one block and copied to ``device`` once."""
        u = torch.stack([torch.rand(steps, vocab, generator=g) for g in gens])
        gumbel = -torch.log(-torch.log(u))
        if torch.device(device).type == "cuda":  # asynchronous: the host runs on ahead
            gumbel = gumbel.pin_memory().to(device, non_blocking=True)
        return gumbel

    @staticmethod
    def _next_token(logits: torch.Tensor, temperature: float = 0.0,
                    gumbel: torch.Tensor | None = None) -> torch.Tensor:
        """(B, V) logits -> (B, 1) tokens.  Greedy at temperature 0: the
        first maximum of each row, as ``jnp.argmax``.  Above it, Gumbel-max:
        the argmax of ``logits / T`` plus ``gumbel``, one (B, V) row of
        :meth:`_gumbel`.  The vocab dim is named by its index: DTensor's
        argmax over a sharded vocab mis-shapes its gather for ``-1``
        where a rank holds one row."""
        if temperature <= 0.0:
            return logits.argmax(1)[:, None]
        return (logits.float() / temperature + gumbel).argmax(1)[:, None]

    def run_stage(self, params, stage, state, gens, *, impl="auto", temperature=0.0, mesh=None):
        if mesh is not None:
            return run_stage_on_mesh(self, params, stage, state, gens, impl=impl,
                                     temperature=temperature, mesh=mesh)
        if stage.name == "prefill":
            if self.cfg.is_encdec:
                raise ValueError(
                    f"{self.cfg.name}: the LM workload's stages carry no enc_embeds, so an "
                    "enc-dec model cannot prefill through them (the reference's fails there "
                    "too); drive the model's encode / prefill(enc_embeds=) / "
                    "decode_step(context=) (launch/steps.py)")
            toks = state["tokens"]
            B, S = toks.shape
            cap = S + int(whole(state["max_new"]).max())
            logits, caches, _ = params.prefill(toks, impl=impl, max_len=cap)
            gumbel = (self._gumbel(gens, 1, logits.shape[-1], toks.device)[:, 0]
                      if temperature > 0.0 else None)
            # decode starts at the prompt's end (the bucket's, on the lm
            # route).  The caches (n, B, cap, ...) go batch-axis first as views,
            # so that a pipeline can split and restack them per request
            return {"max_new": state["max_new"],
                    "next_tok": self._next_token(logits[:, -1], temperature, gumbel),
                    "cur": torch.full((B,), S, device=toks.device),
                    "caches": tree_map(lambda a: a.movedim(1, 0), caches)}
        if stage.name == "decode":
            # layer-first views again: decode_step writes each row in place
            caches = tree_map(lambda a: a.movedim(0, 1), state["caches"])
            nxt, cur = state["next_tok"], int(whole(state["cur"])[0])
            steps = int(whole(state["max_new"]).max())
            gumbel = (self._gumbel(gens, steps, self.cfg.vocab, nxt.device)
                      if temperature > 0.0 else None)
            out = []
            for t in range(steps):
                out.append(nxt)
                logits, caches = params.decode_step(nxt, caches, cur, impl=impl)
                nxt = self._next_token(logits[:, 0], temperature,
                                       None if gumbel is None else gumbel[:, t])
                cur += 1
            tokens = (torch.cat(out, dim=1) if out
                      else torch.zeros((nxt.shape[0], 0), dtype=torch.int64, device=nxt.device))
            return {"max_new": state["max_new"], "out": tokens}
        raise ValueError(f"unknown LM stage {stage.name!r}")

    def trace_inputs(self) -> tuple:
        return (torch.empty((TRACE_BATCH, TRACE_PREFILL), dtype=torch.int64, device="meta"),)

    def trace_events(self, impl: str = "auto") -> list:
        """Prefill once, then decode steps at 4 sampled cache lengths
        ``S + i * NEW // 4`` (a cache of ``cur + 1`` rows), each scaled by
        ``NEW // 4``; events renamed ``prefill/...`` and ``decode/...``, the
        stage scopes ``generate`` opens."""
        model = characterize.abstract_params(self.model)
        S, NEW = TRACE_PREFILL, TRACE_DECODE
        (toks,) = self.trace_inputs()
        ev = [dataclasses.replace(e, name=f"prefill/{e.name}")
              for e in characterize.trace_workload(
                  lambda p, t: p.prefill(t, impl=impl, max_len=S + NEW), model, toks)]
        sample_points = 4
        for i in range(sample_points):
            cur = S + i * (NEW // sample_points)
            tok1 = torch.empty((TRACE_BATCH, 1), dtype=torch.int64, device="meta")
            step_ev = characterize.trace_workload(
                lambda p, t, cur=cur: p.decode_step(t, p.init_cache(TRACE_BATCH, cur + 1), cur,
                                                    impl=impl), model, tok1)
            ev += tracer.scale_events([dataclasses.replace(e, name=f"decode/{e.name}")
                                       for e in step_ev], NEW // sample_points)
        return ev

    def stage_group_key(self, stage, state):
        # decode batches may only merge requests at the same cache position
        return int(state["cur"]) if stage.name == "decode" else None

    def stage_output(self, state: dict):
        return state["out"][: int(state["max_new"])]
