"""LM workload: ``TransformerLM`` behind the ``GenerativeWorkload`` protocol,
the port of ``repro.workload.lm``.

The paper's text baseline (LLaMA2-7B) in the Table III Prefill / Decode
regime, as two stages: ``prefill`` processes the prompt once and leaves the
KV caches padded to ``S + max_new``; ``decode`` runs ``max_new`` greedy
steps from ``cur = S``.  The paper's workload is a 2048-token prompt and 64
new tokens.  Sampling at ``temperature > 0`` (the reference's seeded
categorical draw per request) comes with the serving slice.
"""

from __future__ import annotations

import torch

from repro_torch.configs import reduced
from repro_torch.configs.base import LMConfig
from repro_torch.models.transformer import TransformerLM
from repro_torch.workload.base import CostDescriptor, GenerativeWorkload, Stage, register_workload

TRACE_PREFILL = 2048  # paper workload: a 2k prompt
TRACE_DECODE = 64  # + 64 generated tokens


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
                 temperature: float = 0.0, **kw) -> torch.Tensor:
        """``GenerativeWorkload.generate`` with the paper's 64-token decode
        budget as the default; greedy only."""
        if temperature > 0.0:
            raise NotImplementedError("sampling at temperature > 0 (a seeded categorical draw "
                                      "per request) comes with the serving slice")
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
    def _next_token(logits: torch.Tensor) -> torch.Tensor:
        """Greedy: the first maximum of each row of (B, V), as ``jnp.argmax``."""
        return logits.argmax(-1)[:, None]

    def run_stage(self, params, stage, state, gens, *, impl="auto"):
        del gens  # greedy decoding draws nothing
        if stage.name == "prefill":
            toks = state["tokens"]
            B, S = toks.shape
            cap = S + int(state["max_new"].max())
            logits, caches = params.prefill(toks, impl=impl, max_len=cap)
            # decode starts at the prompt's end.  The caches stay layer-first
            # (n, B, ...): the decode stage takes them whole, and no pipeline
            # splits this state per request yet (the reference moves the
            # batch axis first for its cascade)
            return {"max_new": state["max_new"], "next_tok": self._next_token(logits[:, -1]),
                    "cur": torch.full((B,), S, device=toks.device), "caches": caches}
        if stage.name == "decode":
            caches = state["caches"]
            nxt, cur = state["next_tok"], int(state["cur"][0])
            out = []
            for _ in range(int(state["max_new"].max())):
                out.append(nxt)
                logits, caches = params.decode_step(nxt, caches, cur, impl=impl)
                nxt = self._next_token(logits[:, 0])
                cur += 1
            tokens = (torch.cat(out, dim=1) if out
                      else torch.zeros((nxt.shape[0], 0), dtype=torch.int64, device=nxt.device))
            return {"max_new": state["max_new"], "out": tokens}
        raise ValueError(f"unknown LM stage {stage.name!r}")

    def stage_output(self, state: dict):
        return state["out"][: int(state["max_new"])]
