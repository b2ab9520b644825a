"""Prefill/Decode correspondence of TTI workloads (paper Table III), the port
of ``repro.core.prefill_decode``.

Classifies a traced workload by its attention-call geometry:
  * prefill-like -- q_len == kv_len >> 1 (all positions at once: diffusion
    models generate every pixel each step)
  * decode-like  -- q_len == 1 against a long KV (autoregressive transformer
    TTI, e.g. Parti)
  * mixed        -- both regimes present (LLM generation)
"""

from __future__ import annotations

from repro_torch.core.tracer import OpEvent


def classify(events: list[OpEvent]) -> dict:
    prefill_calls = 0
    decode_calls = 0
    for e in events:
        if e.op != "attention" or e.seq_len is None:
            continue
        q = e.meta.get("q_len", e.seq_len)
        if q == 1 and e.seq_len > 1:
            decode_calls += e.repeats
        elif q == e.seq_len or q > 1:
            prefill_calls += e.repeats
    total = prefill_calls + decode_calls
    if total == 0:
        return {"regime": "attention-free", "prefill_frac": 0.0}
    frac = prefill_calls / total
    regime = "prefill-like" if frac > 0.9 else (
        "decode-like" if frac < 0.1 else "mixed"
    )
    return {
        "regime": regime,
        "prefill_frac": frac,
        "prefill_calls": prefill_calls,
        "decode_calls": decode_calls,
    }
