"""Sequence-length profiling over the course of inference (paper §V, Fig.
7/8), the port of ``repro.core.seq_profile``.

Reads the tracer's event stream: each attention event carries its sequence
length in call order, the paper's method of recording the sequence length at
every attention call.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

from repro_torch.core.tracer import OpEvent


@dataclasses.dataclass
class SeqProfile:
    seq_lens: list  # per attention call, in call order (Fig. 7)
    histogram: dict  # seq_len -> weighted count (Fig. 8)
    min_seq: int
    max_seq: int

    @property
    def variation(self) -> float:
        """The paper's headline: the sequence length varies up to 4x."""
        return self.max_seq / max(self.min_seq, 1)


def profile(events: list[OpEvent], *, include_cross: bool = True) -> SeqProfile:
    seqs = []
    hist: Counter = Counter()
    for e in events:
        if e.op != "attention" or e.seq_len is None:
            continue
        if not include_cross and e.meta.get("q_len") != e.seq_len:
            continue
        seqs.append(e.seq_len)
        hist[e.seq_len] += e.repeats
    if not seqs:
        return SeqProfile([], {}, 0, 0)
    return SeqProfile(seqs, dict(hist), min(seqs), max(seqs))


def self_attention_profile(events: list[OpEvent]) -> SeqProfile:
    """Only self-attention calls (q_len == kv_len): the Fig. 7 U-shape."""
    selfish = [
        e for e in events
        if e.op == "attention" and e.seq_len is not None
        and e.meta.get("q_len") == e.seq_len
    ]
    return profile(selfish)


def fundamental_period(seqs: list[int]) -> list[int]:
    """Smallest repeating prefix of the call-order profile (the paper
    truncates Fig. 7 to each model's fundamental period)."""
    n = len(seqs)
    for p in range(1, n + 1):
        if n % p == 0 and seqs == seqs[:p] * (n // p):
            return seqs[:p]
    return seqs
