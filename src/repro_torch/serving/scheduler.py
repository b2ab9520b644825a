"""Serving schedulers implementing the paper's §V system-design suggestions;
the port of ``repro.serving.scheduler``.

1. **Sequence-length-bucketed batching** (§V-B: "sequence lengths confine
   themselves to distinct buckets, which could allow future systems to
   tailor hardware towards sequence lengths of interest"):
   ``BucketedScheduler`` groups pending requests by padded-length bucket so
   each compiled step shape serves a homogeneous batch — no recompiles, no
   padding waste beyond the bucket quantum.

2. **Staggered denoising pods** (§V-A: "different denoising steps of the
   diffusion process could be staggered to allow for maximum memory
   bandwidth utilization"): ``DenoisePodScheduler`` co-schedules a pod of
   diffusion requests whose denoising indices are offset, so at any instant
   the pod mixes UNet stages with different sequence lengths (U-shape
   phases) — leveling instantaneous memory-bandwidth demand instead of
   having all requests hit the seq-4096 stage simultaneously.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Any


@dataclasses.dataclass
class Request:
    rid: int
    prompt_len: int
    max_new_tokens: int = 0  # LM decode budget
    denoise_steps: int = 0  # diffusion requests
    arrived_at: float = 0.0
    state: Any = None


def bucket_of(length: int, buckets: tuple) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


class BucketedScheduler:
    """Groups requests into per-length-bucket batches (paper §V-B)."""

    def __init__(self, buckets: tuple = (128, 512, 1024, 2048, 4096),
                 max_batch: int = 8):
        self.buckets = tuple(sorted(buckets))
        self.max_batch = max_batch
        self.queues: dict[int, deque] = defaultdict(deque)

    def submit(self, req: Request) -> None:
        self.queues[bucket_of(req.prompt_len, self.buckets)].append(req)

    def pending(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def next_batch(self) -> tuple[int, list]:
        """Returns (bucket, requests). Fullest bucket first (highest
        utilization of its compiled shape)."""
        best = None
        for b, q in self.queues.items():
            if q and (best is None or len(q) > len(self.queues[best])):
                best = b
        if best is None:
            return 0, []
        q = self.queues[best]
        batch = [q.popleft() for _ in range(min(self.max_batch, len(q)))]
        return best, batch

    def padding_waste(self, batch: list, bucket: int) -> float:
        """Fraction of padded tokens in this batch — the §V-B metric."""
        if not batch:
            return 0.0
        used = sum(r.prompt_len for r in batch)
        return 1.0 - used / (bucket * len(batch))


class DenoisePodScheduler:
    """Staggers diffusion requests inside a 'pod' (paper §V-A).

    With stagger k over pod size P, request i executes denoise index
    (t + i*k) mod total_steps at tick t, so the pod's instantaneous mix of
    UNet phases is uniform.  ``bandwidth_profile`` lets the benchmark show
    peak-vs-mean HBM-demand flattening against the naive aligned schedule.

    Online serving adds an arrival-time-aware flush: a partial pod whose
    oldest request has waited ``max_wait`` scheduling ticks is flushed by
    :meth:`flush_stale` instead of blocking on arrivals that may be ticks
    away (the continuous-admission policy, ``docs/serving.md``).  Flushing
    *moves* the open requests into the pod queue exactly once — an
    early-flushed pod's membership is frozen at flush time, so later
    arrivals open a fresh pod and ``schedule``/``bandwidth_profile`` count
    each request's stagger offset exactly once (regression-tested; a
    flush that aliased the open list would double-count the flushed pod's
    offsets in the §V-A profile once the list refilled).
    """

    def __init__(self, pod_size: int = 4, total_steps: int = 50):
        if total_steps < 1:
            raise ValueError(f"total_steps must be >= 1, got {total_steps}")
        self.pod_size = pod_size
        self.total_steps = total_steps
        self.pods: deque[list[Request]] = deque()
        self._open: list[Request] = []

    def submit(self, req: Request) -> None:
        self._open.append(req)
        if len(self._open) == self.pod_size:
            self.pods.append(self._open)
            self._open = []

    def flush(self) -> None:
        if self._open:
            self.pods.append(self._open)
            self._open = []

    def flush_stale(self, now: float, max_wait: float) -> bool:
        """Arrival-pressure flush: close the open partial pod when its
        oldest request has waited ``max_wait`` ticks.  Returns True when a
        pod was flushed; idempotent (a second call in the same tick finds
        the open list empty and is a no-op)."""
        if not self._open:
            return False
        if now - min(r.arrived_at for r in self._open) < max_wait:
            return False
        self.flush()
        return True

    def open_size(self) -> int:
        """Requests waiting in the open (not yet flushed) partial pod."""
        return len(self._open)

    def pending(self) -> int:
        return sum(len(p) for p in self.pods) + len(self._open)

    def next_pod(self) -> list:
        """Pop the next pod to serve (flushing a partial pod if that is all
        that remains) — drain semantics.  Online admission uses
        :meth:`pop_pod` + :meth:`flush_stale` so a partial pod can keep
        waiting for imminent arrivals instead."""
        if not self.pods:
            self.flush()
        return self.pods.popleft() if self.pods else []

    def pop_pod(self) -> list:
        """Pop a closed pod without flushing the open partial one."""
        return self.pods.popleft() if self.pods else []

    def schedule(self, pod: list) -> list[list[int]]:
        """Per-tick denoise-step indices, staggered.

        Offsets spread evenly over the step range, so a pod larger than
        ``total_steps`` degrades gracefully to near-uniform multiplicity
        per offset instead of silently collapsing to stagger 1."""
        n = max(len(pod), 1)
        offsets = [(i * self.total_steps) // n for i in range(n)]
        ticks = []
        for t in range(self.total_steps):
            ticks.append([(t + off) % self.total_steps for off in offsets])
        return ticks

    @staticmethod
    def bandwidth_profile(step_demands: list, schedule: list[list[int]]) -> dict:
        """step_demands[i] = relative HBM demand of denoise step i (from the
        per-step sequence-length profile).  Returns peak/mean for the
        staggered schedule vs the aligned baseline."""
        n = len(schedule[0])
        aligned_peaks = [step_demands[t % len(step_demands)] * n
                         for t in range(len(schedule))]
        staggered_peaks = [
            sum(step_demands[s % len(step_demands)] for s in tick)
            for tick in schedule
        ]
        mean = sum(aligned_peaks) / len(aligned_peaks)
        return {
            "aligned_peak": max(aligned_peaks),
            "staggered_peak": max(staggered_peaks),
            "mean": mean,
            "peak_reduction": max(aligned_peaks) / max(staggered_peaks),
        }
