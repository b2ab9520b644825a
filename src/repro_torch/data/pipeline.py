"""Deterministic synthetic data pipeline, the port of
``repro.data.pipeline``: the same numpy code, so ``batch_at(step)`` gives
the reference's arrays for a (seed, step, host).

  * **Step-indexed determinism**: ``batch_at(step)`` is a pure function of
    (seed, step, host), so a restart repeats the stream with no data lost
    or repeated.
  * **Host sharding**: each host makes only its slice of the global batch.
  * **Prefetch**: a background thread keeps ``depth`` batches ahead, and
    with a ``device`` moves each onto it as tensors (the reference's
    ``shardings``).

Token streams mix Zipf unigrams with a repeated 8-gram motif, so the loss
is learnable; TTI latents are Gaussian with text-conditioned means.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticLMData:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, self.host_id]))
        B, S, V = self.host_batch, self.seq_len, self.vocab
        # Zipf unigrams, clipped to the vocab
        base = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
        tokens = np.minimum(base, V - 1).astype(np.int32)
        # learnable structure: every sequence repeats an 8-gram motif
        motif = rng.integers(0, V, size=(B, 8), dtype=np.int32)
        for rep in range(1, (S + 1) // 16):
            pos = rep * 16
            tokens[:, pos:pos + 8] = motif
        return {"tokens": tokens[:, :S], "labels": tokens[:, 1:S + 1]}


@dataclasses.dataclass(frozen=True)
class SyntheticTTIData:
    """(latents, text tokens) pairs for diffusion training."""

    latent_hw: int
    latent_ch: int
    text_vocab: int
    text_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.n_hosts

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, self.host_id]))
        B = self.host_batch
        text = rng.integers(0, self.text_vocab, size=(B, self.text_len), dtype=np.int32)
        # latents whose channel means are a function of the text: a
        # learnable conditional signal for the denoiser
        cond = (text.sum(axis=1, keepdims=True) % 7).astype(np.float32) / 7.0
        lat = rng.normal(size=(B, self.latent_hw, self.latent_hw, self.latent_ch))
        lat = (lat + cond[:, :, None, None]).astype(np.float32)
        return {"latents": lat, "text": text}


def make_batch_iterator(source, *, start_step: int = 0, depth: int = 2,
                        device=None) -> Iterator[dict]:
    """Prefetching iterator over ``source.batch_at(step)`` from
    ``start_step``: numpy arrays, or tensors on ``device`` where given."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            batch = source.batch_at(step)
            if device is not None:
                batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            while not stop.is_set():
                try:
                    q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
