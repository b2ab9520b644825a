"""Training loop: microbatched (gradient-accumulation) steps, AdamW, and
checkpoint/restart through the fault-tolerant runner; the port of
``repro.training.trainer``.

The reference's loss takes ``(params, batch, key)``; here a model holds its
leaves, so ``loss_fn(batch, gen) -> scalar`` reads the leaves of ``params``
(``nn.trainable(model)``) and draws its noise from ``gen``.  The
reference carries a ``PRNGKey`` in the checkpointed state and folds the
step into it; the port carries a ``seed`` and derives each step's and
microbatch's CPU ``torch.Generator`` from (seed, step, microbatch)
(``step_generator``, as ``workload.base.stage_generator`` does for a
stage), so a restart draws the same noise on any device.

``train`` takes the data as an iterator (one batch a step, as the
reference) or as a source with ``batch_at(step)`` (``data.pipeline``); a
source is read from the step the run starts at (a restart, a retry), so a
restarted run sees the uninterrupted run's batches.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Callable

import torch

from repro_torch.data import make_batch_iterator
from repro_torch.nn import trainable
from repro_torch.nn.module import _stable_hash
from repro_torch.runtime.fault_tolerance import FaultTolerantRunner, RunnerConfig
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update


def _default_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 300
    microbatches: int = 1  # gradient accumulation factor
    log_every: int = 20
    checkpoint_dir: str = dataclasses.field(default_factory=_default_dir)
    checkpoint_every: int = 100
    seed: int = 0  # of the per-step noise generators
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def step_generator(seed: int, step: int, micro: int = 0) -> torch.Generator:
    """The CPU generator of one microbatch of one step, from (seed, step,
    microbatch) only."""
    return torch.Generator().manual_seed(_stable_hash(f"{int(seed)}/train/{int(step)}/{int(micro)}"))


def split_microbatches(batch: dict, n: int, axes: dict | None = None) -> list[dict]:
    """``n`` equal slices of every leaf of ``batch`` along its batch axis
    (0, or ``axes[key]``)."""
    if n == 1:
        return [batch]
    out = [{} for _ in range(n)]
    for key, v in batch.items():
        v = torch.as_tensor(v)
        ax = (axes or {}).get(key, 0)
        if v.shape[ax] % n:
            raise ValueError(f"{key}: {v.shape[ax]} rows do not split into {n} microbatches")
        for i, part in enumerate(torch.chunk(v, n, dim=ax)):
            out[i][key] = part
    return out


def accumulate_grads(losses: Callable, params: dict, microbatches: list, *,
                     mark: Callable | None = None):
    """``(mean loss, grads)`` over ``microbatches``: ``losses(i, mb)`` is
    the loss of microbatch ``i``; each leaf's gradient comes from
    ``torch.autograd.grad`` (``None`` where the loss does not reach it).
    Several microbatches average their gradients in fp32, as the
    reference's scan over them."""
    keys, leaves = list(params), list(params.values())
    n = len(microbatches)
    acc: list = [None] * len(leaves)
    total = None
    for i, mb in enumerate(microbatches):
        if mark is not None:
            mark("forward")
        loss = losses(i, mb)
        if mark is not None:
            mark("backward")
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        if n == 1:
            acc = list(grads)
        else:
            for j, g in enumerate(grads):
                if g is not None:
                    acc[j] = g.float() / n if acc[j] is None else acc[j] + g.float() / n
        loss = loss.detach()
        total = loss if total is None else total + loss
    return total / n, dict(zip(keys, acc))


def make_accumulating_step(loss_fn: Callable, opt_cfg: AdamWConfig, microbatches: int, *,
                           mark: Callable | None = None):
    """``loss_fn(batch, gen) -> scalar``.  Returns the step
    ``(params, opt_state, batch, seed, step) -> (params, opt_state,
    metrics)``: the batch's leading dim split into ``microbatches`` slices
    whose gradients are averaged, then ``adamw_update`` (in place).
    ``mark(name)``, where given, is called as the forward, the backward
    and the optimizer begin and when the step ends (``"done"``)."""

    def step(params, opt_state, batch, seed, step_index):
        loss, grads = accumulate_grads(
            lambda i, mb: loss_fn(mb, step_generator(seed, step_index, i)), params,
            split_microbatches(batch, microbatches), mark=mark)
        if mark is not None:
            mark("optimizer")
        params, opt_state, metrics = adamw_update(params, grads, opt_state, opt_cfg)
        if mark is not None:
            mark("done")
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


@torch.no_grad()
def _bind(live: dict, values: dict) -> None:
    """A restored state's values into the model's own leaves."""
    for key, p in live.items():
        if values[key] is not p:
            p.copy_(values[key])


def train(model: torch.nn.Module, loss_fn: Callable, data, cfg: TrainConfig, *,
          device=None, log=print, mark: Callable | None = None) -> tuple[Any, list]:
    """Run the fault-tolerant training loop on every leaf of ``model``;
    returns (state, loss history).  ``data``: an iterator of batches, or a
    source with ``batch_at(step)`` read from the run's start (onto
    ``device`` where given)."""
    params = trainable(model)
    step_fn = make_accumulating_step(loss_fn, cfg.opt, cfg.microbatches, mark=mark)
    history: list = []
    runner = FaultTolerantRunner(RunnerConfig(
        checkpoint_dir=cfg.checkpoint_dir, checkpoint_every=cfg.checkpoint_every,
        total_steps=cfg.total_steps))
    prev_handler = runner.install_preemption_handler()
    state = {"params": params, "opt": adamw_init(params),
             "seed": torch.tensor(cfg.seed, dtype=torch.int64)}
    stream = {"next": None, "it": None}

    def batch_at(step):
        if not hasattr(data, "batch_at"):
            return next(data)
        if stream["next"] != step:  # the run's start, or a retry from a checkpoint
            if stream["it"] is not None:
                stream["it"].close()
            stream["it"] = make_batch_iterator(data, start_step=step, device=device)
        stream["next"] = step + 1
        return next(stream["it"])

    t_last = time.perf_counter()

    def one_step(state, step):
        _bind(params, state["params"])
        _, opt2, metrics = step_fn(params, state["opt"], batch_at(step), int(state["seed"]),
                                   step)
        return {"params": params, "opt": opt2, "seed": state["seed"], "_metrics": metrics}

    def on_step(step, state):
        nonlocal t_last
        m = state.pop("_metrics", None)
        if m is not None:
            history.append(float(m["loss"]))
        if m is not None and step % cfg.log_every == 0:
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            log(f"step {step:5d} loss {float(m['loss']):.4f} "
                f"gnorm {float(m['grad_norm']):.3f} ({dt:.2f}s/{cfg.log_every})")

    try:
        state = runner.run(state, one_step, on_step=on_step)
    finally:
        if stream["it"] is not None:
            stream["it"].close()
        # SIGTERM ends the process again once the run is over (None: the
        # handler was not set from Python, so the default is put back)
        signal.signal(signal.SIGTERM, signal.SIG_DFL if prev_handler is None else prev_handler)
    _bind(params, state["params"])
    return state, history
