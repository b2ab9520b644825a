"""AdamW with global-norm clipping and a cosine schedule, the port of
``repro.training.optimizer``: plain functions on name-keyed dicts of
tensors (``nn.trainable``'s), the reference's math exactly.

Not ``torch.optim.AdamW``, which differs from the reference in three ways
this module keeps:

  * clipping: ``scale = min(1, clip_norm / max(gnorm, 1e-12))`` over the
    global norm of every gradient (``clip_grad_norm_`` divides by
    ``norm + 1e-6``);
  * a leaf with no gradient (``None``: the loss does not reach it, as SD's
    ``vae.*`` under ``train_loss`` or an MoE's unrouted expert) has a zero
    gradient, as ``jax.value_and_grad`` gives it: it counts in the global
    norm (as 0), its moments decay and it still takes weight decay;
  * precision: the moments are fp32 and the update runs in fp32, cast back
    to the parameter's dtype (bf16 included); ``step`` is an int32 counter
    and the bias corrections and learning rate are float32 scalars of it.

``adamw_update`` writes the new parameters and moments into the given
tensors (no second copy of the state on the card) and returns the same
dicts, with the reference's metrics.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000


def cosine_lr(cfg: AdamWConfig, step) -> float:
    """Linear warmup to ``cfg.lr``, then a cosine decay to 0 at
    ``total_steps``; float32 arithmetic, as the reference's."""
    f = np.float32
    step = f(int(step))
    warm = min(step / f(max(cfg.warmup_steps, 1)), f(1.0))
    prog = np.clip((step - f(cfg.warmup_steps)) / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f(0.0), f(1.0))
    return float(f(cfg.lr) * warm * f(0.5) * (f(1.0) + np.cos(f(math.pi) * prog)))


def adamw_init(params: dict) -> dict:
    """``{"step": int32 0, "m": zeros, "v": zeros}``, the moments fp32 on
    each parameter's device."""
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"step": torch.zeros((), dtype=torch.int32),
            "m": {k: zeros32(p) for k, p in params.items()},
            "v": {k: zeros32(p) for k, p in params.items()}}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a ``None`` leaf
    is a zero gradient)."""
    sq = [torch.sum(torch.square(x.float())) for x in tree.values() if x is not None]
    if not sq:
        return torch.zeros((), dtype=torch.float32)
    dev = sq[0].device
    return torch.sqrt(torch.sum(torch.stack([s.to(dev) for s in sq])))


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, cfg: AdamWConfig):
    """One AdamW step on ``params`` from ``grads`` (same keys; ``None`` for
    a leaf with no gradient): returns ``(params, state, metrics)``, the
    first two updated in place, ``metrics`` ``{"grad_norm", "lr"}``."""
    step = int(state["step"]) + 1
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    f = np.float32
    bc1 = float(f(1.0) - f(cfg.b1) ** f(step))
    bc2 = float(f(1.0) - f(cfg.b2) ** f(step))
    b1, b2 = cfg.b1, cfg.b2
    for key, p in params.items():
        g, m, v = grads.get(key), state["m"][key], state["v"][key]
        if g is None:  # a zero gradient: the moments only decay
            m.mul_(b1)
            v.mul_(b2)
        else:
            g32 = g.float() * scale.to(g.device)
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * g32 * g32)
        p32 = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
    state["step"] = torch.tensor(step, dtype=torch.int32)
    return params, state, {"grad_norm": gnorm, "lr": lr}
