"""Fault tolerance: checkpoint/restart orchestration, the port of
``repro.runtime.fault_tolerance``.

Protocol, as the reference's:

  1. Periodic and preemption-triggered checkpoints (a SIGTERM handler sets
     a flag; the step loop saves and exits cleanly).
  2. On start, ``FaultTolerantRunner.run`` restores the newest checkpoint
     and continues from its step: the data pipeline and the trainer's noise
     are seeded by step, so a restart repeats the uninterrupted run.
  3. A step that raises (a device fault, a numerical escape) is retried up
     to ``max_retries`` times from the last checkpoint, after the save in
     flight has landed.
  4. **Elastic re-mesh**: ``elastic_resume`` restores a checkpoint written
     on one mesh onto another (another data axis, another world size):
     checkpoints hold each leaf whole, so re-sharding is placing each leaf
     with the new shardings.
"""

from __future__ import annotations

import dataclasses
import signal
from typing import Callable

from repro_torch.checkpoint import Checkpointer


@dataclasses.dataclass
class RunnerConfig:
    checkpoint_dir: str
    checkpoint_every: int = 100
    max_retries: int = 3
    total_steps: int = 1000


class FaultTolerantRunner:
    def __init__(self, cfg: RunnerConfig):
        self.cfg = cfg
        self.ckpt = Checkpointer(cfg.checkpoint_dir)
        self._preempted = False

    def install_preemption_handler(self):
        """Route SIGTERM to this runner's preemption flag; returns the
        handler it replaces, for the caller to put back when the run ends."""
        def handler(signum, frame):
            self._preempted = True

        return signal.signal(signal.SIGTERM, handler)

    def run(self, state, step_fn: Callable, *, device=None, on_step: Callable | None = None):
        """Run ``step_fn(state, step) -> state`` (which may raise) to
        ``total_steps`` with restart and retry; returns the state.  Restored
        leaves go to ``device``, else where the leaves they replace are."""
        cfg = self.cfg
        start = 0
        last = self.ckpt.latest_step()
        if last is not None:
            state = self.ckpt.restore(state, step=last, device=device)
            start = int(last)
        step = start
        retries = 0
        while step < cfg.total_steps:
            try:
                state = step_fn(state, step)
                retries = 0
            except Exception:  # noqa: BLE001 -- the transient-failure path
                retries += 1
                if retries > cfg.max_retries:
                    # a final checkpoint of the last good state, then re-raise
                    self.ckpt.save(step, state)
                    self.ckpt.wait()
                    raise
                # Restore the last good checkpoint and retry: wait for the
                # save in flight first, then take state and step from the
                # SAME checkpoint (a second latest_step() could see a newer
                # save land in between).
                self.ckpt.wait()
                last = self.ckpt.latest_step()
                if last is not None:
                    state = self.ckpt.restore(state, step=last, device=device)
                    step = int(last)
                continue
            step += 1
            if on_step is not None:
                on_step(step, state)
            if step % cfg.checkpoint_every == 0 or self._preempted:
                self.ckpt.save(step, state)
            if self._preempted:
                self.ckpt.wait()
                break
        self.ckpt.wait()
        return state


def elastic_resume(ckpt: Checkpointer, state_like, new_shardings=None, device=None):
    """The newest checkpoint in ``state_like``'s structure, each leaf placed
    by ``new_shardings`` (a tree like ``state_like``'s of
    ``parallel.sharding.NamedSharding``; a mesh other than the writer's), or
    on ``device``."""
    return ckpt.restore(state_like, device=device, shardings=new_shardings)
