"""Stage-level execution primitives of the cascade pipeline, the port of
``repro.pipeline.stage``.

A :class:`StageExecutor` owns one ``CostDescriptor`` stage of one workload:
its batch size (from the stage's HBM demand: the seq-256 base denoiser
batches wider than the seq-4096 SR stage) and its kernel tier.  Requests are
grouped by state signature, so every batch it runs is shape-homogeneous.
:class:`StageBuffer` is the bounded inter-stage handoff queue; executors
apply backpressure by never popping more work than the downstream buffer has
room for.  States are trees of dicts, lists and tuples of tensors whose
leaves carry the batch axis first (``workload.base.stack_states``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque

import torch

from repro_torch.core import tracer
from repro_torch.kernels.tiers import resolve_model_impl
from repro_torch.telemetry import Histogram
from repro_torch.workload.base import (
    split_state,
    stack_states,
    stage_generator,
    synchronize,
    tree_leaves,
    tree_map,
)

# ---------------------------------------------------------------------------
# Per-request state views
# ---------------------------------------------------------------------------


def state_signature(state) -> tuple:
    """Hashable (structure, shapes, dtypes) key: states with equal
    signatures stack into one batch."""
    structure = repr(tree_map(lambda x: None, state))
    return (structure, tuple((tuple(x.shape), str(x.dtype)) for x in tree_leaves(state)))


def state_nbytes(state) -> int:
    """Total bytes of all tensors in a state: the latent handoff payload."""
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(state)))


@dataclasses.dataclass
class StageTask:
    """One request's state parked between stages.

    ``enqueued`` is the pipeline tick at which the task entered its current
    stage buffer; the buffer turns it into the per-stage queue-wait sample
    behind the p50/p95 tail-latency report."""

    rid: int
    state: dict
    group: tuple = ()  # (signature, workload group key) for batching
    enqueued: int = 0  # pipeline tick when pushed into the current buffer


@dataclasses.dataclass
class ParkedTask:
    """A request's per-stage state lifted out of a :class:`StageBuffer` at a
    stage boundary: the preemption / migration payload of fleet serving.

    The pipeline only advances whole stage dispatches, so every queued task
    is at a stage boundary.  Under the ``(seed, rid, stage_index)`` contract
    a parked request resumed into any pipeline with the same seed draws the
    same noise from ``stage_index`` onward."""

    rid: int
    stage_index: int  # descriptor stage the state is waiting to enter
    state: dict  # the unbatched per-request stage state


# ---------------------------------------------------------------------------
# Bounded handoff buffer
# ---------------------------------------------------------------------------


class StageBuffer:
    """Bounded FIFO of :class:`StageTask` between two stages.

    ``capacity=None`` makes it unbounded (the admission queue; everywhere
    else the bound is what turns the executor chain into a backpressured
    pipeline).  ``push(task, now=tick)`` stamps the task and
    ``pop_group(..., now=tick)`` records how many ticks each popped task
    queued in ``waits``, a streaming histogram at one-tick resolution that
    :meth:`CascadePipeline.summary` reduces to p50/p95."""

    def __init__(self, name: str, capacity: int | None = None):
        self.name = name
        self.capacity = capacity
        self._q: deque[StageTask] = deque()
        self.occupancy: list[int] = []  # sampled once per pipeline tick
        self.waits = Histogram(f"{name}/queue_wait_ticks")

    def __len__(self) -> int:
        return len(self._q)

    def free_slots(self) -> int | None:
        """Real free capacity, ``None`` when unbounded (a load signal must be
        able to skip unbounded buffers)."""
        if self.capacity is None:
            return None
        return max(0, self.capacity - len(self._q))

    def room(self) -> float:
        """Free slots as a backpressure bound (``math.inf`` when unbounded)."""
        fs = self.free_slots()
        return math.inf if fs is None else fs

    def push(self, task: StageTask, now: int = 0, *, force: bool = False) -> bool:
        """Append ``task`` stamped with tick ``now``; False when the buffer is
        full (the producer retries next tick).  ``force=True`` bypasses the
        bound: a resumed request's state must land somewhere."""
        if not force and self.room() <= 0:
            return False
        task.enqueued = now
        self._q.append(task)
        return True

    def pop_group(self, max_n: int, now: int = 0) -> list[StageTask]:
        """Pop up to ``max_n`` tasks sharing the head task's group key (FIFO
        order kept for the rest); records each popped task's queue wait."""
        if not self._q or max_n <= 0:
            return []
        head = self._q[0].group
        taken: list[StageTask] = []
        rest: deque[StageTask] = deque()
        while self._q:
            t = self._q.popleft()
            if len(taken) < max_n and t.group == head:
                taken.append(t)
            else:
                rest.append(t)
        self._q = rest
        self.waits.observe_many(now - t.enqueued for t in taken)
        return taken

    def tasks(self) -> tuple[StageTask, ...]:
        """Snapshot of the queued tasks (FIFO order)."""
        return tuple(self._q)

    def drain(self, rids: set) -> list[StageTask]:
        """Remove and return every queued task whose rid is in ``rids`` (the
        stage-boundary preemption primitive); no queue-wait sample."""
        taken: list[StageTask] = []
        kept: deque[StageTask] = deque()
        while self._q:
            t = self._q.popleft()
            (taken if t.rid in rids else kept).append(t)
        self._q = kept
        return taken

    def sample_occupancy(self) -> None:
        self.occupancy.append(len(self._q))


# ---------------------------------------------------------------------------
# Stage executor
# ---------------------------------------------------------------------------


def mean_demand(stage) -> float:
    """Stage's mean per-tick relative HBM demand (flat seq_len fallback)."""
    prof = list(stage.demand) if stage.demand else [stage.seq_len]
    return float(sum(prof)) / max(len(prof), 1)


def stage_unit_cost(stage) -> float:
    """Modeled cost of pushing ONE request through the whole stage (all its
    iterative steps), in relative HBM-demand units."""
    return stage.steps * mean_demand(stage)


class StageExecutor:
    """Runs one workload stage over shape-homogeneous request batches.

    ``impl`` is the tier requested for this stage (a ``stage_impl`` override
    or the engine's default) and ``effective_impl`` what runs: the port's
    tier from ``resolve_model_impl``, ``kernel`` or ``torch``.  The stage
    runs under the requested string, as ``generate`` passes it.  There is no
    fallback: a kernel that fails to build or launch raises through here.
    ``stage_index`` is the stage's position in the cost descriptor, what the
    ``(seed, rid, stage_index)`` contract keys each request's generator on."""

    def __init__(self, workload, stage, *, impl: str = "auto", max_batch: int = 4,
                 temperature: float = 0.0, stage_index: int = 0, mesh=None):
        self.workload = workload
        self.mesh = mesh  # optional per-stage slice of the ranks (see cascade.py)
        self.stage = stage
        self.stage_index = stage_index
        self.impl = impl
        self.effective_impl = resolve_model_impl(impl)
        self.max_batch = max_batch
        self.temperature = temperature
        self.batches = 0
        self.items = 0
        self.exec_s = 0.0
        self.batch_sizes: list[int] = []
        # per-batch wall time (streaming log-bucket histogram, ~2% rel. res.)
        self.service_s = Histogram(f"{stage.name}/service_s", lo=1e-7, hi=1e4,
                                   resolution=0.02, scale="log")
        self.last_service_s = 0.0

    @property
    def name(self) -> str:
        return self.stage.name

    @torch.inference_mode()
    def run_batch(self, params, tasks: list[StageTask], seed: int,
                  device: torch.device) -> list[StageTask]:
        """Execute the stage over ``tasks`` as one batch; returns the tasks
        with their post-stage states.  Each request gets its own
        ``stage_generator(seed, rid, stage_index)``, as in ``generate``.  The
        clock is read after a device synchronisation, so ``service_s`` is the
        stage's work and not its launch."""
        batched = stack_states([t.state for t in tasks])
        gens = [stage_generator(seed, t.rid, self.stage_index) for t in tasks]
        t0 = time.perf_counter()
        # forwarded only when set, so mesh-free run_stage doubles keep working
        mesh_kw = {} if self.mesh is None else {"mesh": self.mesh}
        with tracer.scope(self.stage.name):  # the scope ``generate`` opens too
            new = self.workload.run_stage(params, self.stage, batched, gens,
                                          impl=self.impl, temperature=self.temperature,
                                          **mesh_kw)
        synchronize(device)
        dt = time.perf_counter() - t0
        self.exec_s += dt
        self.service_s.observe(dt)
        self.last_service_s = dt
        self.batches += 1
        self.items += len(tasks)
        self.batch_sizes.append(len(tasks))
        return [dataclasses.replace(t, state=s)
                for t, s in zip(tasks, split_state(new, len(tasks)))]

    def summary(self) -> dict:
        """Per-stage serving report: batch counts, tiers, throughput, and
        the p50/p95 per-batch service-time sample (and the stage's slice of
        the ranks, on a mesh)."""
        out = {
            "batches": self.batches,
            "items": self.items,
            "exec_s": self.exec_s,
            "mean_batch": (self.items / self.batches) if self.batches else 0.0,
            "max_batch": self.max_batch,
            "impl": self.impl,
            "effective_impl": self.effective_impl,
            "service_s": self.service_s.summary(),
            "throughput_rps": (self.items / self.exec_s) if self.exec_s else 0.0,
        }
        if self.mesh is not None:
            from repro_torch.parallel.sharding import mesh_shape

            out["mesh"] = {"axes": mesh_shape(self.mesh), "devices": int(self.mesh.size())}
        return out
