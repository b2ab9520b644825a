"""Cascade pipeline: stage-level serving of multi-stage generative models, the
port of ``repro.pipeline.cascade``.

TTI/TTV inference is a cascade (base denoise then super-resolution, keyframe
then temporal refinement) whose sequence length varies up to 4x across
stages (paper §IV-C, §V-A).  Run end to end in lockstep, every stage takes
the batch the most HBM-hungry stage affords, and concurrent requests reach
the same phase together (the aligned-demand peak of Fig. 7).

:class:`CascadePipeline` turns each ``CostDescriptor`` stage into a
:class:`StageExecutor` with its own batch size, joined by bounded
:class:`StageBuffer` handoff queues: requests of different users batch
together per stage, and the stage mix flattens HBM demand.  Every scheduling
decision is recorded: per-stage throughput, queue occupancy, per-tick stage
concurrency, and the modeled lockstep-vs-pipelined comparison behind
``ServeEngine.stats["cascade"]``.
"""

from __future__ import annotations

from repro_torch.core import tracer
from repro_torch.pipeline.stage import (
    ParkedTask,
    StageBuffer,
    StageExecutor,
    StageTask,
    mean_demand,
    stage_unit_cost,
    state_nbytes,
    state_signature,
)
from repro_torch.telemetry import SpanCollector
from repro_torch.workload.base import params_device, resolve_stage_impls

# Modeled per-dispatch launch overhead, as a fraction of the mean stage unit
# cost: what a stage-batch pays regardless of its size.  Batching a cheap
# stage wider amortizes it, the modeled source of the stage-batched
# throughput gain over lockstep.
DISPATCH_OVERHEAD_FRAC = 0.15


def stage_batch_sizes(stages, pod_size: int, queue_capacity: int) -> list[int]:
    """Per-stage batch size under a shared HBM budget: the most demanding
    stage runs at ``pod_size`` (the lockstep pod route's batch), lighter
    stages batch wider, up to the handoff queue depth, never narrower than
    the pod."""
    demands = [max(mean_demand(s), 1e-9) for s in stages]
    budget = pod_size * max(demands)
    cap = max(queue_capacity, pod_size)
    return [max(1, min(cap, int(budget // d))) for d in demands]


class CascadePipeline:
    """Drives one workload's stage cascade with cross-request batching.

    ``submit`` enqueues a request's initial stage state (legal at any tick:
    a mid-flight submission joins the partially drained first-stage queue),
    and each ``tick()`` is one scheduling round.  ``stage_impl`` maps stage
    names (exact or prefix, ``{"sr": "torch"}``) to tiers over the default
    ``impl``; ``temperature`` reaches every ``run_stage``.  The pipeline
    runs where ``params`` live."""

    def __init__(self, workload, params, *, impl: str = "auto", pod_size: int = 4,
                 queue_capacity: int = 8, seed: int = 0, stage_impl: dict | None = None,
                 temperature: float = 0.0, spans: SpanCollector | None = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError("per-stage device slices of a mesh are not ported yet "
                                      "(ROADMAP.md, open items 1.3: multi-GPU)")
        self.workload = workload
        # the owning engine passes its collector: spans join its timeline
        self.spans = spans if spans is not None else SpanCollector("pipeline")
        self.params = params
        self.device = params_device(params)
        self.impl = impl
        self.seed = seed
        self.pod_size = max(1, pod_size)
        self.queue_capacity = max(queue_capacity, self.pod_size)
        self.stages = list(workload.cost_descriptor().stages)
        if not self.stages:
            raise ValueError("workload has no cost-descriptor stages")
        batches = stage_batch_sizes(self.stages, self.pod_size, self.queue_capacity)
        impls = resolve_stage_impls(self.stages, impl, stage_impl)
        self.executors = [
            StageExecutor(workload, s, impl=im, max_batch=b, temperature=temperature,
                          stage_index=i)
            for i, (s, b, im) in enumerate(zip(self.stages, batches, impls))]
        # buffers[i] feeds stage i; buffers[0] is the unbounded admission
        # queue (the serving scheduler is its backpressure)
        self.buffers = [StageBuffer(f"in/{s.name}",
                                    capacity=None if i == 0 else self.queue_capacity)
                        for i, s in enumerate(self.stages)]
        self.submitted = 0
        self.completed = 0
        self.parked = 0  # tasks preempted out at a stage boundary
        self.resumed = 0  # parked tasks injected back (possibly from elsewhere)
        self.ticks = 0
        self.concurrency: list[int] = []  # stages executed per tick
        self.executed: list[tuple[int, int]] = []  # (stage index, batch size)

    # -- submission ----------------------------------------------------------

    def submit(self, rid: int, tokens, max_new_tokens: int = 0) -> None:
        """Admit one request into the first stage's queue, at any tick."""
        state = self.workload.init_stage_state(tokens, self.device,
                                               max_new_tokens=max_new_tokens)
        self.buffers[0].push(self._task(rid, state, 0), now=self.ticks)
        self.submitted += 1

    def _task(self, rid: int, state, stage_idx: int) -> StageTask:
        group = (state_signature(state),
                 self.workload.stage_group_key(self.stages[stage_idx], state))
        return StageTask(rid=rid, state=state, group=group)

    def pending(self) -> int:
        return sum(len(b) for b in self.buffers)

    # -- stage-boundary preemption (fleet serving) ---------------------------

    def queued_rids(self) -> list[int]:
        """Rids whose state waits in a stage buffer: at a stage boundary,
        preemptible by :meth:`park`."""
        return [t.rid for b in self.buffers for t in b.tasks()]

    def park(self, rids) -> list[ParkedTask]:
        """Preempt ``rids`` at their current stage boundary: remove their
        state from the buffers and return it as :class:`ParkedTask`
        payloads.  ``tick()`` only advances whole dispatches, so parking
        never splits one."""
        wanted = set(rids)
        out: list[ParkedTask] = []
        for idx, buf in enumerate(self.buffers):
            for t in buf.drain(wanted):
                out.append(ParkedTask(rid=t.rid, stage_index=idx, state=t.state))
                self.spans.instant("park", tick=self.ticks, cat="preempt",
                                   lane=self.stages[idx].name, rid=t.rid)
        self.parked += len(out)
        return out

    def resume(self, parked: list[ParkedTask]) -> None:
        """Re-inject parked state at its recorded stage boundary, forced past
        the buffer bound (capacity is a scheduling signal; migrated state
        must land)."""
        for p in parked:
            self.buffers[p.stage_index].push(self._task(p.rid, p.state, p.stage_index),
                                             now=self.ticks, force=True)
            self.spans.instant("resume", tick=self.ticks, cat="preempt",
                               lane=self.stages[p.stage_index].name, rid=p.rid)
        self.resumed += len(parked)

    # -- scheduling ----------------------------------------------------------

    def tick(self) -> list[tuple[int, object]]:
        """One scheduling round: every stage with queued work (and downstream
        room) runs one shape-homogeneous batch, downstream stages first so
        handoff buffers drain before they refill.  Returns completed
        ``(rid, output)`` pairs."""
        done: list[tuple[int, object]] = []
        executed = 0
        for i in reversed(range(len(self.stages))):
            ex, buf = self.executors[i], self.buffers[i]
            out_buf = self.buffers[i + 1] if i + 1 < len(self.buffers) else None
            room = out_buf.room() if out_buf is not None else ex.max_batch
            tasks = buf.pop_group(min(ex.max_batch, room), now=self.ticks)
            if not tasks:
                continue
            name = self.stages[i].name
            for t in tasks:  # queue-wait slice: push tick -> this dispatch
                self.spans.span("queue", cat="queue", start_tick=t.enqueued,
                                end_tick=self.ticks, lane=name, rid=t.rid)
            new_tasks = ex.run_batch(self.params, tasks, self.seed, self.device)
            self.spans.span(name, cat="exec", start_tick=self.ticks, dur_ticks=1.0,
                            dur_s=ex.last_service_s, lane=name, batch=len(tasks),
                            impl=ex.effective_impl)
            executed += 1
            self.executed.append((i, len(tasks)))
            if out_buf is None:
                done += [(t.rid, self.workload.stage_output(t.state)) for t in new_tasks]
                self.completed += len(new_tasks)
            else:
                self._handoff(i, new_tasks)
                for t in new_tasks:
                    out_buf.push(self._task(t.rid, t.state, i + 1), now=self.ticks)
        for b in self.buffers:
            b.sample_occupancy()
        self.concurrency.append(executed)
        self.ticks += 1
        return done

    def _handoff(self, stage_idx: int, tasks: list[StageTask]) -> None:
        """Latent handoff between stages: the producer writes the batch's
        state to the buffer, the consumer reads it back, one round trip of
        the payload.  Under a trace it is an ``other`` event of twice the
        payload, whatever the tier."""
        src, dst = self.stages[stage_idx].name, self.stages[stage_idx + 1].name
        self.spans.instant("handoff", tick=self.ticks, cat="sched", lane=src, n=len(tasks),
                           to=dst)
        if tracer.active():
            payload = sum(state_nbytes(t.state) for t in tasks)
            tracer.record("other", f"handoff/{src}->{dst}", flops=0.0, bytes_hbm=2.0 * payload,
                          batch=len(tasks), stage=src)

    def run(self) -> dict:
        """Drain everything submitted so far; returns {rid: output}."""
        results: dict = {}
        while self.pending():
            for rid, out in self.tick():
                results[rid] = out
        return results

    # -- reporting -----------------------------------------------------------

    def modeled_comparison(self) -> dict:
        """Stage-batched (as scheduled) vs end-to-end lockstep, on the shared
        dispatch-overhead + per-item HBM-cost model, plus the aligned vs
        pipelined instantaneous HBM-demand profile (§V-A)."""
        costs = [stage_unit_cost(s) for s in self.stages]
        demands = [mean_demand(s) for s in self.stages]
        overhead = DISPATCH_OVERHEAD_FRAC * sum(costs) / len(costs)

        # lockstep baseline: pods of pod_size run every stage together
        n = self.submitted
        pods = [self.pod_size] * (n // self.pod_size)
        if n % self.pod_size:
            pods.append(n % self.pod_size)
        t_lock = sum(overhead + p * c for p in pods for c in costs)
        prof_lock = [p * d for p in pods for d in demands]

        # pipelined: the executed stage-batch log, its demand per dispatch
        t_pipe = sum(overhead + b * costs[i] for i, b in self.executed)
        prof_pipe = [b * demands[i] for i, b in self.executed]

        def side(t, prof):
            peak = max(prof) if prof else 0.0
            mean = sum(prof) / len(prof) if prof else 0.0
            return {"modeled_time": t, "modeled_throughput": (n / t) if t else 0.0,
                    "peak_demand": peak, "mean_demand": mean,
                    "flatness": (peak / mean) if mean else 0.0}

        out = {"lockstep": side(t_lock, prof_lock), "pipelined": side(t_pipe, prof_pipe)}
        out["throughput_gain"] = (
            out["pipelined"]["modeled_throughput"] / out["lockstep"]["modeled_throughput"]
            if out["lockstep"]["modeled_throughput"] else 0.0)
        return out

    def summary(self) -> dict:
        """The ``engine.stats["cascade"]`` payload: per-stage execution,
        queue, tail-latency and tier reports, pipeline concurrency, per-tier
        attribution, and the modeled §V-A comparison."""
        per_stage = {}
        tiers: dict[str, dict] = {}
        for ex, buf in zip(self.executors, self.buffers):
            s = ex.summary()
            occ = buf.occupancy
            s["queue"] = {"capacity": buf.capacity,
                          "mean_occupancy": (sum(occ) / len(occ)) if occ else 0.0,
                          "max_occupancy": max(occ) if occ else 0}
            s["queue_wait_ticks"] = buf.waits.summary()
            per_stage[ex.name] = s
            t = tiers.setdefault(ex.effective_impl, {"requested": set(), "stages": [],
                                                     "items": 0, "exec_s": 0.0})
            t["requested"].add(ex.impl)
            t["stages"].append(ex.name)
            t["items"] += ex.items
            t["exec_s"] += ex.exec_s
        for t in tiers.values():
            t["requested"] = sorted(t["requested"])
            t["rps"] = (t["items"] / t["exec_s"]) if t["exec_s"] else 0.0
        conc = self.concurrency
        return {
            "stages": per_stage,
            "tiers": tiers,
            "submitted": self.submitted,
            "completed": self.completed,
            "parked": self.parked,
            "resumed": self.resumed,
            "ticks": self.ticks,
            "concurrency": {"max": max(conc) if conc else 0,
                            "mean": (sum(conc) / len(conc)) if conc else 0.0},
            "hbm": self.modeled_comparison(),
        }
