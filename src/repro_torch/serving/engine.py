"""Modality-agnostic serving engine over the ``GenerativeWorkload`` API, the
port of ``repro.serving.engine``.

One ``submit/step/run`` surface for every suite model, and one execution
path behind it: every route drives the workload's stage loop
(``generate_requests`` -> ``run_stage``) under the ``(seed, rid,
stage_index)`` generator contract, so a request's noise never depends on
its batch, and ``ServeConfig.stage_impl`` per-stage tiers and per-stage time
attribution apply everywhere.  The routes differ only in scheduling:

  * **lm** (Table III Prefill / Decode): the bucketed scheduler batches
    requests by padded prompt length; prompts are zero-padded to the bucket
    and served through prefill + decode.  Each batch's ``padding_waste``
    (the §V-B bucket-quantum trade) lands in ``stats``.
  * **pod** (diffusion, AR-image, TTV): requests accumulate into denoise
    pods; each pod runs the stage loop as one batch while
    ``DenoisePodScheduler`` staggers its step indices (§V-A); the aligned vs
    staggered ``bandwidth_profile`` goes to ``stats``.
  * **cascade** (``ServeConfig(route="cascade")``, any workload): pods feed
    ``pipeline.CascadePipeline``, which runs the same stages with
    cross-request batching per stage and bounded handoff queues;
    ``stats["cascade"]`` holds per-stage tail latency and tier attribution.

**Online serving.**  ``submit(..., arrival_tick=t)`` defers a request to
scheduling tick ``t`` (one tick = one ``step()``); ``arrival_tick=None`` is
the closed loop: the request is released when an earlier one completes.
Under ``admission="continuous"`` a partial pod whose oldest request has
waited ``arrival_flush_wait`` ticks is flushed into the pipeline;
``admission="pod"`` holds partial pods for future arrivals.

The engine runs where its ``params`` live (``workload.init(seed, device)``);
outputs come back on the host.  Nothing falls back: a kernel that fails to
build or launch raises through ``step``.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from collections import deque
from typing import Any

import numpy as np

from repro_torch.nn import specs_of
from repro_torch.parallel.sharding import (
    REPLICATION_FALLBACKS,
    SERVE_TP_RULES,
    check_mesh,
    mesh_shape,
    shard_report,
)
from repro_torch.pipeline import CascadePipeline
from repro_torch.serving.scheduler import (
    BucketedScheduler,
    DenoisePodScheduler,
    Request,
    bucket_of,
)
from repro_torch.telemetry import (
    STATS_SCHEMA_VERSION,
    MetricsRegistry,
    SpanCollector,
    write_chrome_trace,
)
from repro_torch.workload import GenerativeWorkload, workload_for
from repro_torch.workload.base import SERVE_ROUTES, params_device, resolve_stage_impls


@dataclasses.dataclass
class ServeConfig:
    """Engine-level serving knobs (workload-independent), the reference's
    fields.

    ``temperature`` is the LM sampling temperature (0 = greedy); ``impl`` the
    engine-wide kernel tier, with ``stage_impl`` overriding it per stage by
    exact name or prefix (``{"sr": "torch"}`` puts every SR stage on the
    torch tier) on every route; ``admission`` the online pod-admission
    policy, ``"continuous"`` (flush a partial pod after
    ``arrival_flush_wait`` ticks) or ``"pod"`` (hold it until arrivals fill
    it).  ``route`` is the serve route: ``"auto"`` takes the workload's
    (``"lm"`` or ``"pod"``), ``"cascade"`` the stage-level pipeline.
    ``tick_seconds`` maps the tick clock to wall time; ``None`` calibrates it
    from the median busy-tick time.  ``mesh`` (a torch ``DeviceMesh`` with
    ``data``/``model`` axes, e.g. from ``repro_torch.launch.mesh.make_debug_mesh``)
    turns on sharded serving, SPMD on every rank: params are TP-sharded once
    at engine construction, every stage runs with its batch sharded over
    ``data``, and the cascade route carves the mesh into per-stage rank
    slices.  ``stats["mesh"]`` reports the axes and the sharded-vs-replicated
    param bytes ("TP coverage")."""

    max_batch: int = 4
    max_len: int = 256
    buckets: tuple = (32, 64, 128)
    temperature: float = 0.0  # 0 = greedy
    pod_size: int = 0  # 0 -> max_batch
    seed: int = 0
    impl: str = "auto"  # kernel tier threaded down to generate/run_stage
    stage_impl: dict | None = None  # per-stage tier overrides (any route)
    route: str = "auto"  # "auto" (workload default) | "cascade"
    queue_capacity: int = 8  # cascade inter-stage handoff buffer depth
    admission: str = "continuous"  # "continuous" | "pod" (online pod flush)
    arrival_flush_wait: int = 2  # ticks a partial pod waits before flushing
    tick_seconds: float | None = None  # None -> calibrate from measurement
    mesh: Any = None  # optional torch DeviceMesh ("data"/"model") -> sharded serving

    @property
    def resolved_pod_size(self) -> int:
        return self.pod_size or self.max_batch

    def __post_init__(self):
        if self.admission not in ("continuous", "pod"):
            raise ValueError(f"unknown admission policy {self.admission!r} "
                             f"(expected 'continuous' or 'pod')")
        if self.route not in ("auto",) + SERVE_ROUTES:
            raise ValueError(f"unknown serve route {self.route!r} (expected 'auto' or one "
                             f"of {SERVE_ROUTES})")
        if self.tick_seconds is not None and self.tick_seconds <= 0:
            raise ValueError(f"tick_seconds must be > 0 (or None to auto-calibrate), "
                             f"got {self.tick_seconds}")
        check_mesh(self.mesh)


class ServeEngine:
    """Serves any registered ``GenerativeWorkload`` behind submit/step/run,
    on the device of ``params``."""

    def __init__(self, workload, params, serve_cfg: ServeConfig = ServeConfig()):
        if not isinstance(workload, GenerativeWorkload):
            workload = workload_for(workload)  # accept a raw config too
        self.workload = workload
        self.cfg = workload.cfg
        self.model = workload.model
        # -- sharded serving: place params on the mesh ONCE, here ------------
        self.mesh = serve_cfg.mesh
        self._mesh_report = None
        if self.mesh is not None:
            before = REPLICATION_FALLBACKS.value
            params = workload.shard_params(params, self.mesh)
            self._mesh_report = shard_report(params, specs_of(workload.model), self.mesh,
                                             SERVE_TP_RULES)
            self._mesh_report["replication_fallbacks"] = REPLICATION_FALLBACKS.value - before
        self.params = params
        self.serve_cfg = serve_cfg
        self.cost = workload.cost_descriptor()
        self.route = workload.route if serve_cfg.route == "auto" else serve_cfg.route
        if self.route not in SERVE_ROUTES:
            raise ValueError(f"unknown serve route {self.route!r} (expected one of "
                             f"{SERVE_ROUTES})")
        # per-stage tier overrides are checked here, on every route: a typo
        # must not silently serve the default tier
        resolve_stage_impls(self.cost.stages, serve_cfg.impl, serve_cfg.stage_impl)
        self.device = params_device(params)
        self.stats: dict = {"schema": STATS_SCHEMA_VERSION, "requests": 0,
                            "impl": serve_cfg.impl, "tier_throughput": {},
                            "stage_impl": dict(serve_cfg.stage_impl or {}), "stages": {}}
        self.pipeline = None
        # -- telemetry: typed metrics + lifecycle spans ----------------------
        self.metrics = MetricsRegistry()
        if self.mesh is not None:
            self.stats["mesh"] = {"axes": mesh_shape(self.mesh), "devices": int(self.mesh.size()),
                                  "params": self._mesh_report}
            self.metrics.counter("sharding_replication_fallbacks",
                                 "param dims replicated by the divisibility fallback",
                                 ).inc(self._mesh_report["replication_fallbacks"])
        self.spans = SpanCollector(track="engine")
        self._requests_c = self.metrics.counter("requests_submitted",
                                                "requests accepted by submit()")
        self._completed_c = self.metrics.counter("requests_completed", "requests finished")
        self._pending_g = self.metrics.gauge("pending_requests",
                                             "requests anywhere in the system")
        # -- online-serving clock + arrival queues ---------------------------
        self._tick = 0  # one tick == one step() call
        self._future: list = []  # heap of (arrival_tick, seq, Request)
        self._closed_loop: deque = deque()  # released on completions
        self._ready_pods: deque = deque()  # pod route: admitted, unserved
        self._seq = 0
        self._arrival_tick: dict[int, int] = {}
        self._admission_waits = self.metrics.histogram("admission_wait_ticks",
                                                       "arrival -> pipeline admission")
        self._e2e_ticks = self.metrics.histogram("request_e2e_ticks", "arrival -> completion")
        self._completed = 0
        # per-tick wall s of busy ticks; log buckets span the first-call
        # outlier to microsecond ticks at ~2% relative resolution
        self._busy_wall_s = self.metrics.histogram(
            "busy_tick_s", "wall seconds of each busy tick", lo=1e-7, hi=1e4,
            resolution=0.02, scale="log")

        if self.route == "cascade":
            # staggered pods feed the stage pipeline: admission stays
            # pod-based (the §V-A stagger report stays per pod), execution is
            # stage-batched across pods
            self.scheduler = DenoisePodScheduler(pod_size=serve_cfg.resolved_pod_size,
                                                 total_steps=self.cost.iterative_steps())
            self.pipeline = CascadePipeline(
                workload, params, impl=serve_cfg.impl, stage_impl=serve_cfg.stage_impl,
                temperature=serve_cfg.temperature, pod_size=serve_cfg.resolved_pod_size,
                queue_capacity=serve_cfg.queue_capacity, seed=serve_cfg.seed,
                spans=self.spans, mesh=self.mesh)
            self.stats.update(generate_s=0.0, pods=0, bandwidth_profile=[], cascade={})
        elif self.route == "lm":
            self.scheduler = BucketedScheduler(serve_cfg.buckets, serve_cfg.max_batch)
            self.stats.update(prefill_s=0.0, decode_s=0.0, tokens=0, padding_waste=[])
        else:
            self.scheduler = DenoisePodScheduler(pod_size=serve_cfg.resolved_pod_size,
                                                 total_steps=self.cost.iterative_steps())
            self.stats.update(generate_s=0.0, pods=0, bandwidth_profile=[])

    def _record_tier(self, n_done: int, wall_s: float) -> None:
        """Per-``impl``-tier served-request throughput."""
        t = self.stats["tier_throughput"].setdefault(
            self.serve_cfg.impl, {"requests": 0, "wall_s": 0.0, "rps": 0.0})
        t["requests"] += n_done
        t["wall_s"] += wall_s
        t["rps"] = t["requests"] / t["wall_s"] if t["wall_s"] else 0.0

    def _record_stage(self, name: str, wall_s: float, batch: int) -> None:
        """Per-stage time attribution of the routes that run it whole (the
        ``on_stage`` hook of ``generate_requests``); the lm route's
        ``prefill_s`` / ``decode_s`` are mirrored."""
        s = self.stats["stages"].setdefault(name, {"exec_s": 0.0, "items": 0, "dispatches": 0})
        s["exec_s"] += wall_s
        s["items"] += batch
        s["dispatches"] += 1
        self.spans.span(name, cat="exec", start_tick=self._tick, dur_ticks=1.0, dur_s=wall_s,
                        lane=name, batch=batch)
        legacy = {"prefill": "prefill_s", "decode": "decode_s"}
        if name in legacy and legacy[name] in self.stats:
            self.stats[legacy[name]] += wall_s

    # -- submission ----------------------------------------------------------

    def submit(self, rid: int, tokens, max_new_tokens: int = 0,
               arrival_tick: int | None = 0, *, slo_tier: str | None = None,
               deadline_ticks: int | None = None) -> None:
        """Admit one request; ``tokens`` are the prompt / conditioning ids.

        ``arrival_tick`` places it on the tick clock: 0 (or a tick already
        passed) admits now, a future tick defers admission until the clock
        reaches it, and ``None`` (closed loop, ``serving.ON_COMPLETION``)
        releases it when an earlier request completes.  ``slo_tier`` /
        ``deadline_ticks`` are its SLO class (one engine serves tiers
        FIFO)."""
        req = self.workload.prepare_request(rid, tokens, max_new_tokens=max_new_tokens,
                                            slo_tier=slo_tier, deadline_ticks=deadline_ticks)
        if self.workload.route == "lm":  # lm and cascaded-lm routes alike
            limit = max(self.serve_cfg.buckets)
            if req.prompt_len > limit:
                raise ValueError(f"request {rid}: prompt length {req.prompt_len} exceeds the "
                                 f"largest configured bucket ({limit}); raise "
                                 f"ServeConfig.buckets or truncate the prompt")
        sreq = Request(rid=req.rid, prompt_len=req.prompt_len,
                       max_new_tokens=req.max_new_tokens, denoise_steps=req.denoise_steps,
                       state={"prompt": req.tokens})
        if arrival_tick is None:
            # into an idle engine a closed-loop request is admitted now:
            # nothing in flight could ever release it
            if self.pending() == len(self._closed_loop):
                self._enqueue(sreq, self._tick)
            else:
                self._closed_loop.append(sreq)
        elif arrival_tick <= self._tick:
            self._enqueue(sreq, self._tick)
        else:
            self._seq += 1
            heapq.heappush(self._future, (int(arrival_tick), self._seq, sreq))
        self.stats["requests"] += 1
        self._requests_c.inc()

    def _enqueue(self, sreq: Request, tick: int) -> None:
        """Hand an arrived request to the route scheduler, stamped with its
        arrival tick (what the admission-wait and e2e latencies key off)."""
        sreq.arrived_at = float(tick)
        self._arrival_tick[sreq.rid] = tick
        self.scheduler.submit(sreq)

    def _admit_arrivals(self) -> None:
        """Release every deferred request whose arrival tick has come."""
        while self._future and self._future[0][0] <= self._tick:
            tick, _, sreq = heapq.heappop(self._future)
            self._enqueue(sreq, tick)

    def _arrivals_deferred(self) -> int:
        return len(self._future) + len(self._closed_loop)

    # -- online pod admission ------------------------------------------------

    def _admit_pods_ready(self) -> list[list]:
        """Pop every pod the admission policy allows this tick.

        Full pods always go.  A partial (open) pod goes when nothing that
        could still fill it remains (no timed arrivals, and no closed-loop
        waiters that in-flight work could release), or when the policy is
        ``continuous`` and its oldest request has waited
        ``arrival_flush_wait`` ticks."""
        sched, cfg = self.scheduler, self.serve_cfg
        pods = []
        while True:
            pod = sched.pop_pod()
            if not pod and sched.open_size():
                # work whose completions could still release closed-loop
                # waiters: the pipeline, pods admitted but not served, and
                # pods popped earlier in this call
                in_flight = ((self.pipeline.pending() if self.pipeline is not None else 0)
                             + sum(len(p) for p in self._ready_pods)
                             + sum(len(p) for p in pods))
                can_fill = bool(self._future) or bool(self._closed_loop and in_flight)
                if not can_fill:
                    sched.flush()
                elif cfg.admission == "continuous":
                    sched.flush_stale(self._tick, cfg.arrival_flush_wait)
                pod = sched.pop_pod()
            if not pod:
                return pods
            pods.append(pod)

    def _record_pod_profile(self, pod: list) -> None:
        """Stagger schedule + §V-A bandwidth profile for one admitted pod."""
        schedule = self.scheduler.schedule(pod)
        self.stats["bandwidth_profile"].append(
            DenoisePodScheduler.bandwidth_profile(self.cost.step_demands(), schedule))
        self.stats["pods"] += 1
        for r in pod:
            self._record_admission(r)

    def _record_admission(self, r) -> None:
        """Arrival -> scheduler-admission wait: histogram sample + span."""
        arrived = int(r.arrived_at)
        self._admission_waits.observe(self._tick - arrived)
        self.spans.span("admission_wait", cat="admission", start_tick=arrived,
                        end_tick=self._tick, lane="admission", rid=r.rid)

    # -- the stage loop ----------------------------------------------------

    def _pad_prompts(self, batch, width: int) -> np.ndarray:
        toks = np.zeros((len(batch), width), np.int32)
        for i, r in enumerate(batch):
            toks[i, : r.prompt_len] = r.state["prompt"]
        return toks

    def _drive(self, requests: list, width: int) -> list:
        """Run one batch of scheduled requests through the stage loop
        (``generate_requests``), as every route does, with the per-stage
        tiers, per-request decode budgets and rids."""
        # mesh forwarded only when set (mesh-free run_stage doubles keep working)
        mesh_kw = {} if self.mesh is None else {"mesh": self.mesh}
        return self.workload.generate_requests(
            self.params, self._pad_prompts(requests, width), self.serve_cfg.seed,
            impl=self.serve_cfg.impl, device=self.device, stage_impl=self.serve_cfg.stage_impl,
            temperature=self.serve_cfg.temperature,
            max_new_tokens=[r.max_new_tokens for r in requests],
            rids=[r.rid for r in requests], on_stage=self._record_stage, **mesh_kw)

    # -- LM route ------------------------------------------------------------

    def _step_lm(self) -> list[tuple[int, Any]]:
        """Serve one bucketed batch through the stage loop, prompts padded
        to the bucket."""
        t_step = time.perf_counter()
        bucket, batch = self.scheduler.next_batch()
        if not batch:
            return []
        for r in batch:
            self._record_admission(r)
        self.stats["padding_waste"].append(self.scheduler.padding_waste(batch, bucket))
        outs = self._drive(batch, bucket)
        self.stats["tokens"] += max(r.max_new_tokens for r in batch) * len(batch)
        done = [(r.rid, outs[i].tolist()) for i, r in enumerate(batch)]
        self._record_tier(len(batch), time.perf_counter() - t_step)
        return done

    # -- pod route -----------------------------------------------------------

    def _step_pod(self) -> list[tuple[int, Any]]:
        if not self._ready_pods:
            self._ready_pods.extend(self._admit_pods_ready())
        pod = self._ready_pods.popleft() if self._ready_pods else []
        if not pod:
            return []
        # staggered step indices of the pod (§V-A) and the resulting
        # instantaneous-HBM-demand flattening against the aligned baseline
        self._record_pod_profile(pod)
        t0 = time.perf_counter()
        outs = [o.cpu() for o in self._drive(pod, max(r.prompt_len for r in pod))]
        dt = time.perf_counter() - t0
        self.stats["generate_s"] += dt
        self._record_tier(len(pod), dt)
        return [(r.rid, outs[i]) for i, r in enumerate(pod)]

    # -- cascade route -------------------------------------------------------

    def _admit_cascade_pods(self) -> None:
        """Feed every admission-ready pod into the stage pipeline (the §V-A
        stagger recorded per pod); a pod admitted mid-flight joins the
        partially drained first-stage queue."""
        for pod in self._admit_pods_ready():
            self._record_pod_profile(pod)
            for r in pod:
                width = min(bucket_of(r.prompt_len, self.serve_cfg.buckets),
                            self.workload.max_prompt_len)
                width = max(width, r.prompt_len)
                toks = np.zeros(width, np.int32)
                toks[: r.prompt_len] = r.state["prompt"]
                self.pipeline.submit(r.rid, toks, max_new_tokens=r.max_new_tokens)

    def _step_cascade(self) -> list[tuple[int, Any]]:
        self._admit_cascade_pods()
        t0 = time.perf_counter()
        done = [(rid, out.cpu()) for rid, out in self.pipeline.tick()]
        dt = time.perf_counter() - t0
        self.stats["generate_s"] += dt
        self._record_tier(len(done), dt)
        return done

    # -- fleet hooks: stage-boundary preemption / migration ------------------

    def _require_pipeline(self, what: str):
        if self.pipeline is None:
            raise ValueError(f"{what} requires the cascade route (stage-boundary state lives "
                             f"in the pipeline's StageBuffers); this engine serves route "
                             f"{self.route!r}: construct it with ServeConfig(route='cascade')")
        return self.pipeline

    def parked_rids(self) -> list[int]:
        """Rids whose state waits at a stage boundary in this engine's
        pipeline: the preemptible set (empty off the cascade route)."""
        return [] if self.pipeline is None else self.pipeline.queued_rids()

    def preempt(self, rids) -> list:
        """Preempt ``rids`` at their current stage boundary and return their
        ``ParkedTask`` payloads, to resume here or on an engine with the same
        ``ServeConfig.seed`` (the same output either way)."""
        return self._require_pipeline("preempt()").park(rids)

    def resume(self, parked: list) -> None:
        """Re-admit parked stage state (from :meth:`preempt`, possibly of
        another engine) at its recorded stage boundary."""
        self._require_pipeline("resume()").resume(parked)

    def _finalize_cascade_stats(self) -> None:
        """Refresh ``stats["cascade"]`` once the pipeline drains, with the
        engine-level admission and latency report."""
        self.stats["cascade"] = self.pipeline.summary()
        self.stats["cascade"]["admission"] = {
            "policy": self.serve_cfg.admission,
            "flush_wait_ticks": self.serve_cfg.arrival_flush_wait,
            "wait_ticks": self._admission_waits.summary(),
        }
        self.stats["cascade"]["request_latency_ticks"] = self._e2e_ticks.summary()

    # -- unified loop --------------------------------------------------------

    def step(self) -> list[tuple[int, Any]]:
        """Advance the clock one tick: admit due arrivals, serve one batch /
        pod / pipeline round, release closed-loop requests for completions.
        Returns completed ``(rid, out)`` pairs, outputs on the host."""
        t0 = time.perf_counter()
        self._admit_arrivals()
        if self.route == "cascade":
            n_exec = len(self.pipeline.executed)
            done = self._step_cascade()
            busy = len(self.pipeline.executed) > n_exec
        elif self.route == "lm":
            done = self._step_lm()
            busy = bool(done)
        else:
            done = self._step_pod()
            busy = bool(done)
        if busy:  # tick -> wall-clock calibration sample (busy ticks only)
            self._busy_wall_s.observe(time.perf_counter() - t0)
        self._completed += len(done)
        self._completed_c.inc(len(done))
        for rid, _ in done:
            if rid in self._arrival_tick:
                arrival = self._arrival_tick[rid]
                self._e2e_ticks.observe(self._tick - arrival)
                self.spans.span("request", cat="request", start_tick=arrival,
                                end_tick=self._tick, lane="request", rid=rid)
            if self._closed_loop:  # one completion releases one waiter
                self._enqueue(self._closed_loop.popleft(), self._tick)
        self._tick += 1
        self._pending_g.set(self.pending())
        if not self.pending():
            if self.route == "cascade":
                self._finalize_cascade_stats()
            self._finalize_clock()
        return done

    # -- tick -> wall-clock calibration --------------------------------------

    def tick_seconds(self) -> float:
        """Wall seconds per tick: ``ServeConfig.tick_seconds``, else the
        median busy-tick time (the median: the first tick of each shape pays
        for the kernels' first calls)."""
        if self.serve_cfg.tick_seconds is not None:
            return float(self.serve_cfg.tick_seconds)
        if self._busy_wall_s.count:
            return self._busy_wall_s.median()
        return 0.0

    def _finalize_clock(self) -> None:
        """``stats["clock"]`` with the wall-clock req/s and tail latencies
        derived from the tick clock."""
        ts = self.tick_seconds()
        self.stats["clock"] = {
            "tick_seconds": ts,
            "source": "configured" if self.serve_cfg.tick_seconds is not None else "calibrated",
            "ticks": self._tick,
            "busy_ticks": len(self._busy_wall_s),
        }
        lat_ticks = self._e2e_ticks.summary()
        self.stats["request_latency_ticks"] = lat_ticks
        self.stats["request_latency_s"] = {k: v * ts for k, v in lat_ticks.items()}
        wall = self._tick * ts
        self.stats["requests_per_s"] = (self._completed / wall) if wall else 0.0

    def pending(self) -> int:
        """Requests anywhere in the system: deferred arrivals, scheduler
        queues, admitted-but-unserved pods, and the stage pipeline."""
        return (self.scheduler.pending() + self._arrivals_deferred()
                + sum(len(p) for p in self._ready_pods)
                + (self.pipeline.pending() if self.pipeline is not None else 0))

    def run(self) -> dict:
        """Step until drained; returns ``{rid: output}``.  With deferred
        arrivals the loop idles through empty ticks until the clock reaches
        them: the tick clock, not wall time, is the simulation axis."""
        results = {}
        while self.pending():
            for rid, out in self.step():
                results[rid] = out
        return results

    # -- telemetry export ----------------------------------------------------

    def snapshot(self) -> dict:
        """Versioned ``MetricsRegistry.snapshot()`` of the typed metrics."""
        return self.metrics.snapshot()

    def export_chrome_trace(self, path: str, **metadata) -> int:
        """Write the span timeline as Chrome trace-event JSON (Perfetto);
        returns the event count.  Ticks become wall microseconds through the
        calibrated :meth:`tick_seconds`."""
        return write_chrome_trace(path, [self.spans], self.tick_seconds() or 1.0, **metadata)


class LMServeEngine(ServeEngine):
    """The reference's name for the LM-route engine."""
