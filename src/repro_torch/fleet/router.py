"""SLO-classed fleet router over N serving-engine replicas, the port of
``repro.fleet.router``.

``FleetRouter`` is the deployment layer above ``ServeEngine``: it owns the
shared fleet tick clock, admits an arrival trace against it, places each
request on a replica by a pluggable policy, optionally migrates preempted
batch work between replicas at cascade stage boundaries, and applies an
autoscaling policy, all while keeping a fleet ledger that turns completions
into per-tier deadline-attainment and latency reports
(``engine.stats["fleet"]``, checked by ``telemetry.validate_fleet_summary``).

Placement policies (``FleetRouter(policy=...)``):

``"round-robin"``
    Cycle over active replicas.  Load- and SLO-blind; the baseline.
``"least-queue"``
    The active replica with the smallest backlog, ties broken by
    stage-buffer saturation (the occupied fraction of *bounded* buffers,
    from ``StageBuffer.free_slots``, which is ``None`` for unbounded ones).
``"slo"``
    Tier-aware spreading: interactive requests avoid replicas loaded with
    batch work and vice versa, so the tiers segregate when capacity allows.
    Also switches every replica's device tick to the SLO engine policy
    (oldest *interactive* request first): batch work parks at its stage
    boundary whenever interactive work is waiting.

With ``preempt=True`` (slo policy only) the router also *migrates*: when a
replica has interactive backlog and batch-tier state parked in its
pipelines, that parked state moves, ``ServeEngine.preempt`` on the source,
``ServeEngine.resume`` on a strictly less loaded destination.  Because every
replica shares one ``ServeConfig.seed``, the resumed request's remaining
stages draw the noise they would have drawn at home under the
``stage_generator(seed, rid, stage_index)`` contract.
"""

from __future__ import annotations

import heapq

import numpy as np

from repro_torch.fleet.autoscale import AutoscalePolicy
from repro_torch.fleet.replica import FleetReplica, RequestMeta, normalize_pools
from repro_torch.serving.engine import ServeConfig
from repro_torch.telemetry import SpanCollector, percentiles, write_chrome_trace
from repro_torch.workload.base import SLO_TIERS

PLACEMENT_POLICIES = ("round-robin", "least-queue", "slo")

#: Weight of cross-tier in-flight work in the "slo" placement score: a
#: replica holding opposite-tier work is penalized this many queue slots per
#: request, steering tiers onto disjoint replicas when capacity allows.
CROSS_TIER_WEIGHT = 2.0


class FleetRouter:
    """Routes an SLO-classed request stream across ``FleetReplica``s.

    ``pools`` maps pool names to ``(workload_or_config, params)``, e.g.
    ``{"tti": (tti_wl, tti_params), "ttv": (ttv_wl, ttv_params)}``.  Every
    replica hosts one engine per pool (the same workload and params objects,
    the same seed: migration keeps a request's output).

    With ``autoscale`` set, ``n_replicas`` is ignored: the fleet is built
    at ``autoscale.max_replicas`` and starts with ``min_replicas`` active.
    """

    def __init__(self, pools: dict, serve_cfg: ServeConfig = ServeConfig(), *,
                 n_replicas: int = 2, policy: str = "round-robin", preempt: bool = False,
                 autoscale: AutoscalePolicy | None = None):
        if policy not in PLACEMENT_POLICIES:
            raise ValueError(f"unknown placement policy {policy!r} "
                             f"(expected one of {PLACEMENT_POLICIES})")
        if preempt and policy != "slo":
            raise ValueError("preempt=True is the slo policy's migration knob; "
                             f"policy {policy!r} never preempts (set policy='slo')")
        if n_replicas < 1 and autoscale is None:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.pools = normalize_pools(pools)
        self.policy = policy
        self.preempt = preempt
        self.autoscale = autoscale
        self.engine_policy = "slo" if policy == "slo" else "fifo"
        n = autoscale.max_replicas if autoscale is not None else n_replicas
        self.replicas = [FleetReplica(i, self.pools, serve_cfg) for i in range(n)]
        if autoscale is not None:
            for rep in self.replicas[autoscale.min_replicas:]:
                rep.active = False
        # -- fleet clock + ledger --------------------------------------------
        self._tick = 0
        self._future: list = []  # heap: (arrival, seq, tokens, max_new, meta)
        self._seq = 0
        self.ledger: dict[int, RequestMeta] = {}  # every rid ever submitted
        self.completed: dict[int, dict] = {}  # rid -> completion record
        self.results: dict = {}  # rid -> output
        self.migrations = 0
        self.replica_trajectory: list[int] = []  # active count per tick
        self.replica_ticks = 0  # total replica-ticks consumed (cost)
        self.scale_events: list[tuple[int, int]] = []  # (tick, new active)
        self._last_scale = -(10 ** 9)
        self._rr = 0
        self._stats: dict | None = None
        # fleet-scope instants (migrate/scale) on the fleet tick clock
        self.spans = SpanCollector(track="fleet")

    # -- submission ----------------------------------------------------------

    def submit(self, pool: str, rid: int, tokens, *, arrival_tick: int = 0,
               max_new_tokens: int = 0, slo_tier: str | None = None,
               deadline_ticks: int | None = None) -> None:
        """Enqueue one request for fleet admission at ``arrival_tick`` on
        the fleet clock (``ArrivalTrace.ticks`` generates these).  The SLO
        class is checked now, by the pool workload's ``prepare_request``;
        routing happens at admission, against the replica load then."""
        if pool not in self.pools:
            raise ValueError(f"unknown pool {pool!r} (pools: {sorted(self.pools)})")
        if rid in self.ledger:
            raise ValueError(f"duplicate rid {rid}: fleet rids must be unique across pools; "
                             f"the PRNG contract folds them fleet-wide")
        if arrival_tick is None:
            raise ValueError("fleet serving needs timed arrivals; closed-loop ON_COMPLETION "
                             "admission is a single-engine mode (ServeEngine.submit)")
        wl, _ = self.pools[pool]
        req = wl.prepare_request(rid, tokens, max_new_tokens=max_new_tokens, slo_tier=slo_tier,
                                 deadline_ticks=deadline_ticks)
        meta = RequestMeta(rid=rid, pool=pool, tier=req.slo_tier,
                           deadline_ticks=req.deadline_ticks,
                           arrival=max(int(arrival_tick), self._tick))
        self._seq += 1
        heapq.heappush(self._future, (meta.arrival, self._seq, tokens, max_new_tokens, meta))
        self.ledger[rid] = meta

    def submit_trace(self, pool: str, trace, n: int, *, rid_start: int = 0, prompts=None,
                     prompt_len: int = 8, max_new_tokens: int = 0,
                     slo_tier: str | None = None,
                     deadline_ticks: int | None = None) -> list[int]:
        """Submit ``n`` requests of one pool along an ``ArrivalTrace``.
        ``prompts=None`` draws seeded random prompts of ``prompt_len`` from
        the pool's vocab.  Returns the rids used."""
        wl, _ = self.pools[pool]
        if prompts is None:
            rng = np.random.default_rng(trace.seed + rid_start)
            prompts = rng.integers(0, wl.prompt_vocab, (n, prompt_len))
        rids = []
        for i, tick in enumerate(trace.ticks(n)):
            rid = rid_start + i
            self.submit(pool, rid, np.asarray(prompts[i], np.int32), arrival_tick=tick,
                        max_new_tokens=max_new_tokens, slo_tier=slo_tier,
                        deadline_ticks=deadline_ticks)
            rids.append(rid)
        return rids

    # -- placement -----------------------------------------------------------

    def _active(self) -> list[FleetReplica]:
        return [r for r in self.replicas if r.active]

    def _place(self, meta: RequestMeta, tokens, max_new_tokens: int) -> None:
        active = self._active()
        if self.policy == "round-robin":
            rep = active[self._rr % len(active)]
            self._rr += 1
        elif self.policy == "least-queue":
            # backlog + bounded-buffer saturation (the fractional term breaks
            # backlog ties toward drained pipelines)
            rep = min(active, key=lambda r: (r.pending() + r.saturation(), r.index))
        else:  # "slo": steer away from opposite-tier load
            other = "batch" if meta.tier == "interactive" else "interactive"
            rep = min(active, key=lambda r: (r.pending() + CROSS_TIER_WEIGHT * r.inflight(other),
                                             r.index))
        rep.submit(tokens, meta, max_new_tokens=max_new_tokens)

    def _admit_due(self) -> None:
        while self._future and self._future[0][0] <= self._tick:
            _, _, tokens, mnt, meta = heapq.heappop(self._future)
            self._place(meta, tokens, mnt)

    # -- migration (slo policy + preempt=True) -------------------------------

    def _migrate(self) -> None:
        """Move batch-tier state parked at stage boundaries off replicas
        with interactive backlog, onto a strictly less loaded replica."""
        active = self._active()
        if len(active) < 2:
            return
        for src in active:
            if src.inflight("interactive") == 0:
                continue
            parked = {pool: src.parked_rids(pool, tier="batch") for pool in src.engines}
            total = sum(len(v) for v in parked.values())
            if total == 0:
                continue
            others = [r for r in active if r is not src]
            dst = min(others, key=lambda r: (r.pending(), r.index))
            if dst.pending() + total >= src.pending():
                continue  # migration must strictly improve the imbalance
            for pool, rids in parked.items():
                if not rids:
                    continue
                tasks, metas = src.migrate_out(pool, rids)
                dst.migrate_in(pool, tasks, metas)
                self.migrations += len(tasks)
                for t in tasks:
                    self.spans.instant("migrate", tick=self._tick, cat="preempt",
                                       lane="migrate", rid=t.rid, pool=pool, src=src.index,
                                       dst=dst.index)

    # -- autoscaling ---------------------------------------------------------

    def _autoscale_tick(self) -> None:
        pol = self.autoscale
        if pol is None or self._tick - self._last_scale < pol.cooldown:
            return
        active = len(self._active())
        backlog = sum(r.pending() for r in self.replicas)
        want = pol.desired(active, backlog)
        if want == active:
            return
        self._last_scale = self._tick
        if want > active:  # activate the lowest-index idle replica
            nxt = min((r for r in self.replicas if not r.active), key=lambda r: r.index)
            nxt.active = True
        else:  # drain the emptiest active replica (its in-flight work finishes)
            out = min(self._active(), key=lambda r: (r.pending(), -r.index))
            out.active = False
        self.scale_events.append((self._tick, len(self._active())))
        self.spans.instant("scale", tick=self._tick, cat="sched", lane="autoscale",
                           active=len(self._active()), backlog=backlog)

    # -- the shared fleet tick -----------------------------------------------

    def step(self) -> list:
        """One fleet tick: admit due arrivals, autoscale, migrate, then step
        every replica that is active or still draining.  Returns completed
        ``(rid, output)`` pairs."""
        self._admit_due()
        self._autoscale_tick()
        if self.preempt:
            self._migrate()
        done = []
        stepped = 0
        for rep in self.replicas:
            if not (rep.active or rep.pending()):
                continue
            stepped += 1
            for rid, out, meta in rep.step(self.engine_policy, now=self._tick):
                latency = self._tick - meta.arrival
                met = meta.deadline_ticks is None or latency <= meta.deadline_ticks
                self.completed[rid] = {
                    "pool": meta.pool, "tier": meta.tier, "replica": rep.index,
                    "arrival": meta.arrival, "latency_ticks": latency,
                    "deadline_ticks": meta.deadline_ticks, "met": met,
                }
                self.results[rid] = out
                done.append((rid, out))
        self.replica_trajectory.append(len(self._active()))
        self.replica_ticks += stepped
        self._tick += 1
        if not self.pending():
            self._finalize()
        return done

    def pending(self) -> int:
        return len(self._future) + sum(r.pending() for r in self.replicas)

    def run(self) -> dict:
        """Step until the fleet drains; returns ``{rid: output}``."""
        while self.pending():
            self.step()
        return dict(self.results)

    # -- telemetry export ----------------------------------------------------

    def collectors(self) -> list:
        """All span collectors: the fleet's instants and every replica
        engine's."""
        cols = [self.spans]
        for rep in self.replicas:
            cols += [e.spans for e in rep.engines.values()]
        return cols

    def tick_seconds(self) -> float:
        """Fleet-clock wall seconds a tick: the median of the replica
        engines' calibrated clocks (they time-share identical devices)."""
        samples = [ts for rep in self.replicas for e in rep.engines.values()
                   if (ts := e.tick_seconds()) > 0]
        return float(np.median(samples)) if samples else 0.0

    def export_chrome_trace(self, path: str, **metadata) -> int:
        """Write the whole fleet's timeline as Chrome trace-event JSON: one
        track per (replica, pool) engine plus a fleet track with the
        migrate/scale instants, all on the shared fleet tick clock (replica
        span ticks remapped through each engine's clock map).  Open it at
        https://ui.perfetto.dev.  Returns the event count."""
        return write_chrome_trace(path, self.collectors(), self.tick_seconds() or 1.0,
                                  **metadata)

    # -- reporting -----------------------------------------------------------

    def _finalize(self) -> None:
        """Freeze the fleet summary and mirror it into every replica
        engine's ``stats["fleet"]``."""
        self._stats = self.summary()
        for rep in self.replicas:
            for eng in rep.engines.values():
                eng.stats["fleet"] = self._stats

    def summary(self) -> dict:
        """The ``engine.stats["fleet"]`` payload: per-tier deadline
        attainment and latency percentiles, preemption and migration counts,
        per-replica utilization, and the autoscale trajectory and cost."""
        tiers = {}
        for tier in SLO_TIERS:
            recs = [c for c in self.completed.values() if c["tier"] == tier]
            dl = [c for c in recs if c["deadline_ticks"] is not None]
            margins = [c["deadline_ticks"] - c["latency_ticks"] for c in dl]
            tiers[tier] = {
                "requests": len(recs),
                "latency_ticks": percentiles([c["latency_ticks"] for c in recs]),
                "deadline_requests": len(dl),
                "deadline_attainment": (sum(c["met"] for c in dl) / len(dl)) if dl else 1.0,
                "deadline_misses": sum(not c["met"] for c in dl),
                # a negative p50/p95 margin: the median/tail request missed
                "deadline_margin_ticks": percentiles(margins),
            }
        reps = [r.summary() for r in self.replicas]
        traj = self.replica_trajectory
        return {
            "policy": self.policy,
            "engine_policy": self.engine_policy,
            "preempt": self.preempt,
            "pools": sorted(self.pools),
            "ticks": self._tick,
            "requests": len(self.ledger),
            "completed": len(self.completed),
            "tiers": tiers,
            "preemptions": sum(r.preemptions for r in self.replicas),
            "preempted_ticks": sum(r.preempted_ticks for r in self.replicas),
            "parked": sum(r["parked"] for r in reps),
            "resumed": sum(r["resumed"] for r in reps),
            "migrations": self.migrations,
            "replicas": {
                "configured": len(self.replicas),
                "replica_ticks": self.replica_ticks,
                "utilization": [r["utilization"] for r in reps],
                "mean_active": (sum(traj) / len(traj)) if traj else 0.0,
                "max_active": max(traj) if traj else 0,
                "per_replica": reps,
            },
            "autoscale": (None if self.autoscale is None else {
                "min_replicas": self.autoscale.min_replicas,
                "max_replicas": self.autoscale.max_replicas,
                "target_queue": self.autoscale.target_queue,
                "cooldown": self.autoscale.cooldown,
                "scale_events": list(self.scale_events),
            }),
        }
