"""One fleet replica: per-pool serving engines time-sharing one device, the
port of ``repro.fleet.replica``.

A replica models one accelerator host serving the fleet's workload *pools*
(e.g. an interactive TTI pool and a batch TTV pool).  Each pool gets its own
``ServeEngine`` forced onto the cascade route, the route whose between-tick
state lives entirely in stage buffers, so any queued request is preemptible
at a stage boundary (``ServeEngine.preempt`` / ``resume``).  All replicas of
a fleet share the same workload and params objects and the same
``ServeConfig.seed``, which is what makes cross-replica migration give the
same output under the ``stage_generator(seed, rid, stage_index)`` contract.

One fleet tick steps ONE pool's engine per replica: the pools time-share
the device, they don't run concurrently.  Which pool runs is the engine
policy:

``"fifo"``
    Run to completion: the pool of the oldest in-flight request, whatever
    its tier.  A long batch job admitted first starves interactive arrivals
    behind it, the baseline pathology the SLO policy exists to fix.
``"slo"``
    The pool of the oldest in-flight *interactive* request, falling back to
    FIFO when none is waiting.  Batch-tier work is implicitly preempted:
    its state stays parked at its stage boundary (in the cascade's buffers)
    until no interactive work remains.

With ``ServeConfig.mesh`` every pool's params are sharded once for the
fleet (:func:`normalize_pools`), and each replica's engines serve SPMD over
the mesh.
"""

from __future__ import annotations

import dataclasses

from repro_torch.serving.engine import ServeConfig, ServeEngine
from repro_torch.workload import GenerativeWorkload, workload_for

ENGINE_POLICIES = ("fifo", "slo")


@dataclasses.dataclass
class RequestMeta:
    """Fleet-ledger entry for one in-flight request: which pool serves it,
    its SLO class, and its arrival on the *fleet* tick clock (the clock all
    deadline attainment is measured on; an engine's own clock advances only
    when its replica steps it)."""

    rid: int
    pool: str
    tier: str  # SLO_TIERS: "interactive" | "batch"
    deadline_ticks: int | None  # end-to-end budget on the fleet clock
    arrival: int  # fleet tick of admission


def normalize_pools(pools: dict, mesh=None) -> dict:
    """``{name: (workload_or_config, params)}`` -> workload instances: one
    shared instance a pool, which every replica's engine for that pool
    reuses.  With a ``mesh``, params are sharded once here, so the
    replicas' engines all reuse the same placed copy."""
    out = {}
    for name, (wl, params) in pools.items():
        if not isinstance(wl, GenerativeWorkload):
            wl = workload_for(wl)
        if mesh is not None:
            params = wl.shard_params(params, mesh)
        out[name] = (wl, params)
    return out


class FleetReplica:
    """N pools' engines behind one device clock, with preemption accounting.

    ``preempted_ticks`` counts ticks the replica served an interactive pool
    while batch-tier state sat parked in another pool's pipeline (the
    implicit stage-boundary preemption of the ``"slo"`` engine policy);
    ``preemptions`` counts the transitions into that condition, i.e.
    distinct preemption *events*, where the batch pool that ran before was
    displaced."""

    def __init__(self, index: int, pools: dict, serve_cfg: ServeConfig = ServeConfig()):
        self.index = index
        cfg = dataclasses.replace(serve_cfg, route="cascade")
        self.engines = {name: ServeEngine(wl, params, cfg)
                        for name, (wl, params) in normalize_pools(pools, mesh=cfg.mesh).items()}
        for name, eng in self.engines.items():
            # one Chrome-trace track per (replica, pool) engine timeline
            eng.spans.track = f"replica{index}/{name}"
        self.meta: dict[int, RequestMeta] = {}  # rid -> in-flight meta
        self.active = True  # False = draining (autoscaled out): no placements
        self.ticks = 0
        self.busy_ticks = 0
        self.preempted_ticks = 0
        self.preemptions = 0
        self._last_pool: str | None = None

    # -- placement interface -------------------------------------------------

    def submit(self, tokens, meta: RequestMeta, max_new_tokens: int = 0) -> None:
        """Place one routed request on this replica.  ``arrival_tick=0``
        admits it now: arrival timing is the fleet router's job, on the fleet
        clock; the engine's own clock only schedules."""
        self.engines[meta.pool].submit(
            meta.rid, tokens, max_new_tokens=max_new_tokens, arrival_tick=0,
            slo_tier=meta.tier, deadline_ticks=meta.deadline_ticks)
        self.meta[meta.rid] = meta

    def pending(self) -> int:
        return sum(e.pending() for e in self.engines.values())

    def inflight(self, tier: str | None = None) -> int:
        """In-flight requests on this replica, optionally of one SLO tier:
        the placement-scoring signal."""
        if tier is None:
            return len(self.meta)
        return sum(1 for m in self.meta.values() if m.tier == tier)

    def saturation(self) -> float:
        """Occupied fraction of the *bounded* stage buffers across all
        pools, in [0, 1]: the load signal behind least-queue placement.
        Unbounded buffers report ``free_slots() is None`` and are skipped."""
        used = cap = 0
        for e in self.engines.values():
            if e.pipeline is None:
                continue
            for b in e.pipeline.buffers:
                fs = b.free_slots()
                if fs is None:
                    continue
                cap += b.capacity
                used += b.capacity - fs
        return (used / cap) if cap else 0.0

    # -- preemption / migration ----------------------------------------------

    def parked_rids(self, pool: str, tier: str | None = None) -> list[int]:
        """Rids parked at a stage boundary in ``pool``'s pipeline now
        (optionally of one SLO tier): the preemptible, migratable set."""
        rids = self.engines[pool].parked_rids()
        if tier is None:
            return rids
        return [r for r in rids if (m := self.meta.get(r)) is not None and m.tier == tier]

    def migrate_out(self, pool: str, rids) -> tuple[list, list[RequestMeta]]:
        """Preempt ``rids`` out of ``pool`` at their stage boundaries;
        returns ``(parked_tasks, metas)`` for :meth:`migrate_in` on the
        destination replica."""
        parked = self.engines[pool].preempt(rids)
        metas = [self.meta.pop(p.rid) for p in parked]
        return parked, metas

    def migrate_in(self, pool: str, parked: list, metas: list[RequestMeta]) -> None:
        """Absorb preempted state from another replica; it continues as it
        would have at home, since all replicas share ``ServeConfig.seed``."""
        self.engines[pool].resume(parked)
        for m in metas:
            self.meta[m.rid] = m

    # -- the device tick -----------------------------------------------------

    def choose_pool(self, policy: str = "fifo") -> str | None:
        """Which pool the device serves this tick (None = idle)."""
        if policy not in ENGINE_POLICIES:
            raise ValueError(f"unknown engine policy {policy!r} "
                             f"(expected one of {ENGINE_POLICIES})")
        if not self.meta:
            return None
        metas = list(self.meta.values())
        if policy == "slo":
            interactive = [m for m in metas if m.tier == "interactive"]
            if interactive:
                metas = interactive
        return min(metas, key=lambda m: (m.arrival, m.rid)).pool

    def step(self, policy: str = "fifo", now: int | None = None) -> list:
        """One device tick: serve one pool's engine for one scheduling
        round.  Returns completed ``(rid, output, RequestMeta)`` triples.

        ``now`` is the fleet tick this device tick runs at (when a
        ``FleetRouter`` drives it); it only feeds the telemetry clock map, so
        the replicas' span tracks align on the shared fleet timeline though
        an engine's own clock advances only when its pool is chosen."""
        self.ticks += 1
        pool = self.choose_pool(policy)
        if pool is None:
            self._last_pool = None
            return []
        if now is not None:
            eng = self.engines[pool]
            eng.spans.map_tick(eng._tick, now)
        # implicit stage-boundary preemption: serving this pool while batch
        # work sits parked in another pool's pipeline
        starved = [p for p in self.engines if p != pool and self.parked_rids(p, tier="batch")]
        if starved:
            self.preempted_ticks += 1
            if self._last_pool in starved:
                self.preemptions += 1
        self._last_pool = pool
        self.busy_ticks += 1
        done = self.engines[pool].step()
        return [(rid, out, self.meta.pop(rid)) for rid, out in done]

    # -- reporting -----------------------------------------------------------

    def summary(self) -> dict:
        pipes = [e.pipeline for e in self.engines.values() if e.pipeline is not None]
        return {
            "active": self.active,
            "ticks": self.ticks,
            "busy_ticks": self.busy_ticks,
            "utilization": (self.busy_ticks / self.ticks) if self.ticks else 0.0,
            "inflight": self.inflight(),
            "preempted_ticks": self.preempted_ticks,
            "preemptions": self.preemptions,
            "parked": sum(p.parked for p in pipes),
            "resumed": sum(p.resumed for p in pipes),
        }
