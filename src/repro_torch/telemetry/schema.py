"""Versioned schema for the serving stats surfaces, with validators; the
port of ``repro.telemetry.schema``.

``engine.stats`` (per route) and ``MetricsRegistry.snapshot()`` are the
repo's observable contracts — ``docs/serving.md`` describes them, benches
and tests consume them.  The validators of the fleet and mesh blocks come
with the fleet and mesh slices of the port.  This module pins them: the stats dict carries a ``schema``
version stamp, and the ``validate_*`` functions walk the full shape,
collecting every violation before raising, so a drive-by key rename fails
loudly in ``tests/test_torch_serving.py`` instead of silently breaking a
downstream consumer.

Bump the version when a key is added/renamed/retyped, and update the docs
table in the same change.
"""

from __future__ import annotations

import numbers

from repro_torch.kernels.tiers import TIERS

STATS_SCHEMA_VERSION = "engine-stats/v1"
SNAPSHOT_SCHEMA_VERSION = "metrics-snapshot/v1"

PCTL_KEYS = frozenset({"p50", "p95", "mean", "max"})

__all__ = [
    "STATS_SCHEMA_VERSION",
    "SNAPSHOT_SCHEMA_VERSION",
    "PCTL_KEYS",
    "validate_engine_stats",
    "validate_snapshot",
]


def _is_num(v) -> bool:
    return isinstance(v, numbers.Real) and not isinstance(v, bool)


class _Ctx:
    def __init__(self):
        self.errors: list[str] = []

    def check(self, cond: bool, msg: str) -> bool:
        if not cond:
            self.errors.append(msg)
        return bool(cond)

    def num(self, d: dict, key: str, path: str, minimum=None) -> None:
        if not self.check(key in d, f"{path}: missing key {key!r}"):
            return
        v = d[key]
        if not self.check(_is_num(v), f"{path}.{key}: expected number, got {type(v).__name__}"):
            return
        if minimum is not None:
            self.check(v >= minimum, f"{path}.{key}: {v} < {minimum}")

    def pctl(self, d: dict, key: str, path: str) -> None:
        if not self.check(key in d, f"{path}: missing key {key!r}"):
            return
        v = d[key]
        if not self.check(isinstance(v, dict), f"{path}.{key}: expected pctl dict"):
            return
        self.check(set(v) == PCTL_KEYS,
                   f"{path}.{key}: keys {sorted(v)} != {sorted(PCTL_KEYS)}")
        for k, x in v.items():
            self.check(_is_num(x), f"{path}.{key}.{k}: expected number")

    def raise_if_failed(self, what: str) -> None:
        if self.errors:
            detail = "\n  - ".join(self.errors)
            raise ValueError(f"{what} failed schema validation:\n  - {detail}")


def _validate_stage_report(c: _Ctx, s: dict, path: str) -> None:
    for k in ("batches", "items"):
        c.num(s, k, path, minimum=0)
    c.num(s, "exec_s", path, minimum=0.0)
    c.num(s, "mean_batch", path, minimum=0.0)
    c.num(s, "max_batch", path, minimum=1)
    c.num(s, "throughput_rps", path, minimum=0.0)
    c.check(isinstance(s.get("impl"), str), f"{path}.impl: expected str")
    # what ran: the port's tiers, never a requested alias such as "pallas"
    c.check(s.get("effective_impl") in TIERS,
            f"{path}.effective_impl: {s.get('effective_impl')!r} not in {TIERS}")
    c.pctl(s, "service_s", path)
    c.pctl(s, "queue_wait_ticks", path)
    if c.check(isinstance(s.get("queue"), dict), f"{path}.queue: expected dict"):
        q = s["queue"]
        c.check("capacity" in q and (q["capacity"] is None or _is_num(q["capacity"])),
                f"{path}.queue.capacity: expected int or None (unbounded)")
        c.num(q, "mean_occupancy", f"{path}.queue", minimum=0.0)
        c.num(q, "max_occupancy", f"{path}.queue", minimum=0)


def _validate_cascade(c: _Ctx, cas: dict, path: str = "cascade") -> None:
    if c.check(isinstance(cas.get("stages"), dict) and cas.get("stages"),
               f"{path}.stages: expected non-empty dict"):
        for name, s in cas["stages"].items():
            _validate_stage_report(c, s, f"{path}.stages[{name}]")
    if c.check(isinstance(cas.get("tiers"), dict), f"{path}.tiers: expected dict"):
        for tier, t in cas["tiers"].items():
            tp = f"{path}.tiers[{tier}]"
            c.check(isinstance(t.get("requested"), list), f"{tp}.requested: expected list")
            c.check(isinstance(t.get("stages"), list), f"{tp}.stages: expected list")
            c.num(t, "items", tp, minimum=0)
            c.num(t, "exec_s", tp, minimum=0.0)
            c.num(t, "rps", tp, minimum=0.0)
    for k in ("submitted", "completed", "parked", "resumed", "ticks"):
        c.num(cas, k, path, minimum=0)
    if c.check(isinstance(cas.get("concurrency"), dict), f"{path}.concurrency: expected dict"):
        c.num(cas["concurrency"], "max", f"{path}.concurrency", minimum=0)
        c.num(cas["concurrency"], "mean", f"{path}.concurrency", minimum=0.0)
    if c.check(isinstance(cas.get("hbm"), dict), f"{path}.hbm: expected dict"):
        hbm = cas["hbm"]
        for side in ("lockstep", "pipelined"):
            if c.check(isinstance(hbm.get(side), dict), f"{path}.hbm.{side}: expected dict"):
                for k in ("modeled_time", "modeled_throughput", "peak_demand",
                          "mean_demand", "flatness"):
                    c.num(hbm[side], k, f"{path}.hbm.{side}", minimum=0.0)
        c.num(hbm, "throughput_gain", f"{path}.hbm", minimum=0.0)
    if c.check(isinstance(cas.get("admission"), dict), f"{path}.admission: expected dict"):
        adm = cas["admission"]
        c.check(adm.get("policy") in ("continuous", "pod"),
                f"{path}.admission.policy: {adm.get('policy')!r}")
        c.num(adm, "flush_wait_ticks", f"{path}.admission", minimum=0)
        c.pctl(adm, "wait_ticks", f"{path}.admission")
    c.pctl(cas, "request_latency_ticks", path)


def validate_engine_stats(stats: dict, route: str) -> None:
    """Validate a drained engine's ``stats`` for ``route`` in
    ``("lm", "pod", "cascade")``; raises ValueError listing every
    violation."""
    c = _Ctx()
    c.check(stats.get("schema") == STATS_SCHEMA_VERSION,
            f"stats.schema: {stats.get('schema')!r} != {STATS_SCHEMA_VERSION!r}")
    c.num(stats, "requests", "stats", minimum=0)
    c.check(isinstance(stats.get("impl"), str), "stats.impl: expected str")
    c.check(isinstance(stats.get("stage_impl"), dict), "stats.stage_impl: expected dict")
    if c.check(isinstance(stats.get("tier_throughput"), dict),
               "stats.tier_throughput: expected dict"):
        for tier, t in stats["tier_throughput"].items():
            tp = f"stats.tier_throughput[{tier}]"
            c.num(t, "requests", tp, minimum=0)
            c.num(t, "wall_s", tp, minimum=0.0)
            c.num(t, "rps", tp, minimum=0.0)
    if c.check(isinstance(stats.get("stages"), dict), "stats.stages: expected dict"):
        for name, s in stats["stages"].items():
            sp = f"stats.stages[{name}]"
            c.num(s, "exec_s", sp, minimum=0.0)
            c.num(s, "items", sp, minimum=0)
            c.num(s, "dispatches", sp, minimum=0)
    # clock + derived wall-clock stats (present once the engine drained)
    if c.check(isinstance(stats.get("clock"), dict), "stats.clock: expected dict"):
        clock = stats["clock"]
        c.check(set(clock) == {"tick_seconds", "source", "ticks", "busy_ticks"},
                f"stats.clock: keys {sorted(clock)}")
        c.num(clock, "tick_seconds", "stats.clock", minimum=0.0)
        c.check(clock.get("source") in ("configured", "calibrated"),
                f"stats.clock.source: {clock.get('source')!r}")
        c.num(clock, "ticks", "stats.clock", minimum=0)
        c.num(clock, "busy_ticks", "stats.clock", minimum=0)
    c.pctl(stats, "request_latency_ticks", "stats")
    c.pctl(stats, "request_latency_s", "stats")
    c.num(stats, "requests_per_s", "stats", minimum=0.0)

    if route == "lm":
        c.num(stats, "prefill_s", "stats", minimum=0.0)
        c.num(stats, "decode_s", "stats", minimum=0.0)
        c.num(stats, "tokens", "stats", minimum=0)
        c.check(isinstance(stats.get("padding_waste"), list),
                "stats.padding_waste: expected list")
    elif route in ("pod", "cascade"):
        c.num(stats, "generate_s", "stats", minimum=0.0)
        c.num(stats, "pods", "stats", minimum=0)
        c.check(isinstance(stats.get("bandwidth_profile"), list),
                "stats.bandwidth_profile: expected list")
        if route == "cascade":
            if c.check(isinstance(stats.get("cascade"), dict) and stats.get("cascade"),
                       "stats.cascade: expected non-empty dict"):
                _validate_cascade(c, stats["cascade"])
    else:
        c.check(False, f"unknown route {route!r}")
    c.raise_if_failed(f"engine.stats (route={route!r})")


def validate_snapshot(snap: dict) -> None:
    """Validate a ``MetricsRegistry.snapshot()`` payload."""
    c = _Ctx()
    c.check(snap.get("schema") == SNAPSHOT_SCHEMA_VERSION,
            f"snapshot.schema: {snap.get('schema')!r} != {SNAPSHOT_SCHEMA_VERSION!r}")
    for kind in ("counters", "gauges", "histograms"):
        if not c.check(isinstance(snap.get(kind), dict),
                       f"snapshot.{kind}: expected dict"):
            continue
        for name, v in snap[kind].items():
            p = f"snapshot.{kind}[{name}]"
            if kind == "histograms":
                if c.check(isinstance(v, dict), f"{p}: expected dict"):
                    for k in ("count", "sum", "min", "p50", "p95", "mean", "max"):
                        c.num(v, k, p)
            else:
                c.check(_is_num(v), f"{p}: expected number")
    c.raise_if_failed("metrics snapshot")
