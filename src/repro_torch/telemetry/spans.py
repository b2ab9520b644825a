"""Request-lifecycle spans on the scheduler-tick timeline; the port of
``repro.telemetry.spans``.

A :class:`SpanEvent` is one slice (or instant) on a per-engine timeline:
``start_tick`` / ``dur_ticks`` are denominated in scheduler ticks; measured
wall-seconds, when known (stage execution), ride along as ``dur_s`` and are
laid out proportionally inside their tick by the Chrome exporter.  Every
engine owns one :class:`SpanCollector` (``engine.spans``); the cascade
pipeline shares it, and the fleet router owns one more for fleet-scope
instants (scale/migrate).

Lifecycle vocabulary (``cat`` field):

- ``request``   — submit -> complete, one span per finished request
- ``admission`` — arrival -> batch/pod admission wait
- ``queue``     — time parked in a stage's bounded handoff buffer
- ``exec``      — one stage batch executing (carries measured ``dur_s``)
- ``preempt``   — park / resume / migrate instants
- ``sched``     — scheduler instants (flush, scale events)

Fleet clock mapping: replica engines keep their own tick counters and only
advance when stepped, so a collector can carry a piecewise (local tick ->
fleet tick) map recorded by :meth:`SpanCollector.map_tick`; the exporter
remaps span timestamps through it so per-replica tracks align on the shared
fleet timeline without touching scheduling state.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Any

__all__ = ["SpanEvent", "SpanCollector"]


@dataclasses.dataclass
class SpanEvent:
    name: str
    cat: str
    start_tick: float
    dur_ticks: float | None = None  # None -> instant event
    dur_s: float | None = None  # measured wall time, exec spans only
    lane: str = "sched"
    rid: int | None = None
    args: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def instant(self) -> bool:
        return self.dur_ticks is None


class SpanCollector:
    """Accumulates SpanEvents for one timeline track (engine/replica/fleet)."""

    def __init__(self, track: str = "engine", enabled: bool = True):
        self.track = track
        self.enabled = enabled
        self.events: list[SpanEvent] = []
        # piecewise (local_tick, global_tick) pairs, appended in step order
        self._clock_map: list[tuple[int, int]] = []

    def __len__(self) -> int:
        return len(self.events)

    def clear(self) -> None:
        self.events.clear()
        self._clock_map.clear()

    # -- recording ---------------------------------------------------------
    def span(
        self,
        name: str,
        *,
        cat: str,
        start_tick: float,
        end_tick: float | None = None,
        dur_ticks: float | None = None,
        dur_s: float | None = None,
        lane: str = "sched",
        rid: int | None = None,
        **args,
    ) -> None:
        if not self.enabled:
            return
        if dur_ticks is None:
            dur_ticks = 0.0 if end_tick is None else max(float(end_tick) - float(start_tick), 0.0)
        self.events.append(SpanEvent(
            name=name, cat=cat, start_tick=float(start_tick),
            dur_ticks=float(dur_ticks), dur_s=dur_s, lane=lane, rid=rid,
            args=dict(args)))

    def instant(
        self,
        name: str,
        *,
        tick: float,
        cat: str = "sched",
        lane: str = "sched",
        rid: int | None = None,
        **args,
    ) -> None:
        if not self.enabled:
            return
        self.events.append(SpanEvent(
            name=name, cat=cat, start_tick=float(tick), dur_ticks=None,
            lane=lane, rid=rid, args=dict(args)))

    # -- fleet clock alignment --------------------------------------------
    def map_tick(self, local_tick: int, global_tick: int) -> None:
        """Record that this collector's ``local_tick`` ran at ``global_tick``."""
        if self._clock_map and self._clock_map[-1][0] == local_tick:
            return
        self._clock_map.append((int(local_tick), int(global_tick)))

    def to_global_tick(self, t: float) -> float:
        """Remap a local tick stamp onto the fleet clock (identity if unmapped)."""
        if not self._clock_map:
            return t
        locals_ = [p[0] for p in self._clock_map]
        i = bisect.bisect_right(locals_, t) - 1
        if i < 0:
            i = 0
        local, global_ = self._clock_map[i]
        return global_ + (t - local)
