"""Chrome trace-event JSON export (viewable at https://ui.perfetto.dev); the
port of ``repro.telemetry.chrome_trace``.

Maps the span model onto the trace-event format: one *process* (pid) per
collector track (engine / ``replica0/interactive`` / fleet), one *thread*
(tid) per lane inside a track (cascade stage name, ``request``, ``sched``),
"X" complete events for spans, "i" instant events for park/resume/migrate/
scale marks, and "M" metadata events naming every track and lane.

Timestamps are scheduler ticks converted to microseconds via the engine's
calibrated ``tick_seconds``.  Exec spans carry a measured wall-second
duration; all exec spans that share a (track, tick) are laid out
sequentially inside that tick, scaled to fit, so the intra-tick stage
breakdown keeps its measured proportions without overlapping the tick grid.
"""

from __future__ import annotations

import json
import math
from collections import defaultdict
from typing import Iterable

from repro_torch.telemetry.spans import SpanCollector

__all__ = ["chrome_trace_events", "write_chrome_trace", "write_trace"]

TRACE_SCHEMA_VERSION = "chrome-trace/v1"


def _lane_events(pid: int, track: str, lanes: list[str]) -> list[dict]:
    meta = [{
        "ph": "M", "name": "process_name", "pid": pid,
        "args": {"name": track},
    }]
    for tid, lane in enumerate(lanes):
        meta.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": lane},
        })
        meta.append({
            "ph": "M", "name": "thread_sort_index", "pid": pid, "tid": tid,
            "args": {"sort_index": tid},
        })
    return meta


def chrome_trace_events(
    collectors: Iterable[SpanCollector],
    tick_seconds: float = 1.0,
) -> list[dict]:
    """Flatten collectors into a chrome://tracing ``traceEvents`` list."""
    if not tick_seconds or tick_seconds <= 0 or not math.isfinite(tick_seconds):
        tick_seconds = 1.0
    tick_us = tick_seconds * 1e6
    events: list[dict] = []
    for pid, col in enumerate(collectors):
        lanes = sorted({e.lane for e in col.events}) or ["sched"]
        tid_of = {lane: i for i, lane in enumerate(lanes)}
        events.extend(_lane_events(pid, col.track, lanes))

        # Lay out measured exec spans proportionally inside their tick.
        exec_groups: dict[tuple[str, int], list] = defaultdict(list)
        for e in col.events:
            if e.cat == "exec" and e.dur_s is not None:
                exec_groups[(e.lane, int(e.start_tick))].append(e)
        offsets: dict[int, tuple[float, float]] = {}  # id(e) -> (off, width)
        for group in exec_groups.values():
            total = sum(e.dur_s for e in group) or 1.0
            cum = 0.0
            for e in group:
                offsets[id(e)] = (cum / total, e.dur_s / total)
                cum += e.dur_s

        for e in col.events:
            start = col.to_global_tick(e.start_tick)
            args = {k: v for k, v in e.args.items()}
            if e.rid is not None:
                args["rid"] = e.rid
            if e.instant:
                events.append({
                    "name": e.name, "cat": e.cat, "ph": "i",
                    "ts": start * tick_us, "pid": pid, "tid": tid_of[e.lane],
                    "s": "p" if e.cat == "sched" else "t",
                    "args": args,
                })
                continue
            ts = start * tick_us
            dur = e.dur_ticks * tick_us
            if id(e) in offsets:
                off, width = offsets[id(e)]
                ts = (math.floor(start) + off) * tick_us
                dur = width * tick_us
                args["wall_s"] = e.dur_s
            events.append({
                "name": e.name, "cat": e.cat, "ph": "X",
                "ts": ts, "dur": max(dur, 0.0),
                "pid": pid, "tid": tid_of[e.lane], "args": args,
            })
    return events


def write_trace(path: str, events: list[dict], **metadata) -> int:
    """Write a raw traceEvents list as a Chrome trace JSON file."""
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"schema": TRACE_SCHEMA_VERSION, **metadata},
    }
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(events)


def write_chrome_trace(
    path: str,
    collectors: Iterable[SpanCollector],
    tick_seconds: float = 1.0,
    **metadata,
) -> int:
    """Export collectors to ``path``; returns the number of trace events."""
    events = chrome_trace_events(list(collectors), tick_seconds)
    return write_trace(path, events, tick_seconds=tick_seconds, **metadata)
