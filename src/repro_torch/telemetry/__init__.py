"""Observability layer for serving and the pipeline, the port of
``repro.telemetry`` (numpy only, no JAX): lifecycle spans on the tick clock
and their Chrome trace export, typed metrics with the streaming
``Histogram``, and the versioned schema of ``engine.stats`` and its
``stats["fleet"]`` block."""

from repro_torch.telemetry.chrome_trace import (
    TRACE_SCHEMA_VERSION,
    chrome_trace_events,
    write_chrome_trace,
    write_trace,
)
from repro_torch.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    json_ready,
    percentiles,
)
from repro_torch.telemetry.schema import (
    PCTL_KEYS,
    SNAPSHOT_SCHEMA_VERSION,
    STATS_SCHEMA_VERSION,
    validate_engine_stats,
    validate_fleet_summary,
    validate_snapshot,
)
from repro_torch.telemetry.spans import SpanCollector, SpanEvent

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "percentiles",
    "json_ready",
    "SpanCollector",
    "SpanEvent",
    "chrome_trace_events",
    "write_chrome_trace",
    "write_trace",
    "TRACE_SCHEMA_VERSION",
    "STATS_SCHEMA_VERSION",
    "SNAPSHOT_SCHEMA_VERSION",
    "PCTL_KEYS",
    "validate_engine_stats",
    "validate_fleet_summary",
    "validate_snapshot",
]
