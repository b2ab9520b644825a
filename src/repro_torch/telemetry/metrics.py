"""Typed metrics: counters, gauges, and fixed-bucket streaming histograms;
the port of ``repro.telemetry.metrics`` (numpy only).

This is the single home for latency/percentile math on the serving side.
``percentiles`` (the exact, numpy-backed summary used by ``fleet.summary()``
and the ledger-style paths that keep every sample anyway) lives here, and
``Histogram`` provides the streaming counterpart for accumulators that would
otherwise grow one float per tick — bucketed counts with O(buckets) memory
and percentile estimates within one bucket of the exact answer.

Estimator contract (pinned against numpy in ``tests/test_torch_serving.py``): for a linear-scale histogram with bucket width
``resolution``, ``Histogram.percentile(q)`` is within ``resolution`` of
``numpy.percentile(samples, q, method="lower")`` for any sample set inside
``[lo, hi)``.  ``mean`` and ``max`` are tracked exactly.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Iterable

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "percentiles",
    "json_ready",
]


def percentiles(xs) -> dict[str, float]:
    """Exact p50/p95/mean/max summary of a raw sample list (empty -> zeros)."""
    if not len(xs):
        return {"p50": 0.0, "p95": 0.0, "mean": 0.0, "max": 0.0}
    arr = np.asarray(xs, dtype=np.float64)
    return {
        "p50": float(np.percentile(arr, 50)),
        "p95": float(np.percentile(arr, 95)),
        "mean": float(arr.mean()),
        "max": float(arr.max()),
    }


@dataclasses.dataclass
class Counter:
    """Monotonically increasing count (requests admitted, bytes moved, ...)."""

    name: str
    help: str = ""
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (inc {n})")
        self.value += n

    def snapshot(self):
        return self.value


@dataclasses.dataclass
class Gauge:
    """Point-in-time value (queue depth, active replicas, ...)."""

    name: str
    help: str = ""
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bucket streaming histogram with exact count/sum/min/max.

    Two bucket layouts:

    - ``scale="linear"``: buckets of width ``resolution`` covering
      ``[lo, hi)``; right for tick-valued samples (``resolution=1.0`` makes
      percentiles exact to one tick).
    - ``scale="log"``: geometric buckets with ratio ``1 + resolution``
      covering ``[lo, hi)``; right for wall-second samples spanning decades
      (``resolution`` is then the relative error of a percentile estimate).

    Samples outside ``[lo, hi)`` are clamped into the edge buckets; the true
    min/max are tracked exactly and percentile estimates are clamped into
    ``[min, max]``, so out-of-range observations degrade resolution but never
    correctness of the extremes.
    """

    exact = staticmethod(percentiles)

    def __init__(
        self,
        name: str = "",
        help: str = "",
        *,
        lo: float = 0.0,
        hi: float = 4096.0,
        resolution: float = 1.0,
        scale: str = "linear",
    ):
        if scale not in ("linear", "log"):
            raise ValueError(f"unknown histogram scale {scale!r}")
        if scale == "log" and lo <= 0:
            raise ValueError("log-scale histogram needs lo > 0")
        if hi <= lo or resolution <= 0:
            raise ValueError(f"bad histogram range lo={lo} hi={hi} res={resolution}")
        self.name = name
        self.help = help
        self.scale = scale
        self.lo = float(lo)
        self.hi = float(hi)
        self.resolution = float(resolution)
        if scale == "linear":
            n = int(math.ceil((hi - lo) / resolution))
        else:
            n = int(math.ceil(math.log(hi / lo) / math.log1p(resolution)))
        self._edges = [self._bucket_lo(i) for i in range(max(n, 1) + 1)]
        self._counts = [0] * max(n, 1)
        self.count = 0
        self.total = 0.0
        self._min = math.inf
        self._max = -math.inf

    # -- bucket geometry ---------------------------------------------------
    def _bucket_lo(self, i: int) -> float:
        if self.scale == "linear":
            return self.lo + i * self.resolution
        return self.lo * (1.0 + self.resolution) ** i

    def _bucket_index(self, x: float) -> int:
        i = bisect.bisect_right(self._edges, x) - 1
        return min(max(i, 0), len(self._counts) - 1)

    # -- ingest ------------------------------------------------------------
    def observe(self, x: float) -> None:
        x = float(x)
        self._counts[self._bucket_index(x)] += 1
        self.count += 1
        self.total += x
        self._min = min(self._min, x)
        self._max = max(self._max, x)

    def observe_many(self, xs: Iterable[float]) -> None:
        for x in xs:
            self.observe(x)

    def __len__(self) -> int:
        return self.count

    # -- estimates ---------------------------------------------------------
    @property
    def min(self) -> float:
        return 0.0 if self.count == 0 else float(self._min)

    @property
    def max(self) -> float:
        return 0.0 if self.count == 0 else float(self._max)

    @property
    def mean(self) -> float:
        return 0.0 if self.count == 0 else self.total / self.count

    def _order_stat(self, j: float) -> float:
        """Bucket-resolved value of the ``j``-th smallest sample (0-based):
        the ``c`` samples of a bucket sit at fractions 0, 1/c, ... of its
        width — exact for samples landing on bucket lower edges (e.g.
        integer ticks at resolution 1)."""
        cum = 0
        for b, c in enumerate(self._counts):
            if c and cum + c > j:
                blo, bhi = self._edges[b], self._edges[b + 1]
                return blo + ((j - cum) / c) * (bhi - blo)
            cum += c
        return self.max

    def percentile(self, q: float) -> float:
        """Numpy's linear-interpolation rank convention, but between
        *bucket-resolved* order statistics — so sparse samples spanning
        distant buckets interpolate across the gap (as numpy does) instead
        of inside the first sample's bucket."""
        if self.count == 0:
            return 0.0
        if q >= 100.0:
            return self.max  # tracked exactly, beyond bucket resolution
        idx = (q / 100.0) * (self.count - 1)
        k = int(idx)
        frac = idx - k
        est = self._order_stat(k)
        if frac > 0.0:
            est += frac * (self._order_stat(k + 1) - est)
        return float(min(max(est, self._min), self._max))

    def median(self) -> float:
        return self.percentile(50)

    def summary(self) -> dict[str, float]:
        """Same shape as :func:`percentiles` — {p50, p95, mean, max}."""
        return {
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "mean": self.mean,
            "max": self.max,
        }

    def snapshot(self):
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.min,
            **self.summary(),
        }


_METRIC_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Create-or-get registry of named typed metrics with one snapshot view."""

    def __init__(self):
        self._metrics: dict[str, tuple[str, object]] = {}

    def _get(self, kind: str, name: str, factory):
        if name in self._metrics:
            have_kind, metric = self._metrics[name]
            if have_kind != kind:
                raise TypeError(
                    f"metric {name!r} already registered as {have_kind}, "
                    f"requested as {kind}")
            return metric
        metric = factory()
        self._metrics[name] = (kind, metric)
        return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get("counter", name, lambda: Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get("gauge", name, lambda: Gauge(name, help))

    def histogram(self, name: str, help: str = "", **kwargs) -> Histogram:
        return self._get("histogram", name, lambda: Histogram(name, help, **kwargs))

    def snapshot(self) -> dict:
        from repro_torch.telemetry.schema import SNAPSHOT_SCHEMA_VERSION

        out = {
            "schema": SNAPSHOT_SCHEMA_VERSION,
            "counters": {},
            "gauges": {},
            "histograms": {},
        }
        for name, (kind, metric) in sorted(self._metrics.items()):
            out[kind + "s"][name] = metric.snapshot()
        return out


def json_ready(obj):
    """Recursively convert numpy scalars/arrays and tuples for json.dump."""
    if isinstance(obj, dict):
        return {str(k): json_ready(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_ready(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj
