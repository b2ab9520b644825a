"""Request-arrival traces for online serving; the port of
``repro.serving.arrivals`` (numpy only: a seed gives the reference's ticks).

Production serving never sees the whole batch up front: requests arrive
*continuously*, and the follow-up characterization work to the source paper
(Lee et al., arXiv:2410.00215) makes the resulting admission policy a
first-class system knob for deployed multi-modal inference.  This module
generates the arrival side of that experiment — per-request arrival ticks in
the engine's scheduling-tick clock — so ``ServeEngine`` can be driven by an
open-loop poisson process, a bursty front, or a closed loop, all seeded and
reproducible.

One tick is one ``ServeEngine.step()`` call (one pipeline scheduling round),
so ``rate`` is "requests per scheduling round", not wall-clock seconds —
the trace is hardware-independent and deterministic.  To state rates in
requests/second against a real host, use :meth:`ArrivalTrace.from_rps` with
a ``tick_seconds`` calibration (``ServeConfig.tick_seconds``, or the
engine's measured value in ``stats["clock"]``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

PATTERNS = ("poisson", "burst", "closed-loop", "diurnal")

#: Sentinel arrival tick for closed-loop requests: the engine admits the
#: request when an earlier one completes (fixed in-flight concurrency)
#: instead of at a pre-computed tick.
ON_COMPLETION = None


@dataclasses.dataclass(frozen=True)
class ArrivalTrace:
    """Seeded generator of per-request arrival ticks.

    Patterns
    --------
    ``poisson``
        Open-loop: exponential inter-arrival gaps with mean ``1 / rate``
        ticks, cumulated and floored to integer ticks.  The classic
        serving-benchmark arrival process.
    ``burst``
        Fronts of ``burst_size`` simultaneous requests every ``burst_gap``
        ticks — the admission-pressure worst case (a full pod plus
        stragglers landing mid-flight).
    ``closed-loop``
        The first ``concurrency`` requests arrive at tick 0; every later
        request carries :data:`ON_COMPLETION` (``None``) and is released by
        the engine when a previous request completes, holding in-flight
        concurrency constant.
    ``diurnal``
        A non-homogeneous poisson process whose rate swings sinusoidally:
        tick ``t`` draws ``Poisson(rate * (1 + amplitude * sin(2*pi*t /
        period)))`` arrivals.  The load swing every deployed service sees
        over a day, compressed onto the tick clock — what an autoscaling
        policy has to track (``repro.fleet``).

    Examples
    --------
    >>> ArrivalTrace("poisson", rate=0.5, seed=0).ticks(4)   # doctest: +SKIP
    [1, 3, 3, 8]
    >>> ArrivalTrace("burst", burst_size=2, burst_gap=3).ticks(5)
    [0, 0, 3, 3, 6]
    >>> ArrivalTrace("closed-loop", concurrency=2).ticks(4)
    [0, 0, None, None]
    """

    pattern: str = "poisson"
    rate: float = 1.0  # poisson/diurnal: mean arrivals per tick
    burst_size: int = 4  # burst: requests per front
    burst_gap: int = 4  # burst: ticks between fronts
    concurrency: int = 2  # closed-loop: in-flight target
    period: int = 32  # diurnal: ticks per rate cycle
    amplitude: float = 0.8  # diurnal: rate swing fraction in [0, 1]
    seed: int = 0

    def __post_init__(self):
        if self.pattern not in PATTERNS:
            raise ValueError(
                f"unknown arrival pattern {self.pattern!r} "
                f"(expected one of {PATTERNS})")
        if self.pattern in ("poisson", "diurnal") and self.rate <= 0:
            raise ValueError(
                f"{self.pattern} rate must be > 0, got {self.rate}")
        if self.pattern == "burst" and (self.burst_size < 1
                                        or self.burst_gap < 0):
            raise ValueError("burst_size must be >= 1 and burst_gap >= 0")
        if self.pattern == "closed-loop" and self.concurrency < 1:
            raise ValueError(
                f"closed-loop concurrency must be >= 1, got {self.concurrency}")
        if self.pattern == "diurnal":
            if self.period < 1:
                raise ValueError(
                    f"diurnal period must be >= 1 tick, got {self.period}")
            if not 0.0 <= self.amplitude <= 1.0:
                raise ValueError(
                    f"diurnal amplitude must be in [0, 1] (1 = rate swings "
                    f"to zero at the trough), got {self.amplitude}")

    @classmethod
    def from_rps(cls, pattern: str, rps: float, tick_seconds: float,
                 **kw) -> "ArrivalTrace":
        """Build a trace whose rate is stated in **requests per second**,
        converted onto the tick clock via ``tick_seconds`` (configure it or
        read the calibrated value from ``ServeEngine.tick_seconds()`` /
        ``engine.stats["clock"]``).

        ``poisson`` / ``diurnal``: ``rate = rps * tick_seconds`` arrivals
        per tick (the diurnal ``period``/``amplitude`` pass through as
        tick-denominated knobs).  ``burst``: ``burst_gap`` is derived so
        each ``burst_size`` front sustains ``rps`` on average.  Rate-less
        patterns (``closed-loop`` is concurrency-, not rate-bound) raise
        rather than silently drop the requested rate."""
        if tick_seconds <= 0:
            raise ValueError(f"tick_seconds must be > 0, got {tick_seconds}")
        if rps <= 0:
            raise ValueError(f"rps must be > 0, got {rps}")
        if pattern in ("poisson", "diurnal"):
            return cls(pattern, rate=rps * tick_seconds, **kw)
        if pattern == "burst":
            size = kw.pop("burst_size", cls.burst_size)
            gap = max(1, round(size / (rps * tick_seconds)))
            return cls(pattern, burst_size=size, burst_gap=gap, **kw)
        raise ValueError(
            f"pattern {pattern!r} has no arrival rate (closed-loop is "
            f"bound by `concurrency`); construct ArrivalTrace directly")

    def ticks(self, n: int) -> list:
        """Arrival ticks for ``n`` requests, non-decreasing.

        Entries are integer ticks, except for closed-loop tail requests
        which carry :data:`ON_COMPLETION` (``None``) — admit on a
        completion, not at a fixed tick."""
        if n <= 0:
            return []
        if self.pattern == "poisson":
            rng = np.random.default_rng(self.seed)
            gaps = rng.exponential(1.0 / self.rate, size=n)
            return [int(t) for t in np.floor(np.cumsum(gaps))]
        if self.pattern == "burst":
            return [(i // self.burst_size) * self.burst_gap for i in range(n)]
        if self.pattern == "diurnal":
            # non-homogeneous poisson by per-tick sampling: tick t draws
            # Poisson(lam(t)) arrivals with the sinusoid-modulated rate —
            # exact for integer ticks, seeded, and trivially monotonic
            rng = np.random.default_rng(self.seed)
            ticks: list = []
            t = 0
            while len(ticks) < n:
                lam = self.rate * (
                    1.0 + self.amplitude * np.sin(2.0 * np.pi * t / self.period))
                ticks += [t] * int(rng.poisson(max(lam, 0.0)))
                t += 1
            return ticks[:n]
        head = min(self.concurrency, n)
        return [0] * head + [ON_COMPLETION] * (n - head)
