"""Operator-event tracer, the port of ``repro.core.tracer``: the paper's
profiling framework as an event stream recorded while a model runs.

Every ported layer calls :func:`record` with its operator category and its
analytically derived FLOPs and HBM bytes (static functions of shapes, so
recording works on the ``meta`` device: characterizing a 21.9 B-parameter
model allocates no memory).  Categories follow the paper's Fig. 6 legend:
attention, linear, conv, norm, pointwise, embed, other.

:func:`scope` names a region of a run.  Under an active trace it prefixes the
names of the events recorded inside it; under an active ``torch.profiler``
it also opens ``torch.profiler.record_function(name)``, so a profile of the
card shows the same stage and layer names.  With neither active it returns a
shared null context and costs one check.

The stream is read by ``core.perf_model`` (modeled time per op -> Fig. 6
breakdowns, Table II speedups), ``core.seq_profile`` (sequence length per
attention call -> Fig. 7/8) and ``core.prefill_decode`` (Table III).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Iterator

import torch

_state = threading.local()
_NULL = contextlib.nullcontext()


@dataclasses.dataclass
class OpEvent:
    op: str  # category: attention | linear | conv | norm | pointwise | embed | other
    name: str  # scoped call-site name, e.g. "denoise/down_0_1_attn/self_attn"
    flops: float  # analytic FLOPs (multiply-accumulate counted as 2)
    bytes_hbm: float  # modeled HBM traffic in bytes (reads + writes)
    seq_len: int | None = None  # paper §V: the op's sequence length, if attention-like
    repeats: int = 1  # e.g. the denoising steps a pipeline scales it by
    meta: dict = dataclasses.field(default_factory=dict)

    def scaled(self, n: int) -> "OpEvent":
        return dataclasses.replace(self, repeats=self.repeats * n)

    @property
    def total_flops(self) -> float:
        return self.flops * self.repeats

    @property
    def total_bytes(self) -> float:
        return self.bytes_hbm * self.repeats


class Trace:
    def __init__(self):
        self.events: list[OpEvent] = []
        self.scopes: list[str] = []

    def scoped_name(self, name: str) -> str:
        return "/".join(self.scopes + [name]) if self.scopes else name

    def to_chrome_trace(self, path: str | None = None, hw=None) -> list[dict]:
        """OpEvent stream -> Chrome trace events on the modeled-time axis:
        events laid out one after another in call order, each lasting its
        ``core.perf_model.op_time`` on ``hw`` (default ``H100_SXM_FP32``),
        one thread lane per top-level scope.  With ``path`` set the events
        are also written as a trace JSON viewable in Perfetto."""
        from repro_torch.core.perf_model import H100_SXM_FP32, op_time

        hw = hw or H100_SXM_FP32
        lanes: dict[str, int] = {}
        events: list[dict] = []
        cursor_us = 0.0
        for e in self.events:
            lane = e.name.split("/", 1)[0] if "/" in e.name else "top"
            tid = lanes.setdefault(lane, len(lanes))
            dur_us = op_time(e, hw) * 1e6
            events.append({
                "name": e.name, "cat": e.op, "ph": "X",
                "ts": cursor_us, "dur": dur_us, "pid": 0, "tid": tid,
                "args": {"flops": e.total_flops, "bytes_hbm": e.total_bytes,
                         "seq_len": e.seq_len, "repeats": e.repeats},
            })
            cursor_us += dur_us
        meta = [{"ph": "M", "name": "process_name", "pid": 0,
                 "args": {"name": f"characterization/{hw.name}"}}]
        meta += [{"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
                  "args": {"name": lane}} for lane, tid in lanes.items()]
        events = meta + events
        if path is not None:
            from repro_torch.telemetry.chrome_trace import write_trace

            write_trace(path, events, hardware=hw.name)
        return events


def _traces() -> list[Trace]:
    if not hasattr(_state, "traces"):
        _state.traces = []
    return _state.traces


@contextlib.contextmanager
def trace() -> Iterator[Trace]:
    """Activate event recording. Nestable; events go to every active trace."""
    t = Trace()
    _traces().append(t)
    try:
        yield t
    finally:
        _traces().pop()


@contextlib.contextmanager
def _scope(name: str, ts: list[Trace], profiling: bool) -> Iterator[None]:
    for t in ts:
        t.scopes.append(name)
    try:
        if profiling:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
    finally:
        for t in ts:
            t.scopes.pop()


def scope(name: str):
    """Context manager naming a region: the events' scope prefix under a
    trace, a ``record_function`` range under a profile, else nothing."""
    ts = _traces()
    profiling = torch.autograd._profiler_enabled()
    if not ts and not profiling:
        return _NULL
    return _scope(name, list(ts), profiling)


def active() -> bool:
    return bool(_traces())


def innermost() -> Trace:
    """The innermost active trace (the loops that scale one traced pass)."""
    return _traces()[-1]


def record(
    op: str,
    name: str,
    *,
    flops: float,
    bytes_hbm: float,
    seq_len: int | None = None,
    **meta: Any,
) -> None:
    """Record one operator event into every active trace (no-op otherwise)."""
    for t in _traces():
        t.events.append(OpEvent(op=op, name=t.scoped_name(name), flops=float(flops),
                                bytes_hbm=float(bytes_hbm), seq_len=seq_len, meta=dict(meta)))


def scale_events(events: list[OpEvent], n: int) -> list[OpEvent]:
    """Multiply repeats (e.g. by the denoising step count) of a list of events."""
    return [e.scaled(n) for e in events]


def scale_since(start: int, n: int) -> None:
    """Scale by ``n`` the events the innermost trace recorded from index
    ``start`` on: a loop traces one pass and stands it for ``n``."""
    tr = innermost()
    for i in range(start, len(tr.events)):
        tr.events[i] = tr.events[i].scaled(n)


def dtype_bytes(dtype) -> int:
    """Bytes per element of a torch dtype."""
    return dtype.itemsize


def numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def nbytes(*shapes_dtypes) -> int:
    """Bytes of ``(shape, dtype)`` pairs (``repro.models.layers.basic.nbytes``)."""
    return sum(numel(shape) * dtype_bytes(dtype) for shape, dtype in shapes_dtypes)
