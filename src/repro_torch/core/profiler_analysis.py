"""The card's side of the characterization: a ``torch.profiler`` record of
a pass read by kernel, by tracer category and by scope.

The port's counterpart of ``repro.core.hlo_analysis``: the reference reads
the compiled XLA artifact of a TPU program; on the card the artifact is the
profiler's record of what ran.  Device events are the kernels, copies and
sets the card ran (the ranges ``record_function`` mirrors onto the device
timeline are not work and are left out).  Each kernel takes a tracer
category through one table from its name (``kernel_category``): the port's
hand kernels by their ``__global__`` names, cuBLAS GEMMs ``linear``,
reductions (the norms' statistics) ``norm``, elementwise kernels
``pointwise``, gathers ``embed``, and everything else ``other`` (copies,
sets, ``torch.cat``), whose share is reported, never hidden.  Scopes are the ``tracer.scope`` names
(stages, blocks, layers), which open ``record_function`` ranges while a
profile runs.  Two categories follow the scope instead of the name: what
an MoE layer launches under its routing, scatter and gather scope
(``{name}_dispatch``, ``models.layers.moe``) is ``dispatch``, and what a
Mamba-2 mixer or an RG-LRU block launches under its recurrence's scope
(``{name}_scan``, ``models.layers.ssm`` and ``rglru``: the SSD's chunk
products and cross-chunk loop, the RG-LRU's gates and doubling scan) is
``scan``, whatever the kernels are (GEMMs, exponentials, a cumsum), as the
reference's tracer counts MoE dispatch and the SSM / RG-LRU scans.
"""

from __future__ import annotations

import collections

import torch

# (category, substrings of the kernel name), first match wins: the hand
# kernels first (csrc/conv2d.cu: conv2d_kernel and its split-K epilogue,
# GroupNorm producer and statistics kernels; csrc/flash_attention.cu:
# fa_kernel; csrc/temporal_attention.cu; csrc/groupnorm_silu.cu: gn_kernel),
# then the library's families: cuDNN convs, softmax, cuBLAS / cuBLASLt /
# CUTLASS GEMMs and GEMVs (their split-K reductions too), ATen reductions
# (the norms' statistics), gathers, elementwise kernels (dtype casts and
# copies among them).
CATEGORY_PATTERNS = (
    ("conv", ("conv2d_kernel", "splitk_epilogue_kernel", "producer_kernel",
              "stats_reduce_kernel")),
    ("attention", ("fa_kernel", "temporal_attention_kernel")),
    ("norm", ("gn_kernel",)),
    ("other", ("CatArrayBatchedCopy",)),  # torch.cat: the reference records none
    ("conv", ("fprop", "dgrad", "conv", "winograd", "implicit_gemm", "fft")),
    ("attention", ("softmax", "SoftMax", "fmha", "flash", "attention")),
    ("linear", ("gemm", "gemv", "cublas", "cutlass", "splitKreduce", "dot_kernel",
                "xmma", "nvjet", "scal_kernel")),
    ("norm", ("layer_norm", "group_norm", "groupnorm", "rms_norm", "batch_norm",
              "reduce_kernel", "RowwiseMoments", "ComputeFusedParams")),
    ("embed", ("index_select", "indexSelect", "index_elementwise", "gather", "embedding")),
    ("pointwise", ("elementwise", "vectorized", "unrolled", "pointwise")),
)
CATEGORIES = ("attention", "linear", "conv", "norm", "pointwise", "embed", "dispatch", "scan",
              "other")
# the ends of the scope names whose work takes the scope's category: an MoE
# layer's dispatch, a Mamba-2 mixer's or RG-LRU block's recurrence
SCOPE_CATEGORIES = {"_dispatch": "dispatch", "_scan": "scan"}
TEMPORAL_ATTENTION = "temporal_attention_kernel"
_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_category(name: str) -> str:
    """The tracer category of a device event by its name."""
    for cat, subs in CATEGORY_PATTERNS:
        if any(s in name for s in subs):
            return cat
    return "other"


def _scope_category(scope: str) -> str | None:
    """The category of the work launched in a scope of this name, if the
    scope decides it (:data:`SCOPE_CATEGORIES`)."""
    return next((c for end, c in SCOPE_CATEGORIES.items() if scope.endswith(end)), None)


def is_temporal_attention(name: str) -> bool:
    return TEMPORAL_ATTENTION in name


def _is_work_kind(kind) -> bool:
    kind = str(kind or "")
    return not kind or any(k in kind for k in _WORK)


def _is_work(e) -> bool:
    if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
        return False
    return _is_work_kind(getattr(e, "activity_type", ""))


def _work_spans(prof) -> list:
    """(name, start ns, end ns) of each device event that is work, read from
    the profiler's kineto results.  ``prof.events()`` builds a
    ``FunctionEvent`` for every event, kernels and their runtime calls,
    at ~60-85 us of host time each: seconds for a train step's 50k
    launches, which :func:`busy` and :func:`op_histogram` do not need.  As
    in :func:`_is_work`, a build whose events carry no activity type (torch
    2.11) counts every device event that is not a range."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = getattr(e, "activity_type", None)
        if (e.device_type() == cuda and not e.is_user_annotation()
                and _is_work_kind(kind() if kind is not None else "")):
            out.append((e.name(), e.start_ns(), e.end_ns()))
    return out


def device_events(prof) -> list:
    """The work the card ran in a profile: kernels, copies and sets."""
    return [e for e in prof.events() if _is_work(e)]


def _launch_scopes(prof, keep=lambda name: True) -> list:
    """Each device event of a profile with the names of the ranges (those
    ``keep`` accepts) open on the host when it was launched: its runtime
    call, matched by correlation id, outermost first.  Launch time, not the
    op that launched, places it: the hand kernels are launched from Python
    through ``ctypes``, under no ATen op."""
    events = list(prof.events())
    cpu = torch.autograd.DeviceType.CPU
    ranges = sorted((fe.time_range.start, fe.time_range.end, fe.name) for fe in events
                    if fe.device_type == cpu and fe.is_user_annotation and keep(fe.name))
    launch = {fe.id: fe.time_range.start for fe in events
              if fe.device_type == cpu and not fe.is_user_annotation
              and fe.name.startswith("cu")}
    out = []
    for e in events:
        if not _is_work(e):
            continue
        t = launch.get(e.id)
        out.append((e, [] if t is None or not ranges
                    else [n for s, end, n in ranges if s <= t <= end]))
    return out


def _us(e) -> float:
    return e.time_range.end - e.time_range.start


def op_histogram(prof, passes: int = 1) -> dict:
    """Device ms and launches per pass by kernel name, most time first."""
    ms, n = collections.Counter(), collections.Counter()
    for name, s, t in _work_spans(prof):
        ms[name] += (t - s) / 1e6 / passes
        n[name] += 1
    return {k: {"ms": v, "launches": n[k] / passes} for k, v in ms.most_common()}


def busy(prof, window_ms: float, passes: int = 1) -> dict:
    """The card's busy ms per pass (the union of its work's intervals) and
    its idle share over a pass of ``window_ms`` host wall time."""
    spans = sorted((s, t) for _, s, t in _work_spans(prof))
    total, end = 0, float("-inf")
    for s, t in spans:
        if t > end:
            total += t - max(s, end)
            end = t
    busy_ms = total / 1e6 / passes
    return {"busy_ms": busy_ms, "window_ms": window_ms,
            "idle_share": 1.0 - busy_ms / window_ms if window_ms > 0 else float("nan"),
            "launches": len(spans) / passes}


def by_category(prof, passes: int = 1) -> dict:
    """Device ms per pass by tracer category (every category present, 0 if
    none ran), plus ``attention_temporal``: the temporal kernel's part of
    ``attention``.  Work launched inside an MoE dispatch scope is
    ``dispatch``, inside an SSM or RG-LRU scan scope ``scan`` (the innermost
    such scope decides); the rest takes its category from its name."""
    out = dict.fromkeys(CATEGORIES, 0.0)
    out["attention_temporal"] = 0.0
    for e, scopes in _launch_scopes(prof, keep=_scope_category):
        ms = _us(e) / 1e3 / passes
        out[_scope_category(scopes[-1]) if scopes else kernel_category(e.name)] += ms
        if is_temporal_attention(e.name):
            out["attention_temporal"] += ms
    return out


def shares(categories: dict) -> dict:
    """Each category's share of the device time in ``by_category``'s
    output (the temporal part as a share of attention)."""
    total = sum(categories[c] for c in CATEGORIES) or 1.0
    out = {c: categories[c] / total for c in CATEGORIES}
    att = categories["attention"]
    out["temporal_of_attention"] = categories["attention_temporal"] / att if att else 0.0
    return out


def by_scope(prof, passes: int = 1, depth: int | None = None) -> dict:
    """Device ms per pass by ``record_function`` scope path: the ranges open
    on the host when each kernel, copy or set was launched
    (:func:`_launch_scopes`), outermost first, cut to the first ``depth``
    names; ``""`` outside every range."""
    out = collections.Counter()
    for e, names in _launch_scopes(prof):
        out["/".join(names[:depth])] += _us(e) / 1e3 / passes
    return dict(out.most_common())


def memory_summary(device=None) -> dict:
    """The card's allocator readings in bytes (``repro.core.hlo_analysis``
    reads the compiled program's memory analysis)."""
    return {"allocated": torch.cuda.memory_allocated(device),
            "reserved": torch.cuda.memory_reserved(device),
            "peak_allocated": torch.cuda.max_memory_allocated(device),
            "total": torch.cuda.get_device_properties(device).total_memory}
