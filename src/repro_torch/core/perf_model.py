"""Per-operator modeled execution time (a roofline term per op), the port of
``repro.core.perf_model``.

An op's modeled time is ``max(flops / (peak * efficiency), bytes / bw)``
with a target card's constants; from the tracer's event stream it gives the
Fig. 6 operator breakdowns and the Table II speedups.  ``TPU_V5E`` and
``A100_80G`` are the reference's constants, kept so that the port's
breakdowns equal the reference's; ``H100_SXM`` (bf16 on the tensor cores)
and ``H100_SXM_FP32`` (fp32 on the CUDA cores: the port's fp32 Dense runs
through cuBLAS with TF32 off) model the card the port runs on.  These are
modeled times, never measurements: the card's measured breakdown is
``core.profiler_analysis``'s.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

from repro_torch.core.tracer import OpEvent


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float  # FLOP/s per chip at the modeled precision
    hbm_bw: float  # bytes/s
    ici_bw: float  # bytes/s per link (inter-chip)
    hbm_bytes: float  # capacity
    vmem_bytes: float = 128 * 2**20


TPU_V5E = Hardware(
    name="tpu-v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    hbm_bytes=16 * 2**30,
)

A100_80G = Hardware(
    name="a100-80g",
    peak_flops=312e12,
    hbm_bw=2039e9,
    ici_bw=300e9,  # NVLink
    hbm_bytes=80 * 2**30,
)

# Published H100 SXM peaks (NVIDIA data sheet): dense bf16 on the tensor
# cores, fp32 on the CUDA cores, HBM3 bandwidth, NVLink 4 per direction.
H100_SXM = Hardware(
    name="h100-sxm-bf16",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    hbm_bytes=80 * 2**30,
)

H100_SXM_FP32 = dataclasses.replace(H100_SXM, name="h100-sxm-fp32", peak_flops=67e12)
H100_SXM_TF32_FLOPS = 495e12  # dense TF32 on the tensor cores (a kernel's bound)

# Matmul-class ops reach near peak; pointwise and norm ops see a fraction of
# it but are modeled memory-bound anyway.
_COMPUTE_EFFICIENCY = {
    "attention": 0.75,
    "linear": 0.85,
    "conv": 0.7,
    "norm": 0.1,
    "pointwise": 0.1,
    "embed": 0.1,
    "dispatch": 0.3,
    "scan": 0.4,
    "other": 0.5,
}


def op_time(e: OpEvent, hw: Hardware) -> float:
    eff = _COMPUTE_EFFICIENCY.get(e.op, 0.5)
    compute_t = e.total_flops / (hw.peak_flops * eff)
    # bw_efficiency: strided access (the permutes of the unfused temporal
    # layers) reaches a fraction of the peak bandwidth
    bw_eff = float(e.meta.get("bw_efficiency", 1.0))
    memory_t = e.total_bytes / (hw.hbm_bw * bw_eff)
    return max(compute_t, memory_t)


def op_terms(e: OpEvent, hw: Hardware) -> tuple[float, float]:
    eff = _COMPUTE_EFFICIENCY.get(e.op, 0.5)
    return e.total_flops / (hw.peak_flops * eff), e.total_bytes / hw.hbm_bw


def breakdown(events: list[OpEvent], hw: Hardware = TPU_V5E) -> dict[str, float]:
    """Seconds per operator category (the paper's Fig. 6 y-axis)."""
    out: dict[str, float] = defaultdict(float)
    for e in events:
        out[e.op] += op_time(e, hw)
    return dict(out)


def breakdown_fraction(events: list[OpEvent], hw: Hardware = TPU_V5E) -> dict[str, float]:
    b = breakdown(events, hw)
    total = sum(b.values()) or 1.0
    return {k: v / total for k, v in b.items()}


def total_time(events: list[OpEvent], hw: Hardware = TPU_V5E) -> float:
    return sum(op_time(e, hw) for e in events)


def total_flops(events: list[OpEvent]) -> float:
    return sum(e.total_flops for e in events)


def total_bytes(events: list[OpEvent]) -> float:
    return sum(e.total_bytes for e in events)


_CONV_STACK_SCOPES = ("_res/", "_down/", "_up/", "decoder/", "conv_in",
                      "conv_out", "gn_out")


def is_conv_stack(e: OpEvent) -> bool:
    """Events of the diffusion conv stack (paper C1): conv ops plus the
    norm/pointwise glue inside ResBlocks, up/down-sampling and decoder heads,
    but not the attention blocks' norms."""
    if e.op == "conv":
        return True
    if e.op not in ("norm", "pointwise"):
        return False
    return any(s in e.name for s in _CONV_STACK_SCOPES)


def conv_stack_time(events: list[OpEvent], hw: Hardware = TPU_V5E) -> float:
    """Modeled seconds in the conv stack (what the fused conv2d kernel moves)."""
    return sum(op_time(e, hw) for e in events if is_conv_stack(e))


def category_time(events: list[OpEvent], category: str, hw: Hardware = TPU_V5E,
                  **meta_filter) -> float:
    t = 0.0
    for e in events:
        if e.op != category:
            continue
        if any(e.meta.get(k) != v for k, v in meta_filter.items()):
            continue
        t += op_time(e, hw)
    return t


def arithmetic_intensity(events: list[OpEvent], param_bytes: float) -> float:
    """The paper's Fig. 5 definition: FLOPs / required model capacity."""
    return total_flops(events) / max(param_bytes, 1.0)
