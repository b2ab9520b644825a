"""Three-term roofline of one step's record, the port of
``repro.core.roofline``:

    compute term    = flops / peak_FLOP/s
    memory term     = bytes accessed / HBM_bw
    collective term = collective wire bytes / link_bw

Every term is one rank's: the record (``core.hlo_analysis.record_step``)
counts the rank's local ops, as XLA's SPMD module is the per-device
program.  MODEL_FLOPS uses 6*N*D (train) / 2*N*D (prefill) / 2*N*B
(decode) with N = active params and D = tokens processed, giving the
useful-compute ratio that flags recompute and redundancy.

The reference rates every report on a TPU v5e (``roofline_fraction``, the
dry-run's correction).  A port report carries its card, ``hw``: the H100's
bf16 peaks by default (``perf_model.H100_SXM``; the dry-run's cells are
bf16), ``H100_SXM_FP32`` for an fp32 step, ``TPU_V5E`` to compare with the
reference.  The collective term divides by one link's bandwidth
(``hw.ici_bw``: NVLink on the H100), as the reference's.  These are
modeled seconds, never measurements.
"""

from __future__ import annotations

import copy
import dataclasses
import json

from repro_torch.core import hlo_analysis
from repro_torch.core.perf_model import H100_SXM, Hardware


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    # raw counts (one rank's program)
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float  # wire bytes, one rank's
    peak_memory_bytes: float
    # derived terms (seconds, per step)
    compute_s: float
    memory_s: float
    collective_s: float
    # useful-compute accounting
    model_flops: float  # global
    useful_ratio: float  # model_flops / (hlo_flops * chips)
    collectives: dict = dataclasses.field(default_factory=dict)
    hw: Hardware = H100_SXM  # the card the terms are modeled on

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower-bound step time: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful compute achieved / peak, at the modeled step time:
        (model_flops / chips / step_time) / the card's peak."""
        if self.step_time_s <= 0:
            return 0.0
        per_chip = self.model_flops / self.n_chips / self.step_time_s
        return per_chip / self.hw.peak_flops

    def set_terms(self, flops: float, bytes_: float, wire_bytes: float) -> None:
        """Replace the counts and the terms and ratio derived from them."""
        self.hlo_flops, self.hlo_bytes, self.collective_bytes = flops, bytes_, wire_bytes
        self.compute_s = flops / self.hw.peak_flops
        self.memory_s = bytes_ / self.hw.hbm_bw
        self.collective_s = wire_bytes / self.hw.ici_bw
        self.useful_ratio = self.model_flops / max(flops * self.n_chips, 1.0)

    def to_dict(self) -> dict:
        """The reference's fields and properties (``hw`` is the caller's to
        name: it is not a reference field)."""
        d = {f.name: copy.deepcopy(getattr(self, f.name))
             for f in dataclasses.fields(self) if f.name != "hw"}
        d["dominant"] = self.dominant
        d["step_time_s"] = self.step_time_s
        d["roofline_fraction"] = self.roofline_fraction
        return d


def analyze(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    n_chips: int,
    record: hlo_analysis.StepRecord,
    model_flops: float,
    hw: Hardware = H100_SXM,
) -> RooflineReport:
    cost = hlo_analysis.cost_summary(record)
    mem = hlo_analysis.memory_summary(record)
    coll = hlo_analysis.collective_stats(record)
    rep = RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        n_chips=n_chips,
        hlo_flops=0.0,
        hlo_bytes=0.0,
        collective_bytes=0.0,
        peak_memory_bytes=float(mem.get("total_bytes", 0.0)),
        compute_s=0.0,
        memory_s=0.0,
        collective_s=0.0,
        model_flops=model_flops,
        useful_ratio=0.0,
        collectives={
            "bytes_by_type": coll.bytes_by_type,
            "count_by_type": coll.count_by_type,
        },
        hw=hw,
    )
    rep.set_terms(float(cost.get("flops", 0.0)), float(cost.get("bytes accessed", 0.0)),
                  coll.wire_bytes)
    return rep


def model_flops_for(cfg, shape, *, enc_tokens: int = 0) -> float:
    """6*N*D train / 2*N*D inference with N = active params, D = tokens."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def save_reports(reports: list[RooflineReport], path: str) -> None:
    with open(path, "w") as f:
        json.dump([r.to_dict() for r in reports], f, indent=1)


def load_reports(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)
