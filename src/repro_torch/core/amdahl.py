"""Amdahl's-law decomposition of the Flash-Attention benefit (paper §IV-B),
the port of ``repro.core.amdahl``.

End-to-end speedup = 1 / ((1 - share) + share / module_speedup), where
``share`` is the fraction of time in attention and ``module_speedup`` the
attention operator's own speedup.  The paper's Table II spans 1.04x
(Prod-Image) to 1.67x (Stable Diffusion).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import perf_model
from repro_torch.core.perf_model import TPU_V5E, Hardware
from repro_torch.core.tracer import OpEvent


@dataclasses.dataclass
class SpeedupReport:
    total_base_s: float
    total_flash_s: float
    attn_base_s: float
    attn_flash_s: float

    @property
    def e2e_speedup(self) -> float:
        return self.total_base_s / self.total_flash_s

    @property
    def attn_module_speedup(self) -> float:
        return self.attn_base_s / max(self.attn_flash_s, 1e-30)

    @property
    def attn_share_base(self) -> float:
        return self.attn_base_s / self.total_base_s

    @property
    def amdahl_predicted(self) -> float:
        s = self.attn_share_base
        k = self.attn_module_speedup
        return 1.0 / ((1.0 - s) + s / k)


def flash_speedup(
    events_base: list[OpEvent],
    events_flash: list[OpEvent],
    hw: Hardware = TPU_V5E,
) -> SpeedupReport:
    return SpeedupReport(
        total_base_s=perf_model.total_time(events_base, hw),
        total_flash_s=perf_model.total_time(events_flash, hw),
        attn_base_s=perf_model.category_time(events_base, "attention", hw),
        attn_flash_s=perf_model.category_time(events_flash, "attention", hw),
    )
