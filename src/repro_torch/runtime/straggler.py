"""Straggler mitigation, the port of ``repro.runtime.straggler`` (host-only
bookkeeping, the reference's code unchanged).

In a synchronous data-parallel step the slowest participant sets the step
time.  The mitigations:

  1. **Detection**: a per-host EWMA of the step time; a host whose EWMA
     exceeds the fleet median by ``threshold`` (after ``min_samples``
     steps) is flagged.
  2. **Exclusion + re-mesh**: flagged hosts are dropped from the device
     assignment and the runner re-meshes elastically (see
     ``fault_tolerance.elastic_resume``) at the next checkpoint boundary,
     trading a smaller data-parallel width for the removal of the tail.
  3. **Data re-balancing**: the deterministic data pipeline re-splits
     batches over the surviving hosts by step index, so no data is lost or
     repeated.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict


@dataclasses.dataclass
class StragglerConfig:
    ewma_alpha: float = 0.2
    threshold: float = 1.5  # x median
    min_samples: int = 10


class StragglerMonitor:
    def __init__(self, n_hosts: int, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.n_hosts = n_hosts
        self.ewma: dict[int, float] = {}
        self.samples: dict[int, int] = defaultdict(int)

    def record(self, host: int, step_time_s: float) -> None:
        a = self.cfg.ewma_alpha
        self.samples[host] += 1
        if host not in self.ewma:
            self.ewma[host] = step_time_s
        else:
            self.ewma[host] = (1 - a) * self.ewma[host] + a * step_time_s

    def median(self) -> float:
        """The upper median of the hosts' EWMAs (0 before any record)."""
        vals = sorted(self.ewma.values())
        if not vals:
            return 0.0
        return vals[len(vals) // 2]

    def stragglers(self) -> list[int]:
        med = self.median()
        if med <= 0:
            return []
        return [h for h, v in self.ewma.items()
                if self.samples[h] >= self.cfg.min_samples and v > self.cfg.threshold * med]

    def healthy_hosts(self) -> list[int]:
        bad = set(self.stragglers())
        return [h for h in range(self.n_hosts) if h not in bad]

    def plan_remesh(self, data_axis: int) -> dict:
        """The largest data-axis size, halving from ``data_axis``, that the
        surviving hosts fill; the re-mesh plan for the runner."""
        healthy = self.healthy_hosts()
        new_axis = data_axis
        while new_axis > len(healthy):
            new_axis //= 2
        return {
            "healthy_hosts": healthy,
            "old_data_axis": data_axis,
            "new_data_axis": max(new_axis, 1),
            "action": "remesh" if new_axis != data_axis else "none",
        }
