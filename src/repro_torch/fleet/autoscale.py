"""Queue-depth autoscaling policy for the fleet router, the port of
``repro.fleet.autoscale``.

The classic deployed shape: track a target backlog per active replica, step
the active count by ONE replica per decision, and rate-limit decisions with
a cooldown (scaling thrash is worse than a few ticks of over- or
under-provisioning).  ``FleetRouter`` applies it to a pool of
``max_replicas`` replicas built up front: "scaling up" activates an idle
replica (placements resume), "scaling down" marks one draining (no new
placements; it keeps stepping until its in-flight work completes).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Scale the active-replica count toward ``ceil(backlog /
    target_queue)``, one step per decision, at most one decision per
    ``cooldown`` ticks."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_queue: float = 4.0  # desired backlog per active replica
    cooldown: int = 4  # ticks between scale decisions

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(f"need 1 <= min_replicas <= max_replicas, got "
                             f"{self.min_replicas}..{self.max_replicas}")
        if self.target_queue <= 0:
            raise ValueError(f"target_queue must be > 0, got {self.target_queue}")
        if self.cooldown < 0:
            raise ValueError(f"cooldown must be >= 0, got {self.cooldown}")

    def desired(self, active: int, backlog: int) -> int:
        """Next active-replica count given the current backlog (requests
        queued and in flight across the fleet): one step toward the clamped
        target, never a jump."""
        want = math.ceil(backlog / self.target_queue) if backlog else 0
        want = max(self.min_replicas, min(self.max_replicas, want))
        if want > active:
            return active + 1
        if want < active:
            return active - 1
        return active
