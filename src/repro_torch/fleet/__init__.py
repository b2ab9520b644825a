"""Fleet serving, the port of ``repro.fleet``: SLO-classed routing over N
engine replicas.

The deployment layer above ``repro_torch.serving``: a :class:`FleetRouter`
drives N :class:`FleetReplica` instances (each hosting per-pool
cascade-route ``ServeEngine``s) on one shared tick clock, places SLO-classed
requests by pluggable policies, preempts batch-tier work at cascade stage
boundaries (migrating it between same-seed replicas, where it continues to
the same output), and A/Bs an :class:`AutoscalePolicy` against a fixed
fleet.
"""

from repro_torch.fleet.autoscale import AutoscalePolicy
from repro_torch.fleet.replica import ENGINE_POLICIES, FleetReplica, RequestMeta
from repro_torch.fleet.router import CROSS_TIER_WEIGHT, PLACEMENT_POLICIES, FleetRouter

__all__ = [
    "AutoscalePolicy",
    "CROSS_TIER_WEIGHT",
    "ENGINE_POLICIES",
    "FleetReplica",
    "FleetRouter",
    "PLACEMENT_POLICIES",
    "RequestMeta",
]
