"""Sharding rules and mesh-aware execution, the port of ``repro.parallel``
on torch ``DeviceMesh`` and DTensor."""

from repro_torch.parallel.sharding import (
    DEFAULT_RULES,
    REPLICATION_FALLBACKS,
    SERVE_TP_RULES,
    AbstractMesh,
    batch_axes,
    concat_unsharded,
    logical_to_sharding,
    shard_params_tree,
    shard_report,
    spec_for,
)

__all__ = [
    "AbstractMesh",
    "DEFAULT_RULES",
    "REPLICATION_FALLBACKS",
    "SERVE_TP_RULES",
    "batch_axes",
    "concat_unsharded",
    "logical_to_sharding",
    "shard_params_tree",
    "shard_report",
    "spec_for",
]
