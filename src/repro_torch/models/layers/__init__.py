"""The port's layers (``repro.models.layers``)."""

from repro_torch.models.layers.moe import MoE

__all__ = ["MoE"]
