"""glm4-9b [hf:THUDM/glm-4-9b] — dense, RoPE, GQA kv=2.

The reference's config (``repro.configs.glm4_9b``), field for field."""

import torch

from repro_torch.configs import register
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=151552,
    norm="rmsnorm",
    mlp_activation="silu",
    mlp_gated=True,
    qkv_bias=True,  # add_qkv_bias in the upstream config
    tie_embeddings=False,
    dtype=torch.float32,
    source="[hf:THUDM/glm-4-9b]",
)

register(CONFIG)
