"""stablelm-3b [hf:stabilityai/stablelm-2-1_6b family; unverified] —
dense MHA (kv=32), parametric LayerNorm, partial rotary (25%).

The reference's config (``repro.configs.stablelm_3b``), field for field."""

import torch

from repro_torch.configs import register
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50304,
    norm="layernorm",
    mlp_activation="silu",
    mlp_gated=True,
    qkv_bias=False,
    rope_pct=0.25,
    tie_embeddings=False,
    dtype=torch.float32,
    source="[hf:stabilityai/stablelm-3b-4e1t; unverified]",
)

register(CONFIG)
