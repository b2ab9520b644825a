"""olmo-1b [arXiv:2402.00838; hf] — dense, non-parametric LN.

The reference's config (``repro.configs.olmo_1b``), field for field."""

import torch

from repro_torch.configs import register
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    norm="nonparametric_ln",
    mlp_activation="silu",
    mlp_gated=True,
    qkv_bias=False,
    tie_embeddings=True,
    dtype=torch.float32,
    source="[arXiv:2402.00838; hf:allenai/OLMo-1B]",
)

register(CONFIG)
