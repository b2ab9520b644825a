"""recurrentgemma-9b [arXiv:2402.19427] — Griffin hybrid: RG-LRU and local
attention in a 2:1 pattern, MQA (one kv head), window 2048, GeGLU, tied
head.

The reference's config (``repro.configs.recurrentgemma_9b``), field for
field."""

import torch

from repro_torch.configs import register
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    norm="rmsnorm",
    mlp_activation="gelu",
    mlp_gated=True,  # GeGLU
    qkv_bias=False,
    window=2048,
    block_pattern=("rglru", "rglru", "local_attn"),
    tie_embeddings=True,
    dtype=torch.float32,
    source="[arXiv:2402.19427; kaggle:recurrentgemma-9b; unverified]",
)

register(CONFIG)
