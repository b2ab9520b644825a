"""qwen2-72b [arXiv:2407.10671; hf] — dense, GQA kv=8, QKV bias.

The reference's config (``repro.configs.qwen2_72b``), field for field."""

import torch

from repro_torch.configs import register
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    norm="rmsnorm",
    mlp_activation="silu",
    mlp_gated=True,
    qkv_bias=True,
    rope_base=1e6,
    tie_embeddings=False,
    dtype=torch.float32,
    source="[arXiv:2407.10671; hf:Qwen/Qwen2-72B]",
)

register(CONFIG)
