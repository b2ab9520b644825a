"""deepseek-moe-16b [arXiv:2401.06066; hf] — fine-grained MoE,
2 shared + 64 routed top-6, first layer dense.

The reference's config (``repro.configs.deepseek_moe_16b``), field for
field."""

import torch

from repro_torch.configs import register
from repro_torch.configs.base import LMConfig, MoESpec

CONFIG = LMConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,  # dense FFN width for the first (non-MoE) layer
    vocab=102400,
    norm="rmsnorm",
    mlp_activation="silu",
    mlp_gated=True,
    qkv_bias=False,
    block_pattern=("moe",),
    moe=MoESpec(
        n_experts=64,
        top_k=6,
        d_ff_expert=1408,
        n_shared=2,
        d_ff_shared=2816,  # 2 shared experts x 1408
        first_k_dense=1,
        capacity_factor=1.25,
    ),
    tie_embeddings=False,
    dtype=torch.float32,
    source="[arXiv:2401.06066; hf:deepseek-ai/deepseek-moe-16b-base]",
)

register(CONFIG)
