"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B] — MoE 128 experts top-8.

The reference's config (``repro.configs.qwen3_moe_30b_a3b``), field for
field."""

import torch

from repro_torch.configs import register
from repro_torch.configs.base import LMConfig, MoESpec

CONFIG = LMConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,  # (= moe expert intermediate size; all layers are MoE)
    vocab=151936,
    norm="rmsnorm",
    mlp_activation="silu",
    mlp_gated=True,
    qkv_bias=False,
    qk_norm=True,
    rope_base=1e6,
    block_pattern=("moe",),
    moe=MoESpec(n_experts=128, top_k=8, d_ff_expert=768, capacity_factor=1.25),
    tie_embeddings=False,
    dtype=torch.float32,
    source="[hf:Qwen/Qwen3-30B-A3B]",
)

register(CONFIG)
