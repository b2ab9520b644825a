"""qwen2-vl-2b [arXiv:2409.12191; hf] — VLM backbone with M-RoPE.

The reference's config (``repro.configs.qwen2_vl_2b``), field for field.
The ViT patch frontend is a stub: the model takes precomputed patch/text
embeddings (B, S, d_model) plus (3, B, S) M-RoPE position streams
(temporal, height, width), or token ids, whose three streams are equal.
head_dim = 128, so the M-RoPE sections (16, 24, 24) sum to D/2 = 64."""

import torch

from repro_torch.configs import register
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    norm="rmsnorm",
    mlp_activation="silu",
    mlp_gated=True,
    qkv_bias=True,
    rope_base=1e6,
    mrope_sections=(16, 24, 24),
    embed_inputs=True,
    tie_embeddings=True,
    dtype=torch.float32,
    source="[arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B]",
)

register(CONFIG)
