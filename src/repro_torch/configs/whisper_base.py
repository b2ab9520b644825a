"""whisper-base [arXiv:2212.04356; unverified] — enc-dec audio backbone.

The reference's config (``repro.configs.whisper_base``), field for field.
The conv/log-mel frontend is a stub: the encoder takes precomputed frame
embeddings (B, S_enc, d_model).  The encoder is bidirectional; the decoder
is causal with cross-attention to the encoder's output, and adds sinusoidal
positions to its input (no RoPE)."""

import torch

from repro_torch.configs import register
from repro_torch.configs.base import EncoderSpec, LMConfig

CONFIG = LMConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,  # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    norm="layernorm",
    mlp_activation="gelu",
    mlp_gated=False,
    qkv_bias=True,
    encoder=EncoderSpec(n_layers=6),
    tie_embeddings=True,
    dtype=torch.float32,
    source="[arXiv:2212.04356; hf:openai/whisper-base; unverified]",
)

register(CONFIG)
