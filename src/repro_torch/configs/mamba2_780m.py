"""mamba2-780m [arXiv:2405.21060] — attention-free SSD: 48 layers of pure
Mamba-2 mixer blocks (no MLP), d_state 128, tied head.

The reference's config (``repro.configs.mamba2_780m``), field for field."""

import torch

from repro_torch.configs import register
from repro_torch.configs.base import LMConfig, SSMSpec

CONFIG = LMConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,  # no MLP block
    vocab=50280,
    norm="rmsnorm",
    block_pattern=("mamba2",),
    ssm=SSMSpec(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    tie_embeddings=True,
    dtype=torch.float32,
    source="[arXiv:2405.21060; hf:state-spaces/mamba2-780m; unverified]",
)

register(CONFIG)
