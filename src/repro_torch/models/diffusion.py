"""Diffusion TTI pipeline pieces, the port of ``repro.models.diffusion``:
the DDIM schedule and the latent (Stable-Diffusion-like) pipeline: text
encoder -> UNet denoising loop in latent space -> VAE decoder.  The loop is
a Python loop over DDIM steps."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.text_encoder import TextEncoder, TextEncoderConfig
from repro_torch.models.unet import UNet2D, UNetConfig
from repro_torch.models.vae import ConvDecoder, DecoderConfig
from repro_torch.nn import Module


def ddpm_alphas(n_train_steps: int = 1000, device="cpu") -> torch.Tensor:
    betas = torch.linspace(1e-4, 0.02, n_train_steps, dtype=torch.float32, device=device)
    return torch.cumprod(1.0 - betas, dim=0)


def ddim_timesteps(total_steps: int) -> list[int]:
    """``jnp.linspace(999, 0, n).astype(int32)`` exactly: JAX evaluates
    ``999 * (1 - i/(n-1))`` in float32 and truncates, which can land one
    below what ``torch.linspace`` gives (e.g. n = 4, 10, 25)."""
    if total_steps == 1:
        return [999]
    div = total_steps - 1
    step = torch.arange(div, dtype=torch.float32) / torch.tensor(div, dtype=torch.float32)
    vals = torch.tensor(999.0) * (1 - step) + torch.tensor(0.0) * step
    return [int(v) for v in vals.to(torch.int32)] + [0]


def ddim_step(x, eps, a_t, a_prev):
    """Deterministic DDIM update (eta=0)."""
    x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps


def ddim_range(eps_fn, z, total_steps: int, start: int, stop: int):
    """Run DDIM step indices ``[start, stop)`` of a ``total_steps`` schedule;
    ``eps_fn(z, t)`` predicts noise at integer train timestep ``t``."""
    alphas = ddpm_alphas(device=z.device)
    ts = ddim_timesteps(total_steps)
    one = torch.ones((), dtype=torch.float32, device=z.device)
    for i in range(start, stop):
        a_prev = alphas[ts[i + 1]] if i + 1 < total_steps else one
        z = ddim_step(z, eps_fn(z, ts[i]), alphas[ts[i]], a_prev)
    return z


@dataclasses.dataclass(frozen=True)
class SRStage:
    """Super-resolution stage: upsample cond image, denoise at high res."""

    out_size: int
    unet: UNetConfig
    steps: int = 20


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    name: str
    kind: str  # "latent" | "pixel"
    image_size: int
    latent_down: int  # 8 for SD; 1 for pixel models
    unet: UNetConfig
    text: TextEncoderConfig
    vae: DecoderConfig | None = None
    sr_stages: tuple = ()
    denoise_steps: int = 50
    text_len: int = 77
    family: str = "diffusion"
    source: str = ""

    @property
    def latent_size(self):
        return self.image_size // self.latent_down


class DiffusionPipeline(Module):
    """Parameter tree ``{"text", "unet", "vae"}`` as in the reference.  SR
    stages come with the pixel-cascade slice."""

    def __init__(self, cfg: DiffusionConfig):
        super().__init__()
        if cfg.sr_stages:
            raise NotImplementedError("SR cascade stages are not ported yet")
        self.cfg = cfg
        self.text = TextEncoder(cfg.text)
        self.unet = UNet2D(cfg.unet)
        if cfg.vae is not None:
            self.vae = ConvDecoder(cfg.vae)

    def encode_text(self, tokens, *, impl="auto"):
        return self.text(tokens, impl=impl)

    def denoise_loop(self, unet: UNet2D, z, ctx, steps: int, *, impl="auto"):
        """The ``steps``-long DDIM loop (the reference's sub-range arguments
        come with the TTV slice that resumes a partial schedule)."""

        def unet_eps(z, t):
            tb = torch.full((z.shape[0],), float(t), dtype=torch.float32, device=z.device)
            return unet(z, tb, ctx, impl=impl)

        return ddim_range(unet_eps, z, steps, 0, steps)
