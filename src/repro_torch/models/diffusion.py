"""Diffusion TTI pipeline pieces, the port of ``repro.models.diffusion``:
the DDIM schedule and the two pipeline variants,

  * latent (Stable-Diffusion-like): text encoder -> UNet denoising loop in
    latent space -> VAE decoder;
  * pixel (Imagen-like): text encoder -> base UNet loop at 64x64 -> a
    cascade of super-resolution UNets, each denoising at its output size
    with the upsampled image of the stage before as a channel condition.

The loop is a Python loop over DDIM steps.  Under an active trace it runs
one step and scales that step's events by the step count (every step runs
the same graph), as the reference's ``ddim_range`` does.

``DiffusionPipeline.train_loss`` is the reference's denoising loss on the
base UNet.  It draws ``t`` and ``eps`` from a ``torch.Generator`` on the
CPU (``train_noise``: the same draws on every device) where the reference
splits a ``PRNGKey``; ``denoise_loss`` takes them as given, so a test can
hand in the reference's own draws.  ``train_noise`` and ``q_sample`` (the
noised input) serve Make-A-Video's video loss too."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import tracer
from repro_torch.models.text_encoder import TextEncoder, TextEncoderConfig
from repro_torch.models.unet import UNet2D, UNetConfig
from repro_torch.models.vae import ConvDecoder, DecoderConfig
from repro_torch.nn import Module
from repro_torch.parallel.sharding import concat_unsharded


def ddpm_alphas(n_train_steps: int = 1000, device="cpu") -> torch.Tensor:
    betas = torch.linspace(1e-4, 0.02, n_train_steps, dtype=torch.float32, device=device)
    return torch.cumprod(1.0 - betas, dim=0)


def q_sample(z0: torch.Tensor, t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """The DDPM noised input ``sqrt(a_t) z0 + sqrt(1 - a_t) eps``, ``a_t``
    (``t`` (B,) into ``ddpm_alphas``) broadcast over ``z0``'s other axes."""
    a_t = ddpm_alphas(device=z0.device)[t].reshape(-1, *[1] * (z0.dim() - 1))
    return torch.sqrt(a_t) * z0 + torch.sqrt(1.0 - a_t) * eps


def train_noise(shape: tuple, gen: torch.Generator) -> tuple:
    """``(t, eps)`` for a batch of ``shape`` (B, ...): timesteps uniform in
    [0, 1000) and standard normal noise, in fp32, drawn on the CPU from
    ``gen``."""
    t = torch.randint(0, 1000, (shape[0],), generator=gen)
    return t, torch.randn(shape, generator=gen, dtype=torch.float32)


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
    """Deterministic DDIM update (eta=0), in the dtype ``jnp`` promotes the
    latent and the fp32 schedule to: a bf16 latent leaves the step in fp32,
    as the reference's (and its tracer events after the loop count fp32)."""
    dt = torch.promote_types(torch.promote_types(x.dtype, eps.dtype), a_t.dtype)
    x, eps = x.to(dt), eps.to(dt)
    x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps


def ddim_range(eps_fn, z, total_steps: int, start: int, stop: int):
    """Run DDIM step indices ``[start, stop)`` of a ``total_steps`` schedule;
    ``eps_fn(z, t)`` predicts noise at integer train timestep ``t``.  Under
    an active trace: step ``start`` once, its events scaled by
    ``stop - start``."""
    alphas = ddpm_alphas(device=z.device)
    ts = ddim_timesteps(total_steps)
    one = torch.ones((), dtype=torch.float32, device=z.device)
    if tracer.active():
        t0 = len(tracer.innermost().events)
        eps = eps_fn(z, ts[start])
        tracer.scale_since(t0, stop - start)
        return ddim_step(z, eps, alphas[ts[start]], one)
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
    """Parameter tree ``{"text", "unet", "vae", "sr0", "sr1", ...}`` as in
    the reference: the VAE for latent models, one SR UNet per ``SRStage``."""

    def __init__(self, cfg: DiffusionConfig):
        super().__init__()
        self.cfg = cfg
        self.text = TextEncoder(cfg.text)
        self.unet = UNet2D(cfg.unet)
        if cfg.vae is not None:
            self.vae = ConvDecoder(cfg.vae)
        for i, s in enumerate(cfg.sr_stages):
            self.add_module(f"sr{i}", UNet2D(s.unet))

    @property
    def sr_unets(self) -> list:
        return [getattr(self, f"sr{i}") for i in range(len(self.cfg.sr_stages))]

    train_noise = staticmethod(train_noise)

    def train_loss(self, batch: dict, gen: torch.Generator, *, impl="auto") -> torch.Tensor:
        """Denoising loss on the base UNet of ``batch``: ``{"latents": (B,
        h, w, C), "text": (B, L)}`` (latents from the frozen VAE encoder in the
        data pipeline, or 64x64 pixels for a pixel model), noise from
        ``gen``."""
        t, eps = self.train_noise(tuple(batch["latents"].shape), gen)
        return self.denoise_loss(batch, t, eps, impl=impl)

    def denoise_loss(self, batch: dict, t, eps, *, impl="auto") -> torch.Tensor:
        """The reference's formula for given ``t`` (B,) and ``eps``:
        ``x_t = sqrt(a_t) z0 + sqrt(1 - a_t) eps``, the text encoder, the
        UNet in the config's dtype, then the fp32 mean squared error of its
        noise prediction."""
        z0 = torch.as_tensor(batch["latents"]).float()
        dev = z0.device
        t, eps = torch.as_tensor(t).to(dev).long(), torch.as_tensor(eps).to(dev).float()
        x_t = q_sample(z0, t, eps)
        ctx = self.text(torch.as_tensor(batch["text"], device=dev), impl=impl)
        pred = self.unet(x_t.to(self.cfg.unet.dtype), t.float(), ctx, impl=impl)
        return torch.mean((pred.float() - eps) ** 2)

    def encode_text(self, tokens, *, impl="auto"):
        return self.text(tokens, impl=impl)

    def denoise_loop(self, unet: UNet2D, z, ctx, steps: int, *, cond=None, impl="auto"):
        """The ``steps``-long DDIM loop.  ``cond`` (SR stages: the upsampled
        low-res image) is concatenated after ``z`` on the channels at every
        step but not denoised.  A partial schedule (the TTV sampler's
        keyframe and temporal stages) runs through ``ddim_range`` directly,
        which resumes at any step index."""

        def unet_eps(z, t):
            inp = z if cond is None else concat_unsharded([z, cond], axis=-1)
            tb = torch.full((z.shape[0],), float(t), dtype=torch.float32, device=z.device)
            return unet(inp, tb, ctx, impl=impl)

        return ddim_range(unet_eps, z, steps, 0, steps)
