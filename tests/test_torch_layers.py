"""Module parity of the PyTorch/CUDA port against the JAX package.

Each JAX module is initialised from a seed, its parameter tree is bridged
into the port's module unchanged (``repro_torch.nn.from_jax_params``), and
both run on the same numpy inputs on the CPU.  The fused tier pairs JAX
``interpret`` (Pallas kernels in interpret mode) with the port's ``kernel``
tier (plain versions on a CPU tensor); the unfused tier pairs JAX
``blocked_jax`` with the port's ``torch`` tier.

Tolerance: 1e-4 in fp32.  A module chains several kernel-level ops, each of
which agrees to the repo's 2e-5; the sums are taken in another order, and
the GroupNorm variance is one-pass on one side where it is two-pass on the
other (``groupnorm_silu.py:73`` vs ``groupnorm_silu/ref.py:26``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import diffusion as j_diff
from repro.models import unet as j_unet
from repro.models.layers.basic import sinusoidal_embedding as j_sinusoidal
from repro.models.text_encoder import TextEncoder as JTextEncoder
from repro.models.vae import ConvDecoder as JConvDecoder
from repro.workload.diffusion import REDUCED_TEXT as J_REDUCED_TEXT
from repro_torch.models import diffusion as t_diff
from repro_torch.models import unet as t_unet
from repro_torch.models.layers.basic import sinusoidal_embedding as t_sinusoidal
from repro_torch.models.text_encoder import TextEncoder, TextEncoderConfig
from repro_torch.models.vae import ConvDecoder, DecoderConfig
from repro_torch.nn import from_jax_params, init_params, materialize, param_defs

TOL = dict(rtol=1e-4, atol=1e-4)
TIERS = [("interpret", "kernel"), ("blocked_jax", "torch")]
TIER_IDS = ["fused", "unfused"]


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _bridge(jmod, tmod, seed=0, jax_init=False):
    """One parameter tree for ``jmod`` and the port module ``tmod``: seeded
    numpy values (the port's init families; JAX's own init with
    ``jax_init``), handed to JAX as a tree and to the port through the
    bridge."""
    if jax_init:
        tree = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(seed)))
    else:
        tree = _unflatten({k: v.numpy() for k, v in init_params(tmod, seed).items()})
    return jax.tree.map(jnp.asarray, tree), materialize(tmod, from_jax_params(tree), "cpu")


def _randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(t_out, j_out, tol=TOL):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), **tol)


@pytest.mark.parametrize("tiers", TIERS, ids=TIER_IDS)
@pytest.mark.parametrize("c_in,c_out", [(32, 64), (32, 32)], ids=["skip", "identity"])
def test_resblock_matches_jax(c_in, c_out, tiers):
    jax_impl, torch_impl = tiers
    jp, tm = _bridge(j_unet.ResBlock(c_in, c_out, temb_dim=16, groups=8),
                     t_unet.ResBlock(c_in, c_out, temb_dim=16, groups=8), jax_init=True)
    x, temb = _randn(2, 9, 7, c_in, seed=1), _randn(2, 16, seed=2)
    gold = j_unet.ResBlock(c_in, c_out, temb_dim=16, groups=8)(
        jp, jnp.asarray(x), jnp.asarray(temb), impl=jax_impl)
    out = tm(torch.from_numpy(x), torch.from_numpy(temb), impl=torch_impl)
    _close(out, gold)


@pytest.mark.parametrize("tiers", TIERS, ids=TIER_IDS)
def test_spatial_transformer_matches_jax(tiers):
    jax_impl, torch_impl = tiers
    kw = dict(cross=True, depth=1, groups=8, fixed_heads=4)
    jmod = j_unet.SpatialTransformer(32, 8, 16, **kw)
    jp, tm = _bridge(jmod, t_unet.SpatialTransformer(32, 8, 16, **kw))
    x, ctx = _randn(2, 5, 6, 32, seed=3), _randn(2, 7, 16, seed=4)
    gold = jmod(jp, jnp.asarray(x), jnp.asarray(ctx), impl=jax_impl)
    _close(tm(torch.from_numpy(x), torch.from_numpy(ctx), impl=torch_impl), gold)


def test_upsample_nearest_matches_jax_image_resize():
    x = _randn(2, 3, 5, 4, seed=5)
    gold = jax.image.resize(jnp.asarray(x), (2, 6, 10, 4), "nearest")
    np.testing.assert_array_equal(t_unet.upsample_nearest2x(torch.from_numpy(x)).numpy(),
                                  np.asarray(gold))


@pytest.mark.parametrize("kind", ["up", "down"])
def test_resample_blocks_match_jax(kind):
    jcls, tcls = ((j_unet.Upsample, t_unet.Upsample) if kind == "up"
                  else (j_unet.Downsample, t_unet.Downsample))
    jp, tm = _bridge(jcls(8), tcls(8))
    x = _randn(2, 5, 7, 8, seed=6)
    gold = jcls(8)(jp, jnp.asarray(x), impl="interpret")
    _close(tm(torch.from_numpy(x), impl="kernel"), gold)


def test_text_encoder_matches_jax():
    tcfg = TextEncoderConfig(**{f.name: getattr(J_REDUCED_TEXT, f.name)
                                for f in dataclasses.fields(TextEncoderConfig)
                                if f.name != "dtype"})
    jmod = JTextEncoder(J_REDUCED_TEXT)
    jp, tm = _bridge(jmod, TextEncoder(tcfg))
    toks = np.random.default_rng(7).integers(0, tcfg.vocab, (2, tcfg.max_len)).astype(np.int32)
    gold = jmod(jp, jnp.asarray(toks), impl="interpret")
    _close(tm(torch.from_numpy(toks).long(), impl="kernel"), gold)


@pytest.mark.parametrize("tiers", TIERS, ids=TIER_IDS)
def test_conv_decoder_matches_jax(tiers):
    jax_impl, torch_impl = tiers
    kw = dict(latent_channels=4, out_channels=3, base_channels=16, channel_mult=(1, 2),
              num_res_blocks=1, groups=8)
    jmod = JConvDecoder(j_diff.DecoderConfig(**kw))
    jp, tm = _bridge(jmod, ConvDecoder(DecoderConfig(**kw)))
    z = _randn(2, 4, 5, 4, seed=8)
    gold = jmod(jp, jnp.asarray(z), impl=jax_impl)
    out = tm(torch.from_numpy(z), impl=torch_impl)
    assert tuple(out.shape) == gold.shape == (2, 8, 10, 3)
    _close(out, gold)


@pytest.mark.parametrize("n", [2, 3, 4, 10, 25, 50])
def test_ddim_timesteps_match_jnp_linspace(n):
    """float32 rounding then truncation: torch.linspace differs at 4, 10, 25."""
    gold = np.asarray(jnp.linspace(999, 0, n).astype(jnp.int32)).tolist()
    assert t_diff.ddim_timesteps(n) == gold


def test_ddim_range_matches_jax():
    z = _randn(2, 3, 3, 4, seed=9)
    gold = j_diff.ddim_range(lambda z, t: 0.1 * z + t / 1000.0, jnp.asarray(z), 5, 1, 4)
    out = t_diff.ddim_range(lambda z, t: 0.1 * z + t / 1000.0, torch.from_numpy(z), 5, 1, 4)
    _close(out, gold, dict(rtol=2e-5, atol=2e-5))
    np.testing.assert_allclose(t_diff.ddpm_alphas().numpy(), np.asarray(j_diff.ddpm_alphas()),
                               rtol=2e-6, atol=0)


def test_sinusoidal_embedding_matches_jax():
    t = np.array([0.0, 1.0, 500.0, 999.0], np.float32)
    for dim in (32, 33):
        np.testing.assert_allclose(t_sinusoidal(torch.from_numpy(t), dim).numpy(),
                                   np.asarray(j_sinusoidal(jnp.asarray(t), dim)),
                                   rtol=2e-5, atol=2e-5)


def test_seeded_init_is_per_leaf_and_deterministic():
    """A leaf's init depends on the seed and its path, not on tree order;
    families match the reference (zeros/ones/normal/fan-in scaled)."""
    mod = t_unet.ResBlock(32, 64, temb_dim=16, groups=8)
    a, b, c = init_params(mod, 0), init_params(mod, 0), init_params(mod, 1)
    assert a.keys() == param_defs(mod).keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.kernel"], c["conv1.kernel"])
    assert not torch.equal(a["conv1.kernel"][..., :32], a["conv2.kernel"][..., :32, :32])
    assert torch.equal(a["gn1.scale"], torch.ones(32)) and torch.equal(a["conv1.bias"],
                                                                       torch.zeros(64))
    std = a["conv2.kernel"].std().item()
    assert abs(std * (3 * 3 * 64) ** 0.5 - 1.0) < 0.05
    materialize(mod, a, "cpu")
    assert torch.equal(mod.conv1.kernel, a["conv1.kernel"])
