"""Parity of the port's prod-image slice (latent TTI: 8 latent channels, a
fixed 8 heads, a 24-layer text stack at full size) with the JAX package.

Reduced ``prod-image`` (2 DDIM steps, batch 2) runs in both packages on one
seeded parameter tree, handed to JAX as is and bridged unchanged into the
port.  The JAX side runs on its unfused ``blocked_jax`` tier (jitted XLA):
the ``interpret`` tier of the other slices costs ~30 s more of CPU for the
same function.  The port runs both its tiers against it: ``kernel`` (the
fused structure, each kernel's plain version on the CPU) and ``torch``.
The port's noise function is handed JAX's draw.

Tolerance: 1e-4 in fp32, as for the Stable Diffusion slice
(``tests/test_torch_slice.py``): each step chains tens of kernel-level ops
that agree to 2e-5, summed in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.suite  # noqa: F401  (registers the suite)
from repro.configs import get_config as j_get_config
from repro.workload import reduced_workload as j_reduced_workload
from repro.workload import workload_for as j_workload_for
from repro.workload.base import stage_keys
from repro_torch.configs import get_config
from repro_torch.nn import from_jax_params, init_params
from repro_torch.workload import diffusion as t_wl_diff
from repro_torch.workload import reduced_workload, workload_for

TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 2


def _port_workload():
    twl = reduced_workload(get_config("prod-image"))
    return workload_for(dataclasses.replace(twl.cfg, denoise_steps=STEPS))


@pytest.fixture(scope="module")
def prod_run():
    """JAX reduced prod-image: params, tokens, the denoise noise, the
    blocked_jax generate and one UNet call, computed once for the module."""
    jwl = j_reduced_workload(j_get_config("prod-image"))
    jwl = j_workload_for(dataclasses.replace(jwl.cfg, denoise_steps=STEPS))
    key = jax.random.PRNGKey(0)
    tree = {}
    for k, v in init_params(_port_workload().model, 0).items():
        *path, leaf = k.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.numpy()
    params = jax.tree.map(jnp.asarray, tree)
    cfg = jwl.cfg
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.text.vocab, (2, cfg.text.max_len)).astype(np.int32)
    out = np.asarray(jwl.generate(params, jnp.asarray(tokens), key, impl="blocked_jax"))
    hw = cfg.latent_size
    noise = np.array(jax.vmap(lambda k: jax.random.normal(
        k, (hw, hw, cfg.unet.in_channels), cfg.unet.dtype))(
            stage_keys(key, [0, 1], 1)))  # denoise is stage 1
    x = rng.standard_normal((2, hw, hw, cfg.unet.in_channels)).astype(np.float32)
    ctx = rng.standard_normal((2, cfg.text.max_len, cfg.unet.context_dim)).astype(np.float32)
    t = np.array([999.0, 499.0], np.float32)
    unet = jax.jit(lambda p, x, t, c: jwl.model.unet(p, x, t, c, impl="blocked_jax"))
    unet_out = np.asarray(unet(params["unet"], jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    return dict(tokens=tokens, out=out, noise=noise, state=from_jax_params(tree),
                unet_in=(x, t, ctx), unet_out=unet_out)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_generate_matches_jax(prod_run, monkeypatch, impl):
    twl = _port_workload()
    assert twl.cfg.unet.in_channels == twl.cfg.vae.latent_channels == 8
    model = twl.load(prod_run["state"], device="cpu")
    noise = torch.from_numpy(prod_run["noise"])
    monkeypatch.setattr(t_wl_diff, "stage_noise", lambda gens, shape, dtype, device: noise)
    out = twl.generate(model, prod_run["tokens"], 0, impl=impl, device="cpu")
    assert tuple(out.shape) == prod_run["out"].shape == (2, 8, 8, 3)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), prod_run["out"], **TOL)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_unet_call_matches_jax(prod_run, impl):
    """One UNet2D call with 8 input channels and 8 fixed heads (head dims 4
    and 8 at the reduced widths, 48 / 96 / 192 at full width)."""
    twl = _port_workload()
    model = twl.load(prod_run["state"], device="cpu")
    x, t, ctx = (torch.from_numpy(a) for a in prod_run["unet_in"])
    with torch.inference_mode():
        out = model.unet(x, t, ctx, impl=impl)
    np.testing.assert_allclose(out.numpy(), prod_run["unet_out"], **TOL)


def test_full_size_head_widths():
    """At full width prod-image's fixed 8 heads are 48, 96 and 192 wide."""
    model = workload_for(get_config("prod-image")).model
    dims = {m.head_dim for m in model.unet.modules() if hasattr(m, "head_dim")}
    assert dims == {48, 96, 192}
