"""Whole-slice parity of the PyTorch/CUDA port: Stable Diffusion text-to-image.

``reduced_workload(get_config("stable-diffusion"))`` with 2 DDIM steps and a
batch of 2 runs in both packages on one seeded parameter tree, handed to JAX
as is and bridged unchanged into the port.  The JAX side runs ``generate`` on the
``interpret`` tier (Pallas kernels in interpret mode); the port runs
``generate`` on its ``kernel`` tier on the CPU (each kernel's plain
version).  The two draw noise from different generators, so the port's one
noise function is handed JAX's draw, computed exactly as
``repro/workload/diffusion.py`` does it.

Tolerance: 1e-4 in fp32 on the decoded image.  Each stage chains tens of
kernel-level ops that agree to 2e-5; sums run in another order, GroupNorm
variance is one-pass on one side where it is two-pass on the other, and two
DDIM steps feed each step's output back through the UNet.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.suite  # noqa: F401  (registers the suite)
from repro.configs import get_config as j_get_config
from repro.models import diffusion as j_diff
from repro.workload import reduced_workload as j_reduced_workload
from repro.workload import workload_for as j_workload_for
from repro.workload.base import stage_keys
from repro_torch.configs import get_config
from repro_torch.configs import suite as t_suite
from repro_torch.models import diffusion as t_diff
from repro_torch.nn import from_jax_params, init_params, param_defs
from repro_torch.workload import diffusion as t_wl_diff
from repro_torch.workload import (reduced_workload, stage_generator, stage_noise,
                                  workload_for)

TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 2


@pytest.fixture(scope="module")
def slice_run():
    """JAX reduced SD: params, tokens, the denoise noise and the interpret-tier
    output, computed once for the module."""
    jwl = j_reduced_workload(j_get_config("stable-diffusion"))
    jwl = j_workload_for(dataclasses.replace(jwl.cfg, denoise_steps=STEPS))
    key = jax.random.PRNGKey(0)
    # seeded values in the port's init families, as a JAX tree (JAX's own
    # eager init of this tree takes ~25 s on the CPU)
    tree = {}
    for k, v in init_params(_port_workload().model, 0).items():
        *path, leaf = k.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.numpy()
    params = jax.tree.map(jnp.asarray, tree)
    tokens = np.random.default_rng(0).integers(
        0, jwl.cfg.text.vocab, (2, jwl.cfg.text.max_len)).astype(np.int32)
    out = np.asarray(jwl.generate(params, jnp.asarray(tokens), key, impl="interpret"))
    hw = jwl.cfg.latent_size
    noise = np.array(jax.vmap(lambda k: jax.random.normal(
        k, (hw, hw, jwl.cfg.unet.in_channels), jwl.cfg.unet.dtype))(
            stage_keys(key, [0, 1], 1)))  # denoise is stage 1
    state = from_jax_params(tree)
    return dict(jwl=jwl, params=params, tokens=tokens, out=out, noise=noise, state=state)


def _port_workload():
    twl = reduced_workload(get_config("stable-diffusion"))
    return workload_for(dataclasses.replace(twl.cfg, denoise_steps=STEPS))


def test_generate_kernel_tier_matches_jax_interpret(slice_run, monkeypatch):
    twl = _port_workload()
    model = twl.load(slice_run["state"], device="cpu")
    noise = torch.from_numpy(slice_run["noise"])
    monkeypatch.setattr(t_wl_diff, "stage_noise", lambda gens, shape, dtype, device: noise)
    out = twl.generate(model, slice_run["tokens"], 0, impl="kernel", device="cpu")
    assert tuple(out.shape) == slice_run["out"].shape == (2, 8, 8, 3)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), slice_run["out"], **TOL)


def test_unet_unfused_tier_matches_jax(slice_run):
    """One UNet2D call on the unfused tiers: JAX blocked_jax vs port torch."""
    jwl = slice_run["jwl"]
    twl = _port_workload()
    model = twl.load(slice_run["state"], device="cpu")
    rng = np.random.default_rng(1)
    hw, cfg = jwl.cfg.latent_size, jwl.cfg.unet
    x = rng.standard_normal((2, hw, hw, cfg.in_channels)).astype(np.float32)
    ctx = rng.standard_normal((2, jwl.cfg.text.max_len, cfg.context_dim)).astype(np.float32)
    t = np.array([999.0, 499.0], np.float32)
    unet = jax.jit(lambda p, x, t, c: jwl.model.unet(p, x, t, c, impl="blocked_jax"))
    gold = unet(slice_run["params"]["unet"], jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.inference_mode():
        out = model.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                         impl="torch")
    np.testing.assert_allclose(out.numpy(), np.asarray(gold), **TOL)


def test_noise_is_per_request_not_per_batch(slice_run):
    """The port's (seed, rid, stage) contract: a request's sample does not
    depend on the batch it rides in."""
    twl = _port_workload()
    model = twl.load(slice_run["state"], device="cpu")
    toks = slice_run["tokens"]
    gens = [stage_generator(7, rid, 1) for rid in (3, 5)]
    noise = stage_noise(gens, (4, 4, 4), torch.float32, "cpu")
    assert torch.equal(noise[1], stage_noise([stage_generator(7, 5, 1)], (4, 4, 4),
                                             torch.float32, "cpu")[0])
    both = twl.generate(model, toks, 7, impl="kernel", device="cpu", rids=[3, 5])
    alone = twl.generate(model, toks[1:], 7, impl="kernel", device="cpu", rids=[5])
    # same noise; CPU matmul blocking depends on the batch size, so ~1 ulp
    torch.testing.assert_close(both[1], alone[0], rtol=1e-5, atol=1e-5)
    other = twl.generate(model, toks[1:], 8, impl="kernel", device="cpu", rids=[5])
    assert not torch.allclose(alone, other)


def test_stage_plan_and_requests_match_jax():
    jwl = j_workload_for(j_get_config("stable-diffusion"))
    twl = workload_for(get_config("stable-diffusion"))
    j_stages = [(s.name, s.steps, s.seq_len) for s in jwl.cost_descriptor().stages]
    t_stages = [(s.name, s.steps, s.seq_len) for s in twl.cost_descriptor().stages]
    assert t_stages == j_stages == [("text_encoder", 1, 77), ("denoise", 50, 4096),
                                    ("vae", 1, 262144)]
    jr, tr = jwl.prepare_request(3, [1, 2, 3]), twl.prepare_request(3, [1, 2, 3])
    assert (tr.rid, tr.modality, tr.route, tr.denoise_steps, tr.slo_tier) == (
        jr.rid, jr.modality, jr.route, jr.denoise_steps, jr.slo_tier)
    with pytest.raises(ValueError):
        twl.generate_requests(None, np.zeros((1, 4), np.int32), 0, device="cpu",
                              stage_impl={"nope": "torch"})


def test_full_size_params_bridge_without_transpose():
    """At the full SD config the port's parameter names and shapes are the
    JAX tree's (abstract on both sides: nothing is allocated)."""
    jwl = j_workload_for(j_get_config("stable-diffusion"))
    abstract = jax.eval_shape(jwl.init, jax.random.PRNGKey(0))
    from repro_torch.nn.module import flatten_tree

    j_shapes = {k: tuple(v.shape) for k, v in flatten_tree(abstract).items()}
    t_defs = param_defs(workload_for(get_config("stable-diffusion")).model)
    assert {k: d.shape for k, d in t_defs.items()} == j_shapes
    assert sum(int(np.prod(s)) for s in j_shapes.values()) > 1_000_000_000


@pytest.mark.parametrize("name,params_m", [("imagen", 4076.9), ("prod-image", 1642.1)])
def test_full_size_cascade_params_bridge_without_transpose(name, params_m):
    """Imagen (with its ``sr0``/``sr1`` UNets) and prod-image: the port's
    parameter names and shapes are the JAX tree's, by ``defs`` shapes only
    (abstract on both sides: 4 B parameters are never allocated)."""
    jwl = j_workload_for(j_get_config(name))
    abstract = jax.eval_shape(jwl.init, jax.random.PRNGKey(0))
    from repro_torch.nn.module import flatten_tree

    j_shapes = {k: tuple(v.shape) for k, v in flatten_tree(abstract).items()}
    t_defs = param_defs(workload_for(get_config(name)).model)
    assert {k: d.shape for k, d in t_defs.items()} == j_shapes
    assert round(sum(int(np.prod(s)) for s in j_shapes.values()) / 1e6, 1) == params_m
    if name == "imagen":
        assert t_defs["sr0.conv_in.kernel"].shape == t_defs["sr1.conv_in.kernel"].shape[:2] + (
            6, 128)
        assert not any(k.startswith("sr1.") and "cross_attn" in k for k in t_defs)


@pytest.mark.parametrize("name", ["imagen", "prod-image"])
def test_cascade_suite_config_fields_match_jax(name):
    """``IMAGEN`` and ``PROD_IMAGE`` field for field (SR stages included),
    registered, and their reduced configs equal the reference's."""
    def plain(v):
        if dataclasses.is_dataclass(v):
            return {f.name: plain(getattr(v, f.name)) for f in dataclasses.fields(v)
                    if f.name != "dtype"}
        return tuple(map(plain, v)) if isinstance(v, tuple) else v

    cfg = {"imagen": t_suite.IMAGEN, "prod-image": t_suite.PROD_IMAGE}[name]
    assert plain(cfg) == plain(j_get_config(name))
    assert get_config(name) is cfg
    assert plain(reduced_workload(cfg).cfg) == plain(j_reduced_workload(j_get_config(name)).cfg)


@pytest.mark.parametrize("name", ["UNetConfig", "TextEncoderConfig", "DecoderConfig",
                                  "DiffusionConfig", "SRStage"])
def test_config_fields_match_jax(name):
    from repro.models import text_encoder as jt, unet as ju, vae as jv
    from repro_torch.models import text_encoder as tt, unet as tu, vae as tv

    where = {"UNetConfig": (ju, tu), "TextEncoderConfig": (jt, tt),
             "DecoderConfig": (jv, tv), "DiffusionConfig": (j_diff, t_diff),
             "SRStage": (j_diff, t_diff)}[name]
    j_fields = [f.name for f in dataclasses.fields(getattr(where[0], name))]
    t_fields = [f.name for f in dataclasses.fields(getattr(where[1], name))]
    assert t_fields == j_fields


def test_stable_diffusion_config_matches_jax():
    def plain(cfg):
        return {f.name: (plain(v) if dataclasses.is_dataclass(v) else v)
                for f in dataclasses.fields(cfg) if f.name != "dtype"
                for v in [getattr(cfg, f.name)]}

    assert plain(t_suite.STABLE_DIFFUSION) == plain(j_get_config("stable-diffusion"))
    assert get_config("stable-diffusion") is t_suite.STABLE_DIFFUSION


def test_entry_points_default_to_the_card():
    twl = _port_workload()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twl.init(0)
