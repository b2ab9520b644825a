"""Parity of the port's pixel super-resolution cascade (Imagen) with the JAX
package.

Two whole-cascade ``generate`` runs, each on one seeded parameter tree handed
to JAX as is and bridged unchanged into the port:

- ``TINY_TTI_CASCADE`` (text -> 8 px base -> ``sr0`` at 16 px, whose UNet has
  the structure of Imagen's 1024 px SR UNet: a 6-channel ``[z, up]`` input,
  no per-level attention, no cross-attention);
- reduced ``imagen`` (16 px base -> one SR stage at 128 px, an 8x upsample:
  ``reduced()`` reads the full config's image size; SR with
  cross-attention).

The JAX side runs ``generate`` on the ``interpret`` tier (Pallas kernels in
interpret mode); the port runs ``generate`` on its ``kernel`` tier on the
CPU (each kernel's plain version).  The two draw noise from different
generators, so the port is handed JAX's draw of each stage (denoise is
stage 1, ``sr0`` stage 2), computed as ``repro/workload/diffusion.py``
computes it.

Tolerance: 1e-4 in fp32, relative to the output's scale (``|a - b| <= 1e-4
* max(1, max|b|) + 1e-4 * |b|``): the 2-step SR sampler's first DDIM step
(t = 999) divides by sqrt(alpha_bar_999) = 0.0064, so its output reaches
~600-950 and a 1e-6 summation-order difference in the UNet's noise
prediction reaches it as ~1.5e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.suite  # noqa: F401  (registers the suite)
from repro.configs import get_config as j_get_config
from repro.configs import tiny as j_tiny
from repro.core import analytical as j_analytical
from repro.workload import reduced_workload as j_reduced_workload
from repro.workload import workload_for as j_workload_for
from repro.workload.base import stage_keys
from repro_torch.configs import get_config
from repro_torch.configs import tiny as t_tiny
from repro_torch.nn import from_jax_params, init_params
from repro_torch.workload import diffusion as t_wl_diff
from repro_torch.workload import reduced_workload, stage_generator, workload_for

TOL = dict(rtol=1e-4, atol=1e-4)


def _plain(v):
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name)) for f in dataclasses.fields(v)
                if f.name != "dtype"}
    return tuple(map(_plain, v)) if isinstance(v, tuple) else v


def _tree(state: dict) -> dict:
    """The port's flat state dict as a nested numpy tree (JAX's layout)."""
    tree = {}
    for k, v in state.items():
        *path, leaf = k.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.numpy()
    return tree


def _close_to_scale(out, gold, tol=TOL):
    """|out - gold| <= atol * max(1, max|gold|) + rtol * |gold|."""
    gold = np.asarray(gold)
    scale = max(1.0, float(np.abs(gold).max()))
    np.testing.assert_allclose(out, gold, rtol=tol["rtol"], atol=tol["atol"] * scale)


def _cascade_run(jwl, twl):
    """JAX ``generate`` on the interpret tier over the port's seeded
    parameters; the noise JAX drew for each stage, by shape; the state keys
    each stage returned."""
    key = jax.random.PRNGKey(0)
    # seeded values in the port's init families (JAX's own eager init of the
    # reduced trees takes tens of seconds on the CPU)
    tree = _tree(init_params(twl.model, 0))
    params = jax.tree.map(jnp.asarray, tree)
    cfg = jwl.cfg
    tokens = np.random.default_rng(0).integers(
        0, cfg.text.vocab, (2, cfg.text.max_len)).astype(np.int32)
    stage_keys_out = []
    run_stage = jwl.run_stage

    def recording(params, stage, state, key, **kw):
        out = run_stage(params, stage, state, key, **kw)
        stage_keys_out.append((stage.name, sorted(out)))
        return out

    jwl.run_stage = recording
    out = np.asarray(jwl.generate(params, jnp.asarray(tokens), key, impl="interpret"))
    del jwl.run_stage
    noise = {}
    shapes = [(cfg.latent_size, cfg.latent_size, cfg.unet.in_channels)] + [
        (s.out_size, s.out_size, 3) for s in cfg.sr_stages]
    for idx, shape in enumerate(shapes, start=1):  # denoise is stage 1, sr{i} stage 2 + i
        noise[shape] = np.array(jax.vmap(lambda k, shape=shape: jax.random.normal(
            k, shape, jnp.float32))(stage_keys(key, [0, 1], idx)))
    return dict(tokens=tokens, out=out, noise=noise, stage_keys=stage_keys_out,
                state=from_jax_params(tree))


@pytest.fixture(scope="module")
def tiny_run():
    return _cascade_run(j_workload_for(j_tiny.TINY_TTI_CASCADE),
                        workload_for(t_tiny.TINY_TTI_CASCADE))


@pytest.fixture(scope="module")
def imagen_run():
    return _cascade_run(j_reduced_workload(j_get_config("imagen")),
                        reduced_workload(get_config("imagen")))


def _port_generate(twl, run, monkeypatch):
    model = twl.load(run["state"], device="cpu")
    noise = {k: torch.from_numpy(v) for k, v in run["noise"].items()}
    monkeypatch.setattr(t_wl_diff, "stage_noise",
                        lambda gens, shape, dtype, device: noise[tuple(shape)])
    stages = []
    out = twl.generate(model, run["tokens"], 0, impl="kernel", device="cpu",
                       on_stage=lambda name, s, b: stages.append(name))
    return out, stages


def test_tiny_cascade_generate_matches_jax_interpret(tiny_run, monkeypatch):
    twl = workload_for(t_tiny.TINY_TTI_CASCADE)
    assert not twl.cfg.sr_stages[0].unet.cross_attn
    out, stages = _port_generate(twl, tiny_run, monkeypatch)
    assert stages == ["text_encoder", "denoise", "sr0"]
    assert tuple(out.shape) == tiny_run["out"].shape == (2, 16, 16, 3)
    assert torch.isfinite(out).all()
    _close_to_scale(out.numpy(), tiny_run["out"])


def test_reduced_imagen_generate_matches_jax_interpret(imagen_run, monkeypatch):
    twl = reduced_workload(get_config("imagen"))
    sr = twl.cfg.sr_stages
    assert len(sr) == 1 and sr[0].out_size == 128 and sr[0].unet.cross_attn
    out, stages = _port_generate(twl, imagen_run, monkeypatch)
    assert stages == ["text_encoder", "denoise", "sr0"]
    assert tuple(out.shape) == imagen_run["out"].shape == (2, 128, 128, 3)
    assert torch.isfinite(out).all()
    _close_to_scale(out.numpy(), imagen_run["out"])


def test_pixel_stage_states_match_jax(tiny_run):
    """Each stage of the pixel cascade returns the reference's keys: the base
    denoise hands ``{"ctx", "img"}`` on, the last SR stage returns
    ``{"out"}``; ``stage_output`` reads ``out``, then ``img``, then ``z``."""
    twl = workload_for(t_tiny.TINY_TTI_CASCADE)
    model = twl.load(tiny_run["state"], device="cpu")
    tokens = torch.as_tensor(tiny_run["tokens"], dtype=torch.int64)
    state = {"tokens": tokens}
    assert sorted(twl.init_stage_state(tokens[0], "cpu")) == ["tokens"]
    got = []
    with torch.inference_mode():
        for idx, stage in enumerate(twl.cost_descriptor().stages):
            gens = [stage_generator(0, rid, idx) for rid in range(2)]
            state = twl.run_stage(model, stage, state, gens, impl="kernel")
            got.append((stage.name, sorted(state)))
    assert got == tiny_run["stage_keys"] == [
        ("text_encoder", ["ctx"]), ("denoise", ["ctx", "img"]), ("sr0", ["out"])]
    img = torch.ones(2)
    assert twl.stage_output({"img": img, "z": -img}) is img
    assert torch.equal(twl.stage_output({"out": -img, "img": img}), -img)
    with pytest.raises(KeyError):
        twl.stage_output({"ctx": img})


@pytest.mark.parametrize("src,dst", [(8, 16), (16, 128), (64, 256)], ids=["2x", "8x", "4x"])
def test_bilinear_upsample_matches_jax_resize(src, dst):
    img = np.random.default_rng(src).standard_normal((2, src, src, 3)).astype(np.float32)
    gold = jax.image.resize(jnp.asarray(img), (2, dst, dst, 3), "bilinear")
    out = t_wl_diff.upsample_bilinear(torch.from_numpy(img), dst)
    assert tuple(out.shape) == (2, dst, dst, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(gold), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["imagen", "prod-image", "stable-diffusion", "make-a-video",
                                  "tiny-tti-cascade", "imagen-reduced"])
def test_cost_descriptor_matches_jax(name):
    """Names, steps, sequence lengths and the per-tick demand profiles, and
    the scheduler's per-tick demand over the whole descriptor."""
    def pair(name):
        if name == "tiny-tti-cascade":
            return (j_workload_for(j_tiny.TINY_TTI_CASCADE),
                    workload_for(t_tiny.TINY_TTI_CASCADE))
        if name.endswith("-reduced"):
            base = name[:-len("-reduced")]
            return j_reduced_workload(j_get_config(base)), reduced_workload(get_config(base))
        return j_workload_for(j_get_config(name)), workload_for(get_config(name))

    jwl, twl = pair(name)
    jcd, tcd = jwl.cost_descriptor(), twl.cost_descriptor()
    assert (tcd.arch, tcd.route) == (jcd.arch, jcd.route)
    assert [dataclasses.astuple(s) for s in tcd.stages] == [
        dataclasses.astuple(s) for s in jcd.stages]
    assert tcd.step_demands() == jcd.step_demands()
    assert tcd.iterative_steps() == jcd.iterative_steps()


@pytest.mark.parametrize("name,unet", [("imagen", "unet"), ("imagen", "sr0"), ("imagen", "sr1"),
                                       ("prod-image", "unet")])
def test_unet_block_profile_matches_jax(name, unet):
    """The port's copy of the UNet topology walk gives the reference's
    profile, the skipped blocks (``None``) included."""
    cfg = get_config(name)
    hw = cfg.image_size // cfg.latent_down
    ucfg = cfg.unet
    if unet != "unet":
        i = int(unet[2:])
        hw, ucfg = cfg.sr_stages[i].out_size, cfg.sr_stages[i].unet

    def weight(hw, mult, attn):
        return (hw, mult) if attn else None

    args = (hw, ucfg.channel_mult, ucfg.num_res_blocks, ucfg.attn_levels, weight)
    got = t_wl_diff.unet_block_profile(*args)
    assert got == j_analytical.unet_block_profile(*args)
    assert got  # the mid block always attends


def test_imagen_stage_plan():
    stages = workload_for(get_config("imagen")).cost_descriptor().stages
    assert [(s.name, s.steps, s.seq_len) for s in stages] == [
        ("text_encoder", 1, 128), ("denoise", 64, 4096), ("sr0", 20, 65536),
        ("sr1", 20, 1048576)]
    # SR2's 1024 px UNet has no per-level attention, but its mid block attends
    assert len(stages[3].demand) == 4 * 2 + 1 + 4 * 3
    assert stages[3].demand[8] == 128 * 128 * 8 * 2.0


def test_tiny_configs_match_jax():
    t_cfgs, j_cfgs = t_tiny.tiny_cascade_configs(), j_tiny.tiny_cascade_configs()
    assert [_plain(c) for c in t_cfgs] == [_plain(c) for c in j_cfgs]
    for name in ("TINY_TEXT", "TINY_BASE_UNET", "TINY_SR_UNET"):
        assert _plain(getattr(t_tiny, name)) == _plain(getattr(j_tiny, name))


def test_sr_params_bridge_under_the_reference_keys(tiny_run):
    """The SR UNets sit under ``sr0``, ``sr1``, ...: the JAX tree loads
    unchanged (keys, shapes), and the SR ``conv_in`` takes 6 channels."""
    twl = workload_for(t_tiny.TINY_TTI_CASCADE)
    model = twl.load(tiny_run["state"], device="cpu")
    assert model.sr_unets == [model.sr0]
    assert tuple(model.sr0.conv_in.kernel.shape) == (3, 3, 6, 8)
    assert not any(k.startswith("sr0.") and "cross_attn" in k for k in tiny_run["state"])
