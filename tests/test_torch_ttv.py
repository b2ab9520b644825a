"""Parity of the port's Make-A-Video text-to-video slice with the JAX package.

``reduced_workload(get_config("make-a-video"))`` (2 DDIM steps: one
keyframe step, one temporal step; 4 frames of 16x16x4) runs in both packages
on one seeded parameter tree, handed to JAX as is and bridged unchanged into
the port.  The JAX side runs ``generate`` on the ``interpret`` tier (Pallas
kernels in interpret mode); the port runs ``generate`` on its ``kernel``
tier on the CPU (each kernel's plain version).  The port's noise function is
handed JAX's draw, computed as ``repro/workload/ttv.py`` computes it.

Tolerance: 1e-4 in fp32, as for the Stable Diffusion slice
(``tests/test_torch_slice.py``): each step chains tens of kernel-level ops
that agree to 2e-5, summed in another order.  The generated video is held
to it relative to its scale (``|a - b| <= 1e-4 * max(1, max|b|) + 1e-4 *
|b|``): the 2-step schedule's first DDIM step (t = 999) divides by
sqrt(alpha_bar_999) = 0.0064, so the video is ~300 in scale and a 1e-6
summation-order difference in the UNet's noise prediction reaches it as
~1.5e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.suite  # noqa: F401  (registers the suite)
from repro.configs import get_config as j_get_config
from repro.models import ttv as j_ttv
from repro.models.layers import conv as j_conv
from repro.workload import reduced_workload as j_reduced_workload
from repro.workload import workload_for as j_workload_for
from repro.workload.base import stage_keys
from repro_torch.configs import get_config
from repro_torch.configs import suite as t_suite
from repro_torch.models import ttv as t_ttv
from repro_torch.models.layers import conv as t_conv
from repro_torch.nn import from_jax_params, init_params, materialize, param_defs
from repro_torch.nn.module import flatten_tree
from repro_torch.workload import reduced_workload, stage_generator, stage_noise, workload_for
from repro_torch.workload import ttv as t_wl_ttv

TOL = dict(rtol=1e-4, atol=1e-4)
TIERS = [("interpret", "kernel"), ("blocked_jax", "torch")]
TIER_IDS = ["fused", "unfused"]


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


def _randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def ttv_run():
    """JAX reduced Make-A-Video: params, tokens, the keyframe noise and the
    interpret-tier output, computed once for the module."""
    jwl = j_reduced_workload(j_get_config("make-a-video"))
    key = jax.random.PRNGKey(0)
    # seeded values in the port's init families (JAX's own eager init of
    # this tree takes ~15 s on the CPU)
    tree = _tree(init_params(reduced_workload(get_config("make-a-video")).model, 0))
    params = jax.tree.map(jnp.asarray, tree)
    tokens = np.random.default_rng(0).integers(
        0, jwl.cfg.text.vocab, (2, jwl.cfg.text.max_len)).astype(np.int32)
    out = np.asarray(jwl.generate(params, jnp.asarray(tokens), key, impl="interpret"))
    cfg = jwl.cfg
    noise = np.array(jax.vmap(lambda k: jax.random.normal(
        k, (cfg.frames, cfg.image_size, cfg.image_size, cfg.unet.in_channels), cfg.dtype))(
            stage_keys(key, [0, 1], 1)))  # keyframe_denoise is stage 1
    return dict(jwl=jwl, params=params, tokens=tokens, out=out, noise=noise,
                state=from_jax_params(tree))


def test_generate_kernel_tier_matches_jax_interpret(ttv_run, monkeypatch):
    twl = reduced_workload(get_config("make-a-video"))
    model = twl.load(ttv_run["state"], device="cpu")
    noise = torch.from_numpy(ttv_run["noise"])
    monkeypatch.setattr(t_wl_ttv, "stage_noise", lambda gens, shape, dtype, device: noise)
    stages = []
    out = twl.generate(model, ttv_run["tokens"], 0, impl="kernel", device="cpu",
                       on_stage=lambda name, s, b: stages.append(name))
    assert stages == ["text_encoder", "keyframe_denoise", "temporal_denoise"]
    assert tuple(out.shape) == ttv_run["out"].shape == (2, 4, 16, 16, 4)
    assert torch.isfinite(out).all()
    _close_to_scale(out.numpy(), ttv_run["out"])


def test_video_unet_unfused_tier_matches_jax(ttv_run):
    """One VideoUNet call on the unfused tiers: JAX blocked_jax vs port torch."""
    jwl = ttv_run["jwl"]
    model = reduced_workload(get_config("make-a-video")).load(ttv_run["state"], device="cpu")
    cfg = jwl.cfg
    x = _randn(2, cfg.frames, cfg.image_size, cfg.image_size, cfg.unet.in_channels, seed=1)
    ctx = _randn(2, cfg.text.max_len, cfg.unet.context_dim, seed=2)
    t = np.array([999.0, 499.0], np.float32)
    vunet = jax.jit(lambda p, x, t, c: jwl.model.video_unet(p, x, t, c, impl="blocked_jax"))
    gold = vunet(ttv_run["params"]["vunet"], jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.inference_mode():
        out = model.vunet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                          impl="torch")
    np.testing.assert_allclose(out.numpy(), np.asarray(gold), **TOL)


def _bridge(jmod, tmod, seed=0):
    tree = _tree(init_params(tmod, seed))
    return jax.tree.map(jnp.asarray, tree), materialize(tmod, from_jax_params(tree), "cpu")


@pytest.mark.parametrize("tiers", TIERS, ids=TIER_IDS)
def test_temporal_attention_layer_matches_jax(tiers):
    jax_impl, torch_impl = tiers
    jmod = j_ttv.TemporalAttention(32, 8)
    jp, tm = _bridge(jmod, t_ttv.TemporalAttention(32, 8))
    # non-zero output projection bias and LayerNorm shift, so every leaf counts
    rng = np.random.default_rng(3)
    for leaf in (("out", "bias"), ("ln", "bias"), ("wq", "bias")):
        v = (0.1 * rng.standard_normal(jp[leaf[0]][leaf[1]].shape)).astype(np.float32)
        jp[leaf[0]][leaf[1]] = jnp.asarray(v)
        getattr(tm, leaf[0]).get_parameter(leaf[1]).data = torch.from_numpy(v)
    x = _randn(2, 5, 3, 4, 32, seed=4)
    gold = jmod(jp, jnp.asarray(x), impl=jax_impl)
    out = tm(torch.from_numpy(x), impl=torch_impl)
    assert tm.n_heads == jmod.n_heads == 4
    np.testing.assert_allclose(out.numpy(), np.asarray(gold), **TOL)


@pytest.mark.parametrize("tiers", TIERS, ids=TIER_IDS)
def test_temporal_conv_layer_matches_jax(tiers):
    jax_impl, torch_impl = tiers
    jmod = j_conv.TemporalConv1D(12, 3)
    jp, tm = _bridge(jmod, t_conv.TemporalConv1D(12, 3))
    bias = (0.1 * np.random.default_rng(5).standard_normal(12)).astype(np.float32)
    jp["bias"] = jnp.asarray(bias)
    tm.bias.data = torch.from_numpy(bias)
    x = _randn(2, 5, 3, 4, 12, seed=6)
    gold = jmod(jp, jnp.asarray(x), impl=jax_impl)
    out = tm(torch.from_numpy(x), impl=torch_impl)
    np.testing.assert_allclose(out.numpy(), np.asarray(gold), rtol=2e-5, atol=2e-5)


def test_ttv_config_fields_and_make_a_video_match_jax():
    def plain(cfg):
        return {f.name: (plain(v) if dataclasses.is_dataclass(v) else v)
                for f in dataclasses.fields(cfg) if f.name != "dtype"
                for v in [getattr(cfg, f.name)]}

    assert ([f.name for f in dataclasses.fields(t_ttv.TTVConfig)]
            == [f.name for f in dataclasses.fields(j_ttv.TTVConfig)])
    assert plain(t_suite.MAKE_A_VIDEO) == plain(j_get_config("make-a-video"))
    assert get_config("make-a-video") is t_suite.MAKE_A_VIDEO
    assert plain(reduced_workload(get_config("make-a-video")).cfg) == plain(
        j_reduced_workload(j_get_config("make-a-video")).cfg)


@pytest.mark.parametrize("steps,plan", [
    (50, [("text_encoder", 1, 77), ("keyframe_denoise", 25, 65536),
          ("temporal_denoise", 25, 65536)]),
    (1, [("text_encoder", 1, 77), ("temporal_denoise", 1, 65536)]),
], ids=["full", "one-step"])
def test_stage_plan_matches_jax(steps, plan):
    jwl = j_workload_for(dataclasses.replace(j_get_config("make-a-video"), denoise_steps=steps))
    twl = workload_for(dataclasses.replace(get_config("make-a-video"), denoise_steps=steps))
    j_stages = [(s.name, s.steps, s.seq_len) for s in jwl.cost_descriptor().stages]
    t_stages = [(s.name, s.steps, s.seq_len) for s in twl.cost_descriptor().stages]
    assert t_stages == j_stages == plan
    jr, tr = jwl.prepare_request(3, [1, 2, 3]), twl.prepare_request(3, [1, 2, 3])
    assert (tr.rid, tr.modality, tr.route, tr.denoise_steps, tr.slo_tier) == (
        jr.rid, jr.modality, jr.route, jr.denoise_steps, jr.slo_tier) == (
        3, "video", "pod", -(-steps // 2), "batch")


def test_one_step_schedule_runs_as_one_temporal_stage(ttv_run):
    """denoise_steps=1: no keyframe stage; the temporal stage draws the noise
    (still stage index 1) and runs the one DDIM step with the VideoUNet."""
    twl = reduced_workload(get_config("make-a-video"))
    twl1 = workload_for(dataclasses.replace(twl.cfg, denoise_steps=1))
    model = twl1.load(ttv_run["state"], device="cpu")
    stages = []
    out = twl1.generate(model, ttv_run["tokens"], 0, impl="kernel", device="cpu",
                        on_stage=lambda name, s, b: stages.append(name))
    assert stages == ["text_encoder", "temporal_denoise"]
    assert tuple(out.shape) == (2, 4, 16, 16, 4) and torch.isfinite(out).all()


def test_full_size_params_bridge_without_transpose():
    """At the full Make-A-Video config the port's parameter names and shapes
    are the JAX tree's, temporal keys with '/' included (abstract on both
    sides: nothing is allocated)."""
    jwl = j_workload_for(j_get_config("make-a-video"))
    abstract = jax.eval_shape(jwl.init, jax.random.PRNGKey(0))
    j_shapes = {k: tuple(v.shape) for k, v in flatten_tree(abstract).items()}
    t_defs = param_defs(workload_for(get_config("make-a-video")).model)
    assert {k: d.shape for k, d in t_defs.items()} == j_shapes
    assert "vunet.tattn/down_1_1_attn.wq.kernel" in t_defs
    assert "vunet.tconv/mid_1_attn.kernel" in t_defs
    n_sites = sum(k.startswith("vunet.tconv/") and k.endswith(".kernel") for k in t_defs)
    assert n_sites == 16
    assert round(sum(int(np.prod(s)) for s in j_shapes.values()) / 1e6, 1) == 1311.1


def test_noise_is_per_request_not_per_batch(ttv_run):
    """The port's (seed, rid, stage) contract: a request's video does not
    depend on the batch it rides in."""
    twl = reduced_workload(get_config("make-a-video"))
    model = twl.load(ttv_run["state"], device="cpu")
    toks = ttv_run["tokens"]
    gens = [stage_generator(7, rid, 1) for rid in (3, 5)]
    shape = (4, 16, 16, 4)
    noise = stage_noise(gens, shape, torch.float32, "cpu")
    assert torch.equal(noise[1], stage_noise([stage_generator(7, 5, 1)], shape,
                                             torch.float32, "cpu")[0])
    both = twl.generate(model, toks, 7, impl="kernel", device="cpu", rids=[3, 5])
    alone = twl.generate(model, toks[1:], 7, impl="kernel", device="cpu", rids=[5])
    # same noise; CPU matmul blocking depends on the batch size, so ~1 ulp
    torch.testing.assert_close(both[1], alone[0], rtol=1e-5, atol=1e-5)
    other = twl.generate(model, toks[1:], 8, impl="kernel", device="cpu", rids=[5])
    assert not torch.allclose(alone, other)


def test_repeats_across_frames_are_in_place():
    """jnp.repeat(t, F) repeats each element F times in place: the VideoUNet
    hands frame f of video b the timestep and context of video b."""
    calls = {}

    class Probe(torch.nn.Module):
        def forward(self, x, t, ctx, **kw):
            calls.update(t=t, ctx=ctx, frames=kw["frames"])
            return x

    cfg = reduced_workload(get_config("make-a-video")).cfg
    vunet = t_ttv.VideoUNet(cfg)
    vunet.unet = Probe()
    x = torch.zeros(2, 3, 4, 4, 4)
    t = torch.tensor([10.0, 20.0])
    ctx = torch.stack([torch.full((2, 5), 1.0), torch.full((2, 5), 2.0)])
    assert vunet(x, t, ctx).shape == x.shape
    assert calls["t"].tolist() == [10.0, 10.0, 10.0, 20.0, 20.0, 20.0]
    assert calls["ctx"][:, 0, 0].tolist() == [1.0, 1.0, 1.0, 2.0, 2.0, 2.0]
    assert calls["frames"] == 3
