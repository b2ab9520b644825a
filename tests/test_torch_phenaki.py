"""Parity of the port's Phenaki slice (masked-transformer text-to-video over
frames x tokens, factorized spatial / temporal attention, parallel
decoding) with the JAX package.

``reduced_workload(get_config("phenaki"))`` (2 layers of d 64, 3 frames of
16 tokens, 3 unmasking steps) runs in both packages on one seeded parameter
tree, handed to JAX as is and bridged unchanged into the port.  The JAX side
runs ``generate`` on the ``interpret`` tier; the port runs ``generate`` on
both its tiers on the CPU, and the decoded tokens must be equal.  The
MaskGIT rule itself is held to both of the reference's copies in
``tests/test_torch_muse.py``.

Tolerances are the reference's: 1e-4 for a whole chain (the backbone's
logits), relative to the output's scale.
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
from repro.workload import reduced_workload as j_reduced_workload
from repro.workload import workload_for as j_workload_for
from repro_torch.configs import get_config
from repro_torch.configs import suite as t_suite
from repro_torch.models import ttv as t_ttv
from repro_torch.nn import from_jax_params, init_params, param_defs
from repro_torch.nn.module import flatten_tree
from repro_torch.workload import reduced_workload, workload_for

CHAIN = dict(rtol=1e-4, atol=1e-4)
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


def _plain(v):
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name)) for f in dataclasses.fields(v)
                if f.name != "dtype"}
    return tuple(map(_plain, v)) if isinstance(v, tuple) else v


@pytest.fixture(scope="module")
def phenaki_run():
    """JAX reduced Phenaki: params, tokens and its interpret-tier generate,
    computed once for the module."""
    jwl = j_reduced_workload(j_get_config("phenaki"))
    tree = _tree(init_params(reduced_workload(get_config("phenaki")).model, 0))
    # non-zero biases and LayerNorm shifts in every layer, so each leaf counts
    rng = np.random.default_rng(3)
    for i in range(jwl.cfg.n_layers):
        layer = tree[f"layer{i}"]
        for path in ("ff_in/bias", "ff_out/bias", "ln_c/bias", "temporal/out/bias"):
            *nodes, name = path.split("/")
            node = layer
            for n in nodes:
                node = node[n]
            node[name] = (0.1 * rng.standard_normal(node[name].shape)).astype(np.float32)
    params = jax.tree.map(jnp.asarray, tree)
    tokens = np.random.default_rng(0).integers(
        0, jwl.cfg.text.vocab, (2, jwl.cfg.text.max_len)).astype(np.int32)
    out = np.asarray(jwl.generate(params, jnp.asarray(tokens), jax.random.PRNGKey(0),
                                  impl="interpret"))
    return dict(jwl=jwl, params=params, tokens=tokens, out=out, state=from_jax_params(tree))


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_generate_matches_jax_interpret(phenaki_run, impl):
    twl = reduced_workload(get_config("phenaki"))
    model = twl.load(phenaki_run["state"], device="cpu")
    stages = []
    out = twl.generate(model, phenaki_run["tokens"], 0, impl=impl, device="cpu",
                       on_stage=lambda name, s, b: stages.append(name))
    assert stages == ["text_encoder", "parallel_decode"]
    assert tuple(out.shape) == phenaki_run["out"].shape == (2, 48)
    assert ((out >= 0) & (out < 128)).all()
    np.testing.assert_array_equal(out.numpy(), phenaki_run["out"])


@pytest.mark.parametrize("tiers", TIERS, ids=TIER_IDS)
def test_backbone_logits_match_jax(phenaki_run, tiers):
    """Two token rows: all masks (the first step) and half unmasked."""
    jax_impl, torch_impl = tiers
    jwl = phenaki_run["jwl"]
    cfg = jwl.cfg
    rng = np.random.default_rng(1)
    S, mask = cfg.frames * cfg.tokens_per_frame, cfg.video_vocab
    half = np.where(rng.random(S) < 0.5, rng.integers(0, mask, S), mask)
    tokens = np.stack([np.full(S, mask), half]).astype(np.int32)
    ctx = rng.standard_normal((2, cfg.text.max_len, cfg.d_model)).astype(np.float32)
    gold = jax.jit(lambda p, t, c: jwl.model.backbone(p, t, c, impl=jax_impl))(
        phenaki_run["params"], jnp.asarray(tokens), jnp.asarray(ctx))
    model = reduced_workload(get_config("phenaki")).load(phenaki_run["state"], device="cpu")
    with torch.inference_mode():
        out = model.backbone(torch.from_numpy(tokens).long(), torch.from_numpy(ctx),
                             impl=torch_impl)
    assert tuple(out.shape) == (2, 48, 128)
    gold = np.asarray(gold)
    scale = max(1.0, float(np.abs(gold).max()))
    np.testing.assert_allclose(out.numpy(), gold, rtol=CHAIN["rtol"], atol=CHAIN["atol"] * scale)


def test_text_stage_projects_the_context(phenaki_run):
    twl = reduced_workload(get_config("phenaki"))
    model = twl.load(phenaki_run["state"], device="cpu")
    stage = twl.cost_descriptor().stages[0]
    state = twl.run_stage(model, stage, {"tokens": torch.from_numpy(phenaki_run["tokens"]).long()},
                          [], impl="kernel")
    jwl = phenaki_run["jwl"]
    gold = jwl.run_stage(phenaki_run["params"], jwl.cost_descriptor().stages[0],
                         {"tokens": jnp.asarray(phenaki_run["tokens"])}, None, impl="interpret")
    assert tuple(state["ctx"].shape) == (2, 16, 64)
    np.testing.assert_allclose(state["ctx"].detach().numpy(), np.asarray(gold["ctx"]), **CHAIN)


def test_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(t_ttv.PhenakiConfig)] == [
        f.name for f in dataclasses.fields(j_ttv.PhenakiConfig)]
    assert _plain(t_ttv.PhenakiConfig(name="x")) == _plain(j_ttv.PhenakiConfig(name="x"))


def test_phenaki_config_matches_jax():
    assert _plain(t_suite.PHENAKI) == _plain(j_get_config("phenaki"))
    assert get_config("phenaki") is t_suite.PHENAKI
    assert _plain(reduced_workload(t_suite.PHENAKI).cfg) == _plain(
        j_reduced_workload(j_get_config("phenaki")).cfg)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_cost_descriptor_matches_jax(reduced):
    jwl, twl = j_workload_for(j_get_config("phenaki")), workload_for(get_config("phenaki"))
    if reduced:
        jwl, twl = j_workload_for(jwl.reduced()), workload_for(twl.reduced())
    jcd, tcd = jwl.cost_descriptor(), twl.cost_descriptor()
    assert (tcd.arch, tcd.route) == (jcd.arch, jcd.route)
    assert [dataclasses.astuple(s) for s in tcd.stages] == [
        dataclasses.astuple(s) for s in jcd.stages]
    assert tcd.step_demands() == jcd.step_demands()
    jr, tr = jwl.prepare_request(3, [1, 2, 3]), twl.prepare_request(3, [1, 2, 3])
    assert (tr.rid, tr.modality, tr.route, tr.denoise_steps, tr.slo_tier) == (
        jr.rid, jr.modality, jr.route, jr.denoise_steps, jr.slo_tier)
    if not reduced:
        assert [(s.name, s.steps, s.seq_len) for s in tcd.stages] == [
            ("text_encoder", 1, 77), ("parallel_decode", 24, 2816)]


def test_full_size_params_bridge_without_transpose():
    """At the full Phenaki config the port's parameter names and shapes are
    the JAX tree's (abstract on both sides: nothing is allocated)."""
    jwl = j_workload_for(j_get_config("phenaki"))
    abstract = jax.eval_shape(jwl.init, jax.random.PRNGKey(0))
    j_shapes = {k: tuple(v.shape) for k, v in flatten_tree(abstract).items()}
    t_defs = param_defs(workload_for(get_config("phenaki")).model)
    assert {k: d.shape for k, d in t_defs.items()} == j_shapes
    assert round(sum(int(np.prod(s)) for s in j_shapes.values()) / 1e6, 1) == 1084.7
    assert t_defs["layer19.temporal.wq.kernel"].shape == (1536, 1536)
    assert t_defs["pos"].shape == (2816, 1536)
