"""Parity of the port's dense assigned LMs (``olmo-1b``, ``stablelm-3b``,
``glm4-9b``, ``qwen2-72b``) with the JAX package.

What each adds to LLaMA's path: OLMo's non-parametric LayerNorm (no leaves)
and tied head (``Embedding.attend``, no ``lm_head`` leaf), StableLM's
parametric LayerNorm and partial rotary (20 of 80 dims at full width), GLM's
GQA 32:2 with QKV bias, Qwen2's GQA 64:8 with QKV bias and RoPE base 1e6.

Each reduced config (4 layers of d 64, 4 heads of 16) runs in both packages
on one seeded parameter tree, handed to JAX in the reference's own tree
structure (OLMo's norms are empty subtrees there) and bridged unchanged into
the port.  JAX runs on the ``interpret`` tier, so its prefill reaches the
Pallas flash-attention kernel in interpret mode.  Greedy tokens must equal
the reference's live output, never the constants pinned by the reference's
own LM tests.  Tolerances are the reference's: 2e-5 for one layer, 1e-4 for
a whole chain (relative to the output's scale).  The full-width event
streams are in ``tests/test_torch_trace_parity_dense_lms.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_configs
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import tracer as j_tracer
from repro.models.layers import basic as j_basic
from repro.models.layers import norms as j_norms
from repro.models.layers import rope as j_rope
from repro.workload import workload_for as j_workload_for
from repro_torch import configs as t_configs
from repro_torch.configs import get_config, reduced
from repro_torch.core import tracer
from repro_torch.models.layers import basic as t_basic
from repro_torch.models.layers import norms as t_norms
from repro_torch.models.layers import rope as t_rope
from repro_torch.nn import from_jax_params, init_params, materialize, param_defs
from repro_torch.nn.module import flatten_tree
from repro_torch.workload import reduced_workload, workload_for

ARCHS = ["olmo-1b", "stablelm-3b", "glm4-9b", "qwen2-72b"]
LAYER = dict(rtol=2e-5, atol=2e-5)
CHAIN = dict(rtol=1e-4, atol=1e-4)
PROMPT, NEW = 16, 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's reduced models: under several
    test workers, 8 threads a worker oversubscribe the cores.  Restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(v):
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name)) for f in dataclasses.fields(v)
                if f.name != "dtype"}
    return tuple(map(_plain, v)) if isinstance(v, tuple) else v


def _close_to_scale(out, gold, tol=CHAIN):
    """|out - gold| <= atol * max(1, max|gold|) + rtol * |gold|."""
    gold = np.asarray(gold, np.float32)
    scale = max(1.0, float(np.abs(gold).max()))
    np.testing.assert_allclose(np.asarray(out, np.float32), gold, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _t(a):
    return torch.from_numpy(np.array(a))


def _reference_tree(abstract: dict, state: dict, seed: int = 3, path: str = "") -> dict:
    """The port's seeded values in the reference's tree structure (an empty
    subtree where a layer has no leaves), every norm scale drawn around 1 so
    that no leaf is trivial."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in abstract.items():
        key = f"{path}.{k}" if path else k
        if isinstance(v, dict):
            out[k] = _reference_tree(v, state, seed + len(out) + 1, key)
        else:
            val = state[key].numpy()
            if k == "scale":
                val = (1.0 + 0.1 * rng.standard_normal(val.shape)).astype(np.float32)
            out[k] = val
    return out


@pytest.fixture(scope="module")
def runs():
    """Each reduced config on one seeded tree: the JAX workload, params, and
    its interpret-tier generate of 2 requests (16-token prompts, 8 new
    tokens), computed once for the module."""
    out = {}
    tokens = np.random.default_rng(0).integers(0, 256, (2, PROMPT)).astype(np.int32)
    for arch in ARCHS:
        jwl = j_workload_for(j_reduced(j_get_config(arch)))
        abstract = jax.eval_shape(jwl.init, jax.random.PRNGKey(0))
        tree = _reference_tree(abstract, init_params(reduced_workload(get_config(arch)).model, 0))
        params = jax.tree.map(jnp.asarray, tree)
        gen = np.asarray(jwl.generate(params, jnp.asarray(tokens), jax.random.PRNGKey(0),
                                      impl="interpret", max_new_tokens=NEW))
        out[arch] = dict(jwl=jwl, abstract=abstract, params=params, tokens=tokens, out=gen,
                         state=from_jax_params(tree))
    return out


def _port(run, arch):
    twl = reduced_workload(get_config(arch))
    return twl, twl.load(run["state"], device="cpu")


# ---------------------------------------------------------------------------
# Configs and leaves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_its_reduction_match_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert _plain(cfg) == _plain(jcfg)
    assert cfg.dtype == torch.float32 and jcfg.dtype == jnp.float32
    assert cfg.source == jcfg.source and cfg.source
    assert _plain(reduced(cfg)) == _plain(j_reduced(jcfg))
    assert _plain(workload_for(cfg).reduced()) == _plain(j_reduced(jcfg))


def test_registry_lists_the_dense_assigned_archs_in_the_references_order():
    assert [a for a in t_configs.ASSIGNED_ARCHS if a in ARCHS] == [
        a for a in j_configs.ASSIGNED_ARCHS if a in ARCHS]
    assert set(ARCHS) <= set(t_configs.list_configs())
    assert reduced(get_config("glm4-9b")).n_kv_heads == 1
    assert reduced(get_config("qwen2-72b")).n_kv_heads == 1
    assert reduced(get_config("olmo-1b")).n_kv_heads == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_leaves_are_the_references(arch):
    """Keys and shapes of the port's declared leaves equal the reference's
    abstract tree at full width: ``olmo-1b`` has no ``lm_head`` and no norm
    leaf."""
    jwl = j_workload_for(j_get_config(arch))
    abstract = jax.eval_shape(jwl.init, jax.random.PRNGKey(0))
    j_shapes = {k: tuple(v.shape) for k, v in flatten_tree(abstract).items()}
    t_defs = param_defs(workload_for(get_config(arch)).model)
    assert {k: d.shape for k, d in t_defs.items()} == j_shapes
    n = sum(int(np.prod(s)) for s in j_shapes.values())
    if arch == "olmo-1b":
        assert not any(k.startswith("lm_head") or "norm" in k for k in t_defs)
        assert n == j_get_config(arch).param_count() == 1_176_764_416
    else:
        assert "lm_head.kernel" in t_defs
    assert round(n / 1e9, 2) == {"olmo-1b": 1.18, "stablelm-3b": 2.80, "glm4-9b": 9.40,
                                 "qwen2-72b": 72.71}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_leaves_bridge_exactly(runs, arch):
    """The bridged state has exactly the port's keys: ``materialize`` raises
    on a missing or extra leaf."""
    run = runs[arch]
    twl = reduced_workload(get_config(arch))
    assert set(run["state"]) == set(param_defs(twl.model))
    assert set(run["state"]) == set(flatten_tree(run["abstract"]))
    materialize(twl.model, run["state"], "cpu")


# ---------------------------------------------------------------------------
# Layers: the non-parametric LayerNorm, the tied head, partial rotary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_scale,with_bias", [(False, False), (True, True)])
def test_layernorm_matches_jax(with_scale, with_bias):
    tnorm = t_norms.LayerNorm(64, with_scale=with_scale, with_bias=with_bias)
    jnorm = j_norms.LayerNorm(64, with_scale=with_scale, with_bias=with_bias)
    assert sorted(tnorm.param_defs) == sorted(jnorm.defs())
    rng = np.random.default_rng(1)
    jp = {k: (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32) for k in jnorm.defs()}
    tnorm = materialize(tnorm, {k: _t(v) for k, v in jp.items()}, "cpu")
    x = (3.0 * rng.standard_normal((2, 5, 64)) + 1.0).astype(np.float32)
    gold = jnorm({k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x))
    _close_to_scale(tnorm(_t(x)).numpy(), gold, LAYER)
    with tracer.trace() as t, j_tracer.trace() as jt:
        tnorm(_t(x))
        jnorm({k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x))
    assert [(e.op, e.name, e.flops, e.bytes_hbm) for e in t.events] == [
        (e.op, e.name, e.flops, e.bytes_hbm) for e in jt.events]


def test_tied_head_matches_jax_and_records_its_event():
    """``Embedding.attend``: logits through the transposed table, in x's
    dtype, recorded as the reference's ``embed_logits`` linear event."""
    rng = np.random.default_rng(2)
    table = (0.02 * rng.standard_normal((50, 32))).astype(np.float32)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    temb = materialize(t_basic.Embedding(50, 32), {"table": _t(table)}, "cpu")
    jemb = j_basic.Embedding(50, 32)
    with tracer.trace() as t, j_tracer.trace() as jt:
        out = temb.attend(_t(x))
        gold = jemb.attend({"table": jnp.asarray(table)}, jnp.asarray(x))
    _close_to_scale(out.numpy(), gold, LAYER)
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 3, 50)
    assert [(e.op, e.name, e.flops, e.bytes_hbm) for e in t.events] == [
        (e.op, e.name, e.flops, e.bytes_hbm) for e in jt.events] == [
        ("linear", "embed_logits", 2.0 * 6 * 32 * 50, 4.0 * (6 * 32 + 6 * 50 + 50 * 32))]
    half = temb.attend(_t(x).to(torch.bfloat16))
    assert half.dtype == torch.bfloat16


def test_partial_rotary_of_stablelm_matches_jax():
    """D = 80 at 25 %: the first 20 channels of each head rotate."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 2, 80)).astype(np.float32)
    pos = np.stack([np.arange(5), np.array([0, 7, 100, 2047, 2063])]).astype(np.int32)
    gold = j_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), rotary_pct=0.25)
    out = t_rope.apply_rope(_t(x), _t(pos), rotary_pct=0.25)
    _close_to_scale(out.numpy(), gold, LAYER)
    np.testing.assert_array_equal(out[..., 20:].numpy(), x[..., 20:])
    assert not np.allclose(out[1, 1:, :, :20].numpy(), x[1, 1:, :, :20])


# ---------------------------------------------------------------------------
# The reduced LMs: prefill logits, greedy tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_prefill_logits_match_jax(runs, arch):
    run = runs[arch]
    cap = PROMPT + NEW
    gold, gold_caches, _ = run["jwl"].model.prefill(run["params"], jnp.asarray(run["tokens"]),
                                                    impl="interpret", max_len=cap)
    _, model = _port(run, arch)
    with torch.inference_mode():
        logits, caches, _ = model.prefill(_t(run["tokens"]).long(), impl="kernel", max_len=cap)
    assert tuple(logits.shape) == (2, 1, 256)
    _close_to_scale(logits.numpy(), gold)
    _close_to_scale(caches[0]["attn"].k.numpy(), gold_caches[0]["attn"].k)
    _close_to_scale(caches[0]["attn"].v.numpy(), gold_caches[0]["attn"].v)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_greedy_tokens_equal_jax(runs, arch, impl):
    run = runs[arch]
    twl, model = _port(run, arch)
    out = twl.generate(model, run["tokens"], 0, impl=impl, device="cpu", max_new_tokens=NEW)
    assert tuple(out.shape) == run["out"].shape == (2, NEW)
    np.testing.assert_array_equal(out.numpy(), run["out"])


def test_olmo_has_no_lm_head_and_norms_without_leaves():
    model = reduced_workload(get_config("olmo-1b")).model
    assert not hasattr(model, "lm_head")
    assert model.final_norm.param_defs == {}
    assert not (model.final_norm.with_scale or model.final_norm.with_bias)
    assert hasattr(reduced_workload(get_config("glm4-9b")).model, "lm_head")
