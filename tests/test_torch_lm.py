"""Parity of the port's LM slice (LLaMA2-7B through causal prefill and a KV
cache) with the JAX package.

``reduced(LLAMA2_7B)`` (4 layers of d 64, 4 heads of 16, d_ff 128, vocab
256) runs in both packages on one seeded parameter tree, handed to JAX as is
and bridged unchanged into the port (the stacked ``blocks/g0_dense`` leaves
included).  JAX runs on the ``interpret`` tier, so its prefill reaches the
Pallas flash-attention kernel in interpret mode; the port runs both its
tiers on the CPU.  Greedy tokens must be equal to the reference's live
output (never to the constants pinned by the reference's own LM tests).

Tolerances are the reference's: 2e-5 for one layer, 1e-4 for a whole
chain (relative to the output's scale, as ``tests/test_torch_muse.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.suite  # noqa: F401  (registers the suite)
from repro.configs import base as j_base
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models.layers import attention as j_attention
from repro.models.layers import mlp as j_mlp
from repro.models.layers import norms as j_norms
from repro.models.layers import rope as j_rope
from repro.workload import workload_for as j_workload_for
from repro_torch.configs import base as t_base
from repro_torch.configs import get_config, reduced
from repro_torch.configs import suite as t_suite
from repro_torch.models.layers import attention as t_attention
from repro_torch.models.layers import mlp as t_mlp
from repro_torch.models.layers import norms as t_norms
from repro_torch.models.layers import rope as t_rope
from repro_torch.nn import from_jax_params, init_params, materialize, param_defs
from repro_torch.nn.module import flatten_tree
from repro_torch.workload import LMWorkload, reduced_workload, workload_for

LAYER = dict(rtol=2e-5, atol=2e-5)
CHAIN = dict(rtol=1e-4, atol=1e-4)
TIERS = [("interpret", "kernel"), ("blocked_jax", "torch")]
TIER_IDS = ["fused", "unfused"]
PROMPT, NEW = 16, 8


def _tree(state: dict, seed: int = 3) -> dict:
    """The port's flat state dict as a nested numpy tree (JAX's layout), every
    norm scale drawn around 1 so that no leaf is trivial."""
    rng = np.random.default_rng(seed)
    tree = {}
    for k, v in state.items():
        *path, leaf = k.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        v = v.numpy()
        if leaf == "scale":
            v = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        node[leaf] = v
    return tree


def _close_to_scale(out, gold, tol=CHAIN):
    """|out - gold| <= atol * max(1, max|gold|) + rtol * |gold|."""
    gold = np.asarray(gold, np.float32)
    scale = max(1.0, float(np.abs(gold).max()))
    np.testing.assert_allclose(np.asarray(out, np.float32), gold, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _plain(v):
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name)) for f in dataclasses.fields(v)
                if f.name != "dtype"}
    return tuple(map(_plain, v)) if isinstance(v, tuple) else v


def _bridge(tmod, seed=0):
    tree = _tree(init_params(tmod, seed))
    return jax.tree.map(jnp.asarray, tree), materialize(tmod, from_jax_params(tree), "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def lm_run():
    """The reduced LLaMA on one seeded tree: the JAX workload, params and its
    interpret-tier generate of 2 requests (16-token prompts, 8 new tokens),
    computed once for the module."""
    jwl = j_workload_for(j_reduced(j_get_config("llama2-7b")))
    tree = _tree(init_params(reduced_workload(get_config("llama2-7b")).model, 0))
    params = jax.tree.map(jnp.asarray, tree)
    tokens = np.random.default_rng(0).integers(0, 256, (2, PROMPT)).astype(np.int32)
    out = np.asarray(jwl.generate(params, jnp.asarray(tokens), jax.random.PRNGKey(0),
                                  impl="interpret", max_new_tokens=NEW))
    return dict(jwl=jwl, params=params, tokens=tokens, out=out, state=from_jax_params(tree))


def _port_model(lm_run):
    twl = reduced_workload(get_config("llama2-7b"))
    return twl, twl.load(lm_run["state"], device="cpu")


# ---------------------------------------------------------------------------
# Layers: RoPE, RMSNorm, the gated MLP, causal GQA attention and its decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rotary_pct", [1.0, 0.25])
def test_rope_matches_jax(rotary_pct):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(6), np.array([0, 5, 100, 2047, 2111, 9])]).astype(np.int32)
    gold = j_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), rotary_pct=rotary_pct)
    out = t_rope.apply_rope(_t(x), _t(pos), rotary_pct=rotary_pct)
    _close_to_scale(out.numpy(), gold, LAYER)
    np.testing.assert_array_equal(t_rope.rope_freqs(128).numpy(),
                                  np.asarray(j_rope.rope_freqs(128)))


def test_rmsnorm_matches_jax():
    jp, tnorm = _bridge(t_norms.RMSNorm(64))
    x = (3.0 * np.random.default_rng(2).standard_normal((2, 5, 64))).astype(np.float32)
    gold = j_norms.RMSNorm(64)(jp, jnp.asarray(x))
    _close_to_scale(tnorm(_t(x)).detach().numpy(), gold, LAYER)
    assert tnorm.eps == 1e-6


@pytest.mark.parametrize("activation,gated", [("silu", True), ("gelu", False)])
def test_mlp_matches_jax(activation, gated):
    jp, tmlp = _bridge(t_mlp.MLP(64, 128, activation=activation, gated=gated))
    assert sorted(jp) == (["wg", "wi", "wo"] if gated else ["wi", "wo"])
    x = np.random.default_rng(3).standard_normal((2, 5, 64)).astype(np.float32)
    gold = j_mlp.MLP(64, 128, activation=activation, gated=gated)(jp, jnp.asarray(x))
    _close_to_scale(tmlp(_t(x)).detach().numpy(), gold, LAYER)


def _attn_pair(**kw):
    args = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, **kw)
    jattn = j_attention.Attention(**args)
    jp, tattn = _bridge(t_attention.Attention(
        64, 4, 16, n_kv_heads=2, rope=args.get("rope", True), causal=args.get("causal", True),
        qkv_bias=args.get("qkv_bias", False)))
    return jattn, jp, tattn


@pytest.mark.parametrize("tiers", TIERS, ids=TIER_IDS)
def test_causal_gqa_attention_matches_jax(tiers):
    jax_impl, torch_impl = tiers
    jattn, jp, tattn = _attn_pair(qkv_bias=True)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    gold, gold_kv = jattn(jp, jnp.asarray(x), positions=jnp.asarray(pos), impl=jax_impl,
                          return_kv=True)
    out, kv = tattn(_t(x), positions=_t(pos), impl=torch_impl, return_kv=True)
    _close_to_scale(out.detach().numpy(), gold, LAYER)
    _close_to_scale(kv.k.detach().numpy(), gold_kv.k, LAYER)
    # the first position attends to itself only: its output does not see the rest
    x2 = x.copy()
    x2[:, 1:] = rng.standard_normal((2, 10, 64))
    out2 = tattn(_t(x2), positions=_t(pos), impl=torch_impl)
    _close_to_scale(out2[:, :1].detach().numpy(), out[:, :1].detach().numpy(), LAYER)


def test_attention_decode_matches_jax_step_by_step():
    """Four decode steps from a cache holding 3 prefilled rows: rotated at
    each position, written in place, GQA (4 query heads on 2 kv heads)."""
    jattn, jp, tattn = _attn_pair()
    rng = np.random.default_rng(5)
    k0 = np.zeros((2, 8, 2, 16), np.float32)
    v0 = np.zeros((2, 8, 2, 16), np.float32)
    k0[:, :3], v0[:, :3] = rng.standard_normal((2, 2, 3, 2, 16))
    jcache = j_attention.AttentionCache(k=jnp.asarray(k0), v=jnp.asarray(v0))
    tcache = t_attention.AttentionCache(_t(k0.copy()), _t(v0.copy()))
    for cur in range(3, 7):
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        gold, jcache = jattn.decode(jp, jnp.asarray(x), jcache, jnp.int32(cur))
        out, tcache = tattn.decode(_t(x), tcache, cur)
        _close_to_scale(out.detach().numpy(), gold, LAYER)
        _close_to_scale(tcache.k.detach().numpy(), jcache.k, LAYER)
        _close_to_scale(tcache.v.detach().numpy(), jcache.v, LAYER)


def test_decode_attention_matches_jax():
    from repro.kernels.flash_attention import ops as j_ops
    from repro_torch.kernels.flash_attention import ops as t_ops

    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 1, 8, 16)).astype(np.float32)
    k, v = rng.standard_normal((2, 2, 12, 2, 16)).astype(np.float32)
    for kv_len in (1, 7, 12):
        gold = j_ops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      kv_len=jnp.full((2,), kv_len, jnp.int32))
        out = t_ops.decode_attention(_t(q), _t(k), _t(v), kv_len=kv_len)
        _close_to_scale(out.numpy(), gold, LAYER)
        # one length a request, as a tensor: the masked form of the same function
        lens = np.array([kv_len, max(1, kv_len - 3)], np.int32)
        gold = j_ops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      kv_len=jnp.asarray(lens))
        out = t_ops.decode_attention(_t(q), _t(k), _t(v), kv_len=_t(lens))
        _close_to_scale(out.numpy(), gold, LAYER)


# ---------------------------------------------------------------------------
# The LM: prefill, decode_step, generate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tiers", TIERS, ids=TIER_IDS)
def test_prefill_matches_jax(lm_run, tiers):
    """Last-position logits and the caches, padded with zeros to capacity."""
    jax_impl, torch_impl = tiers
    jwl, cap = lm_run["jwl"], PROMPT + NEW
    toks = lm_run["tokens"]
    gold, gold_caches, _ = jwl.model.prefill(lm_run["params"], jnp.asarray(toks),
                                             impl=jax_impl, max_len=cap)
    _, model = _port_model(lm_run)
    with torch.inference_mode():
        logits, caches = model.prefill(_t(toks).long(), impl=torch_impl, max_len=cap)
    assert tuple(logits.shape) == (2, 1, 256)
    _close_to_scale(logits.numpy(), gold)
    assert len(caches) == len(gold_caches) == 1
    for name in ("k", "v"):
        t, g = getattr(caches[0]["attn"], name), getattr(gold_caches[0]["attn"], name)
        assert tuple(t.shape) == g.shape == (4, 2, cap, 4, 16)
        _close_to_scale(t.numpy(), g)
        assert not t[:, :, PROMPT:].any()


def test_decode_step_matches_jax_at_three_positions(lm_run):
    jwl, cap = lm_run["jwl"], PROMPT + NEW
    toks = lm_run["tokens"]
    _, jcaches, _ = jwl.model.prefill(lm_run["params"], jnp.asarray(toks), impl="interpret",
                                      max_len=cap)
    _, model = _port_model(lm_run)
    with torch.inference_mode():
        _, caches = model.prefill(_t(toks).long(), max_len=cap)
        nxt = np.random.default_rng(7).integers(0, 256, (3, 2, 1)).astype(np.int32)
        for i, cur in enumerate(range(PROMPT, PROMPT + 3)):
            gold, jcaches = jwl.model.decode_step(lm_run["params"], jnp.asarray(nxt[i]), jcaches,
                                                  jnp.int32(cur))
            logits, caches = model.decode_step(_t(nxt[i]).long(), caches, cur)
            _close_to_scale(logits.numpy(), gold)
        _close_to_scale(caches[0]["attn"].k.numpy(), jcaches[0]["attn"].k)


def test_prefill_then_decode_equals_full_forward(lm_run):
    """Prefill of the first 10 tokens, then 6 decode steps, give the full
    causal forward's logits at the same positions (and it the reference's)."""
    _, model = _port_model(lm_run)
    toks = torch.from_numpy(lm_run["tokens"]).long()
    gold, _ = lm_run["jwl"].model.forward(lm_run["params"], jnp.asarray(lm_run["tokens"]),
                                          impl="interpret")
    with torch.inference_mode():
        full = model(toks)
        _close_to_scale(full.numpy(), gold)
        logits, caches = model.prefill(toks[:, :10], max_len=PROMPT)
        steps = [logits[:, 0]]
        for cur in range(10, PROMPT):
            logits, caches = model.decode_step(toks[:, cur:cur + 1], caches, cur)
            steps.append(logits[:, 0])
    _close_to_scale(torch.stack(steps, 1).numpy(), full[:, 9:].numpy())


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_generate_tokens_equal_jax(lm_run, impl):
    twl, model = _port_model(lm_run)
    stages = []
    out = twl.generate(model, lm_run["tokens"], 0, impl=impl, device="cpu", max_new_tokens=NEW,
                       on_stage=lambda name, s, b: stages.append(name))
    assert stages == ["prefill", "decode"]
    assert tuple(out.shape) == lm_run["out"].shape == (2, NEW)
    np.testing.assert_array_equal(out.numpy(), lm_run["out"])


def test_generate_requests_per_request_budgets(lm_run):
    """A budget a request: each output is its own length, the longest run's
    prefix (greedy tokens do not depend on the budget)."""
    twl, model = _port_model(lm_run)
    outs = twl.generate_requests(model, lm_run["tokens"], 0, device="cpu",
                                 max_new_tokens=[3, NEW])
    assert [tuple(o.shape) for o in outs] == [(3,), (NEW,)]
    np.testing.assert_array_equal(outs[0].numpy(), lm_run["out"][0, :3])
    np.testing.assert_array_equal(outs[1].numpy(), lm_run["out"][1])


def test_greedy_argmax_takes_the_first_of_tied_maxima():
    """Crafted logits with exact ties: the port's next-token rule and
    ``jnp.argmax`` both take the first index."""
    logits = np.zeros((3, 10), np.float32)
    logits[0, [2, 7]] = 5.0
    logits[1, [0, 9]] = 1.0
    logits[2] = -1.0  # all tied
    gold = np.asarray(jnp.argmax(jnp.asarray(logits), -1))
    np.testing.assert_array_equal(gold, [2, 0, 0])
    np.testing.assert_array_equal(LMWorkload._next_token(_t(logits))[:, 0].numpy(), gold)


def test_temperature_above_zero_is_not_ported(lm_run):
    """Sampling at temperature > 0 is not a bit-for-bit port of the
    reference's ``jax.random.categorical``: the port draws Gumbel-max noise
    from its own per-request generators, the same distribution
    (``tests/test_torch_serving.py``).  Its tokens are seeded, in the
    vocabulary, and not the greedy ones."""
    twl, model = _port_model(lm_run)
    a, b = (twl.generate(model, lm_run["tokens"], 0, device="cpu", temperature=0.7,
                         max_new_tokens=NEW) for _ in range(2))
    assert torch.equal(a, b) and tuple(a.shape) == lm_run["out"].shape
    assert ((a >= 0) & (a < 256)).all()
    assert not np.array_equal(a.numpy(), lm_run["out"])


# ---------------------------------------------------------------------------
# Configs, stage plan, the full-size bridge
# ---------------------------------------------------------------------------


def test_lm_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(t_base.LMConfig)] == [
        f.name for f in dataclasses.fields(j_base.LMConfig)]
    kw = dict(name="x", family="dense", n_layers=2, d_model=8, n_heads=2, n_kv_heads=1,
              d_ff=16, vocab=10)
    t, j = t_base.LMConfig(**kw), j_base.LMConfig(**kw)
    assert _plain(t) == _plain(j)
    assert (t.resolved_head_dim, t.block_types(), t.is_encdec) == (
        j.resolved_head_dim, j.block_types(), j.is_encdec)


def test_llama_config_matches_jax():
    assert _plain(t_suite.LLAMA2_7B) == _plain(j_get_config("llama2-7b"))
    assert get_config("llama2-7b") is t_suite.LLAMA2_7B
    assert t_suite.LLAMA2_7B.dtype == torch.float32
    assert _plain(reduced(t_suite.LLAMA2_7B)) == _plain(j_reduced(j_get_config("llama2-7b")))
    assert _plain(workload_for(get_config("llama2-7b")).reduced()) == _plain(
        j_reduced(j_get_config("llama2-7b")))


def test_other_lm_families_wait_for_their_slice():
    for change in (dict(block_pattern=("moe",)), dict(qk_norm=True), dict(norm="nonparametric_ln")):
        cfg = dataclasses.replace(t_suite.LLAMA2_7B, **change)
        with pytest.raises(NotImplementedError, match="not ported"):
            workload_for(cfg)


@pytest.mark.parametrize("reduced_cfg", [False, True], ids=["full", "reduced"])
def test_cost_descriptor_and_request_match_jax(reduced_cfg):
    jcfg, tcfg = j_get_config("llama2-7b"), get_config("llama2-7b")
    if reduced_cfg:
        jcfg, tcfg = j_reduced(jcfg), reduced(tcfg)
    jwl, twl = j_workload_for(jcfg), workload_for(tcfg)
    jcd, tcd = jwl.cost_descriptor(), twl.cost_descriptor()
    assert (tcd.arch, tcd.route) == (jcd.arch, jcd.route)
    assert [dataclasses.astuple(s) for s in tcd.stages] == [
        dataclasses.astuple(s) for s in jcd.stages]
    assert tcd.step_demands() == jcd.step_demands()
    assert (twl.prompt_vocab, twl.max_prompt_len) == (jwl.prompt_vocab, jwl.max_prompt_len)
    jr, tr = jwl.prepare_request(3, [1, 2], max_new_tokens=5), twl.prepare_request(
        3, [1, 2], max_new_tokens=5)
    assert (tr.rid, tr.modality, tr.route, tr.max_new_tokens, tr.denoise_steps, tr.slo_tier) == (
        jr.rid, jr.modality, jr.route, jr.max_new_tokens, jr.denoise_steps, jr.slo_tier)


def test_full_size_params_bridge_without_restacking():
    """At full width the port's keys and shapes are the JAX tree's, the
    32 layers stacked under ``blocks.g0_dense`` (abstract on both sides)."""
    jwl = j_workload_for(j_get_config("llama2-7b"))
    abstract = jax.eval_shape(jwl.init, jax.random.PRNGKey(0))
    j_shapes = {k: tuple(v.shape) for k, v in flatten_tree(abstract).items()}
    t_defs = param_defs(workload_for(get_config("llama2-7b")).model)
    assert {k: d.shape for k, d in t_defs.items()} == j_shapes
    assert round(sum(int(np.prod(s)) for s in j_shapes.values()) / 1e6, 1) == 6738.4
    assert t_defs["blocks.g0_dense.mlp.wg.kernel"].shape == (32, 4096, 11008)
    assert t_defs["blocks.g0_dense.mlp.wg.kernel"].layers == 32


def test_stacked_init_draws_each_layer_at_its_fan_in():
    """A stacked leaf's layers are distinct draws at the layer's own fan-in,
    the same values on every path that draws them."""
    model = reduced_workload(get_config("llama2-7b")).model
    a = init_params(model, 0)
    wq = a["blocks.g0_dense.attn.wq.kernel"]
    assert tuple(wq.shape) == (4, 64, 64)
    assert not torch.equal(wq[0], wq[1])
    assert abs(wq.std().item() * 64 ** 0.5 - 1.0) < 0.05
    loaded = reduced_workload(get_config("llama2-7b")).init(0, device="cpu")
    assert all(torch.equal(a[k], v) for k, v in loaded.state_dict().items())
