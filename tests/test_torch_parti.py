"""Parity of the port's Parti slice (autoregressive text-to-image: causal
blocks decoded token by token against a KV cache, then a VQ-GAN decoder)
with the JAX package.

``reduced_workload(get_config("parti"))`` (2 layers of d 64, 16 image
tokens) runs in both packages on one seeded parameter tree, handed to JAX as
is and bridged unchanged into the port.  The JAX side runs ``generate`` on
the ``interpret`` tier (Pallas kernels in interpret mode); the port runs
``generate`` on both its tiers on the CPU.  Greedy decoding is
deterministic, so the tokens must be equal.

Two hazards of the reference are pinned, each by a test that fails without
the port's handling of it:
  * decode rotates q and the new k at the cache position (``Attention.decode``
    always passes positions), while the backbone passes none, so its RoPE is
    a no-op;
  * step t embeds the previous token and adds ``pos[max(t - 1, 0)]``: steps
    0 and 1 both add ``pos[0]``.

Tolerances are the reference's: 2e-5 for one layer, 1e-4 for a chain, 2e-2
in bf16 (relative to the output's scale, as ``tests/test_torch_muse.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.suite as j_suite
from repro.configs import get_config as j_get_config
from repro.models import transformer as j_transformer
from repro.models.layers.attention import AttentionCache as JCache
from repro.workload import reduced_workload as j_reduced_workload
from repro.workload import workload_for as j_workload_for
from repro_torch.configs import get_config
from repro_torch.configs import suite as t_suite
from repro_torch.models import transformer as t_transformer
from repro_torch.models.layers.attention import AttentionCache
from repro_torch.nn import from_jax_params, init_params, materialize, param_defs
from repro_torch.nn.module import flatten_tree
from repro_torch.workload import reduced_workload, workload_for

LAYER = dict(rtol=2e-5, atol=2e-5)
CHAIN = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _tree(state: dict) -> dict:
    """The port's flat state dict as a nested numpy tree (JAX's layout)."""
    tree = {}
    for k, v in state.items():
        *path, leaf = k.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.float().numpy()
    return tree


def _close_to_scale(out, gold, tol=CHAIN):
    """|out - gold| <= atol * max(1, max|gold|) + rtol * |gold|."""
    gold = np.asarray(gold, np.float32)
    scale = max(1.0, float(np.abs(gold).max()))
    np.testing.assert_allclose(np.asarray(out, np.float32), gold, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _plain(v):
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name)) for f in dataclasses.fields(v)}
    if isinstance(v, tuple):
        return tuple(map(_plain, v))
    return str(v).split(".")[-1].strip("'>") if "float" in str(v) else v  # dtypes by name


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _capture_states(wl, states: dict):
    """Wrap ``wl.run_stage`` (either package's) to keep each stage's output."""
    run = wl.run_stage

    def run_stage(params, stage, *a, **k):
        states[stage.name] = run(params, stage, *a, **k)
        return states[stage.name]

    wl.run_stage = run_stage


@pytest.fixture(scope="module")
def parti_run():
    """JAX reduced Parti: params, prompts and its interpret-tier generate with
    the decoded image tokens, computed once for the module."""
    jwl = j_reduced_workload(j_get_config("parti"))
    tree = _tree(init_params(reduced_workload(get_config("parti")).model, 0))
    params = jax.tree.map(jnp.asarray, tree)
    tokens = np.random.default_rng(0).integers(
        0, jwl.cfg.text.vocab, (2, jwl.cfg.text.max_len)).astype(np.int32)
    states = {}
    _capture_states(jwl, states)
    out = np.asarray(jwl.generate(params, jnp.asarray(tokens), jax.random.PRNGKey(0),
                                  impl="interpret"))
    return dict(jwl=jwl, tree=tree, params=params, tokens=tokens, out=out,
                img_tokens=np.asarray(states["ar_decode"]["img_tokens"]),
                state=from_jax_params(tree))


def _port(parti_run, tree=None):
    twl = reduced_workload(get_config("parti"))
    state = parti_run["state"] if tree is None else from_jax_params(tree)
    return twl, twl.load(state, device="cpu")


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_generate_matches_jax_interpret(parti_run, impl):
    twl, model = _port(parti_run)
    states, stages = {}, []
    _capture_states(twl, states)
    out = twl.generate(model, parti_run["tokens"], 0, impl=impl, device="cpu",
                       on_stage=lambda name, s, b: stages.append(name))
    assert stages == ["text_encoder", "ar_decode", "vq_decoder"]
    img_tokens = states["ar_decode"]["img_tokens"].numpy()
    assert img_tokens.shape == (2, 16) and ((img_tokens >= 0) & (img_tokens < 128)).all()
    np.testing.assert_array_equal(img_tokens, parti_run["img_tokens"])
    assert tuple(out.shape) == parti_run["out"].shape == (2, 8, 8, 3)
    _close_to_scale(out.numpy(), parti_run["out"], LAYER)


def _block_pair(cfg):
    jblock = j_transformer.Block(cfg.lm_config(), "dense", causal=True, with_cross=True)
    tcfg = reduced_workload(get_config("parti")).cfg
    tblock = t_transformer.Block(tcfg.lm_config(), "dense", causal=True, with_cross=True)
    tree = _tree(init_params(tblock, 2))
    return jblock, jax.tree.map(jnp.asarray, tree), materialize(tblock, from_jax_params(tree),
                                                                "cpu")


def _decode_inputs(cfg, cur, seed=4):
    rng = np.random.default_rng(seed)
    D, H = cfg.d_model // cfg.n_heads, cfg.n_heads
    k0 = np.zeros((2, cfg.image_tokens, H, D), np.float32)
    v0 = np.zeros_like(k0)
    k0[:, :cur], v0[:, :cur] = rng.standard_normal((2, 2, cur, H, D))
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    ck, cv = rng.standard_normal((2, 2, 7, H, D)).astype(np.float32)
    return x, k0, v0, ck, cv


def _block_decode_both(parti_run, cur, rope=True):
    cfg = parti_run["jwl"].cfg
    jblock, jp, tblock = _block_pair(cfg)
    x, k0, v0, ck, cv = _decode_inputs(cfg, cur)
    gold, gold_st = jblock.decode(jp, jnp.asarray(x), {"attn": JCache(jnp.asarray(k0),
                                                                        jnp.asarray(v0))},
                                  jnp.int32(cur), cross_cache=JCache(jnp.asarray(ck),
                                                                     jnp.asarray(cv)))
    tblock.attn.rope = rope
    with torch.inference_mode():
        out, st = tblock.decode(_t(x), {"attn": AttentionCache(_t(k0), _t(v0))}, cur,
                                cross_cache=AttentionCache(_t(ck), _t(cv)))
    return gold, gold_st["attn"], out, st["attn"]


def test_block_decode_matches_jax(parti_run):
    """One causal ``Block.decode`` step with cross-attention at cache
    position 5: the output and the cache row it writes."""
    gold, gold_kv, out, kv = _block_decode_both(parti_run, 5)
    _close_to_scale(out.numpy(), gold, LAYER)
    _close_to_scale(kv.k.numpy(), gold_kv.k, LAYER)
    _close_to_scale(kv.v.numpy(), gold_kv.v, LAYER)


def test_decode_rotates_at_the_cache_position(parti_run):
    """The reference's decode rotates q and the new k at ``cur_len`` though
    Parti's backbone never rotates: without RoPE in decode the step differs
    from the reference by far more than the tolerance."""
    gold, gold_kv, out, kv = _block_decode_both(parti_run, 9)
    _close_to_scale(kv.k.numpy(), gold_kv.k, LAYER)
    gold, gold_kv, out, kv = _block_decode_both(parti_run, 9, rope=False)
    assert np.abs(kv.k.numpy()[:, 9] - np.asarray(gold_kv.k)[:, 9]).max() > 0.1
    assert np.abs(out.numpy() - np.asarray(gold)).max() > 1e-3


def test_backbone_does_not_rotate(parti_run):
    """Parti's causal backbone (a training pass in the reference) passes no
    positions: equal to the reference's, where RoPE is a no-op."""
    jwl = parti_run["jwl"]
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 128, (2, 16)).astype(np.int32)
    ctx = rng.standard_normal((2, 7, 64)).astype(np.float32)
    gold = jwl.model.backbone(parti_run["params"], jnp.asarray(toks), jnp.asarray(ctx),
                              impl="interpret")
    _, model = _port(parti_run)
    with torch.inference_mode():
        out = model.backbone(torch.from_numpy(toks).long(), _t(ctx))
    _close_to_scale(out.numpy(), gold)


def _decode_ar_both(parti_run, tree):
    """Tokens of both packages' ``decode_ar`` on one tree and context."""
    jwl = parti_run["jwl"]
    ctx = np.random.default_rng(6).standard_normal((2, 7, 64)).astype(np.float32)
    gold = jwl.model.decode_ar(jax.tree.map(jnp.asarray, tree), jnp.asarray(ctx))
    _, model = _port(parti_run, tree)
    with torch.inference_mode():
        return np.asarray(gold), model.decode_ar(_t(ctx)).numpy()


def test_position_embedding_lags_one_step(parti_run):
    """With large, distinct position rows the position decides the tokens:
    the port's ``pos[max(t - 1, 0)]`` gives the reference's tokens, and
    ``pos[t]`` (rows shifted by one) does not."""
    tree = {k: v for k, v in parti_run["tree"].items()}
    pos = 3.0 * np.random.default_rng(7).standard_normal(tree["pos"].shape)
    tree["pos"] = pos.astype(np.float32)
    gold, out = _decode_ar_both(parti_run, tree)
    np.testing.assert_array_equal(out, gold)
    tree["pos"] = np.concatenate([pos[1:], pos[-1:]]).astype(np.float32)  # step t reads pos[t]
    _, shifted = _decode_ar_both(parti_run, tree)
    assert (shifted != gold).any()


def test_tied_logits_decode_to_the_first_index(parti_run):
    """A zero head ties every logit at every step: both packages take index
    0 (``jnp.argmax`` and ``torch.argmax`` give the first maximum)."""
    tree = {k: v for k, v in parti_run["tree"].items()}
    tree["head"] = {"kernel": np.zeros_like(tree["head"]["kernel"])}
    gold, out = _decode_ar_both(parti_run, tree)
    np.testing.assert_array_equal(gold, np.zeros((2, 16)))
    np.testing.assert_array_equal(out, gold)


def _jax_ar_step(model, params, ctx, prev, t, caches):
    """One step of the reference's ``decode_ar`` loop (its ``step`` body)."""
    c = model.cfg
    xa = model.block._cross_attn()
    x = model._embed()(params["embed"], prev)
    x = x + params["pos"][max(t - 1, 0)].astype(x.dtype)[None]
    for i in range(c.n_layers):
        lp = params[f"layer{i}"]
        cc = JCache(k=xa._split_heads(xa._wk()(lp["cross_attn"]["wk"], ctx), c.n_heads),
                    v=xa._split_heads(xa._wv()(lp["cross_attn"]["wv"], ctx), c.n_heads))
        x, _ = model.block.decode(lp, x, caches[i], jnp.int32(t), cross_cache=cc)
    return model._head()(params["head"], model._final_ln()(params["final_ln"], x))[:, 0]


def test_bf16_decode_step_matches_jax(parti_run):
    """``with_dtype(..., bf16)`` field for field, and the first decode step's
    logits of the bf16 reduced model in both packages (bf16 weights, bf16
    cache) within 2e-2."""
    jcfg = j_suite.with_dtype(parti_run["jwl"].cfg, jnp.bfloat16)
    tcfg = t_suite.with_dtype(reduced_workload(get_config("parti")).cfg, torch.bfloat16)
    assert _plain(tcfg) == _plain(jcfg)
    assert tcfg.text.dtype == tcfg.vq.decoder.dtype == torch.bfloat16
    jwl, twl = j_workload_for(jcfg), workload_for(tcfg)
    params = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), parti_run["tree"])
    model = twl.load({k: v.to(torch.bfloat16) for k, v in parti_run["state"].items()}, "cpu")
    rng = np.random.default_rng(8)
    ctx = rng.standard_normal((2, 7, 64)).astype(np.float32)
    prev = np.zeros((2, 1), np.int32)
    caches = [{"attn": jwl.model.block._attn().init_cache(2, 16, dtype=jnp.bfloat16)}
              for _ in range(jcfg.n_layers)]
    gold = _jax_ar_step(jwl.model, params, jnp.asarray(ctx).astype(jnp.bfloat16),
                        jnp.asarray(prev), 0, caches)
    with torch.inference_mode():
        tc, tcross = model.ar_init(_t(ctx).to(torch.bfloat16))
        out = model.ar_step(torch.zeros((2, 1), dtype=torch.int64), 0, tc, tcross)
    assert out.dtype == torch.bfloat16 and tc[0]["attn"].k.dtype == torch.bfloat16
    _close_to_scale(out.float().numpy(), np.asarray(gold.astype(jnp.float32)), BF16)


def test_parti_config_matches_jax():
    assert _plain(t_suite.PARTI) == _plain(j_get_config("parti"))
    assert get_config("parti") is t_suite.PARTI
    assert _plain(reduced_workload(t_suite.PARTI).cfg) == _plain(
        j_reduced_workload(j_get_config("parti")).cfg)
    stages = workload_for(t_suite.PARTI).cost_descriptor().stages
    assert [(s.name, s.steps, s.seq_len) for s in stages] == [
        ("text_encoder", 1, 128), ("ar_decode", 1024, 1024), ("vq_decoder", 1, 1024)]


def test_full_size_params_bridge_without_transpose():
    """At the full Parti config the port's parameter names and shapes are
    the JAX tree's (abstract on both sides: nothing is allocated)."""
    jwl = j_workload_for(j_get_config("parti"))
    abstract = jax.eval_shape(jwl.init, jax.random.PRNGKey(0))
    j_shapes = {k: tuple(v.shape) for k, v in flatten_tree(abstract).items()}
    t_defs = param_defs(workload_for(get_config("parti")).model)
    assert {k: d.shape for k, d in t_defs.items()} == j_shapes
    assert round(sum(int(np.prod(s)) for s in j_shapes.values()) / 1e6, 1) == 21907.9
    assert t_defs["layer79.mlp.wi.kernel"].shape == (4096, 16384)
