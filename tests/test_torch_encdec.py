"""Parity of the port's enc-dec family (``whisper-base``) with the JAX package.

What it adds to the dense LMs: an encoder of non-causal dense blocks with
RoPE off over precomputed frame embeddings (the stub frontend), a decoder
that adds sinusoidal positions to its input and cross-attends to the
encoder's output in every layer, and a decode step that projects each
layer's cross K/V from that context anew.  The reference's LM workload
cannot run it (its stages carry no frame embeddings), so it runs through the
model's entry points and ``launch/steps.py``, as there.

The reduced config (2 encoder and 4 decoder layers of d 64, 4 heads of 16)
runs in both packages on one seeded parameter tree, handed to JAX in its own
structure and bridged unchanged into the port; every bias and norm leaf is drawn away
from its init so that none is trivial.  JAX runs its prefill on the
``interpret`` tier (the Pallas flash-attention kernel in interpret mode),
jitted once, and its decode step jitted once.  Tolerances are the
reference's: 2e-5 for one layer, 1e-4 for a whole chain (relative to the
output's scale).  ``input_specs`` of both LM families are held to the
reference's here too.  The full-width event streams are in
``tests/test_torch_trace_parity_encdec_vlm.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.launch import steps as j_steps
from repro.launch.mesh import make_debug_mesh
from repro.models.layers import attention as j_attention
from repro.models.layers import basic as j_basic
from repro.workload import workload_for as j_workload_for
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import SHAPES
from repro_torch.launch import steps
from repro_torch.models.layers import attention as t_attention
from repro_torch.models.layers import basic as t_basic
from repro_torch.nn import from_jax_params, init_params, materialize, param_defs
from repro_torch.nn.module import flatten_tree
from repro_torch.workload import reduced_workload, workload_for

ARCH = "whisper-base"
LAYER = dict(rtol=2e-5, atol=2e-5)
CHAIN = dict(rtol=1e-4, atol=1e-4)
FRAMES, PROMPT, NEW = 24, 8, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's reduced model: under several
    test workers, 8 threads a worker oversubscribe the cores.  Restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(v):
    """A config as nested plain values; an encoder's ``enc_len`` (a
    function) is compared by calling it."""
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name)) for f in dataclasses.fields(v)
                if f.name not in ("dtype", "enc_len")}
    return tuple(map(_plain, v)) if isinstance(v, tuple) else v


def _close_to_scale(out, gold, tol=CHAIN):
    """|out - gold| <= atol * max(1, max|gold|) + rtol * |gold|."""
    gold = np.asarray(gold, np.float32)
    scale = max(1.0, float(np.abs(gold).max()))
    np.testing.assert_allclose(np.asarray(out, np.float32), gold, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _t(a):
    return torch.from_numpy(np.array(a))


def reference_tree(abstract: dict, state: dict, seed: int = 3, path: str = "") -> dict:
    """The port's seeded values in the reference's tree structure, every
    norm scale drawn around 1 and every bias around 0 (a stacked leaf layer
    by layer alike), so that no leaf is trivial."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in abstract.items():
        key = f"{path}.{k}" if path else k
        if isinstance(v, dict):
            out[k] = reference_tree(v, state, seed + len(out) + 1, key)
        elif k in ("scale", "bias"):
            draw = 0.1 * rng.standard_normal(tuple(v.shape))
            out[k] = (draw + (k == "scale")).astype(np.float32)
        else:
            out[k] = state[key].numpy()
    return out


@pytest.fixture(scope="module")
def run():
    """Reduced whisper-base on one seeded tree, with the reference's outputs
    computed once: frame embeddings (2, 24, 64), an 8-token decoder prompt;
    the encoder's context, the prefill's logits and caches (capacity 12),
    4 greedy decode steps' logits and tokens, and the forward over the
    prompt and those tokens."""
    jcfg = j_reduced(j_get_config(ARCH))
    jwl = j_workload_for(jcfg)
    jm = jwl.model
    abstract = jax.eval_shape(jwl.init, jax.random.PRNGKey(0))
    tree = reference_tree(abstract, init_params(reduced_workload(get_config(ARCH)).model, 0))
    params = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((2, FRAMES, 64)).astype(np.float32)
    toks = rng.integers(0, 256, (2, PROMPT)).astype(np.int32)
    context = jax.jit(jm.encode, static_argnames="impl")(params, jnp.asarray(enc),
                                                         impl="interpret")
    logits, caches, ctx = jax.jit(jm.prefill, static_argnames=("impl", "max_len"))(
        params, jnp.asarray(toks), enc_embeds=jnp.asarray(enc), impl="interpret",
        max_len=PROMPT + NEW)
    prefill = dict(logits=np.asarray(logits), caches=jax.tree.map(np.asarray, caches),
                   context=np.asarray(ctx))
    serve = jax.jit(j_steps.make_serve_step(jm, jcfg, None, impl="interpret"))
    nxt = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    step_logits, out = [], []
    for i in range(NEW):
        out.append(np.asarray(nxt))
        lg, caches = serve(params, nxt, caches, jnp.int32(PROMPT + i), ctx)
        step_logits.append(np.asarray(lg))
        nxt = jnp.argmax(lg[:, 0], -1).astype(jnp.int32)[:, None]
    out = np.concatenate(out, 1)
    full, _ = jax.jit(jm.forward, static_argnames="impl")(
        params, jnp.asarray(np.concatenate([toks, out], 1)), enc_embeds=jnp.asarray(enc),
        impl="interpret")
    return dict(jwl=jwl, abstract=abstract, params=params, state=from_jax_params(tree),
                enc=enc, toks=toks, encoded=np.asarray(context), prefill=prefill,
                step_logits=step_logits, out=out, full=np.asarray(full),
                caches=jax.tree.map(np.asarray, caches))


def _port(run):
    twl = reduced_workload(get_config(ARCH))
    return twl, twl.load(run["state"], device="cpu")


# ---------------------------------------------------------------------------
# Configs, leaves, the bridge
# ---------------------------------------------------------------------------


def test_config_and_its_reduction_match_the_reference():
    cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    assert _plain(cfg) == _plain(jcfg)
    assert cfg.dtype == torch.float32 and cfg.source == jcfg.source and cfg.source
    assert _plain(reduced(cfg)) == _plain(j_reduced(jcfg))
    assert _plain(workload_for(cfg).reduced()) == _plain(j_reduced(jcfg))
    assert reduced(cfg).encoder.n_layers == j_reduced(jcfg).encoder.n_layers == 2
    for enc in (cfg.encoder, reduced(cfg).encoder):
        assert [enc.enc_len(s) for s in (1, 187, 1500)] == [
            jcfg.encoder.enc_len(s) for s in (1, 187, 1500)] == [1, 187, 1500]
    assert cfg.param_count() == jcfg.param_count()
    assert reduced(cfg).param_count() == j_reduced(jcfg).param_count()


def test_full_width_leaves_are_the_references():
    """Keys and shapes of the port's declared leaves (on ``meta``) equal the
    reference's abstract tree: the 6 encoder layers stacked under
    ``encoder.blocks``, ``encoder.final_norm``, the decoder's stacked
    ``cross_attn`` and ``norm_cross``; no ``lm_head`` (tied).  Without the
    norms and biases they count the reference's ``param_count()``."""
    jcfg = j_get_config(ARCH)
    abstract = jax.eval_shape(j_workload_for(jcfg).init, jax.random.PRNGKey(0))
    j_shapes = {k: tuple(v.shape) for k, v in flatten_tree(abstract).items()}
    model = workload_for(get_config(ARCH)).model
    t_defs = param_defs(model)
    assert {k: d.shape for k, d in t_defs.items()} == j_shapes
    assert all(p.device.type == "meta" for p in model.parameters())
    assert t_defs["encoder.blocks.attn.wq.kernel"].shape == (6, 512, 512)
    assert t_defs["encoder.final_norm.scale"].shape == (512,)
    assert t_defs["blocks.g0_dense.cross_attn.wk.bias"].shape == (6, 512)
    assert t_defs["blocks.g0_dense.norm_cross.bias"].shape == (6, 512)
    assert not any(k.startswith("lm_head") for k in t_defs)
    n = {k: int(np.prod(d.shape)) for k, d in t_defs.items()}
    assert round(sum(n.values()) / 1e6, 1) == 70.7
    assert sum(v for k, v in n.items() if not k.endswith(("bias", "scale"))) == (
        jcfg.param_count())


def test_reduced_leaves_bridge_exactly(run):
    """The bridged state has exactly the port's keys: ``materialize`` raises
    on a missing or extra leaf."""
    model = reduced_workload(get_config(ARCH)).model
    assert set(run["state"]) == set(param_defs(model)) == set(flatten_tree(run["abstract"]))
    materialize(model, run["state"], "cpu")


# ---------------------------------------------------------------------------
# Layers: the decoder's positions, cross-attention decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [512, 63])
def test_sinusoidal_embedding_matches_jax(dim):
    """At the decoder's positions, a prompt of 187 then decode positions up
    to whisper's 448: cos before sin, a zero column where ``dim`` is odd."""
    pos = np.concatenate([np.arange(187), [187, 250, 447]]).astype(np.int32)[None]
    gold = j_basic.sinusoidal_embedding(jnp.asarray(pos), dim)
    out = t_basic.sinusoidal_embedding(_t(pos), dim)
    assert tuple(out.shape) == tuple(gold.shape) == (1, 190, dim)
    _close_to_scale(out.numpy(), gold, LAYER)
    if dim % 2:
        assert not out[..., -1].any()


@pytest.mark.parametrize("cross_len", [None, 7, "per-request"])
def test_cross_attention_decode_takes_cross_len(cross_len):
    """A cross-attention decode attends to the first ``cross_len`` rows of
    its cross cache (all of them by default), the cache it was given left as
    it is."""
    rng = np.random.default_rng(5)
    jattn = j_attention.Attention(64, 4, 4, 16, qkv_bias=True, rope=False, cross=True,
                                  causal=False, name="cross_attn")
    tattn = t_attention.Attention(64, 4, 16, n_kv_heads=4, qkv_bias=True, cross=True,
                                  name="cross_attn")
    jp = {name: {leaf: (0.2 * rng.standard_normal(s)).astype(np.float32)
                 for leaf, s in (("kernel", (64, 64)), ("bias", (64,)))}
          for name in ("wq", "wk", "wv", "wo")}
    jp["wo"] = {"kernel": jp["wo"]["kernel"]}
    tattn = materialize(tattn, from_jax_params(jp), "cpu")
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    k, v = rng.standard_normal((2, 2, 12, 4, 16)).astype(np.float32)
    lens = {None: None, 7: 7, "per-request": np.array([12, 3], np.int32)}[cross_len]
    gold, _ = jattn.decode(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), None, jnp.int32(0),
                           cross_cache=j_attention.AttentionCache(jnp.asarray(k), jnp.asarray(v)),
                           cross_len=None if lens is None else jnp.asarray(lens))
    out, cache = tattn.decode(_t(x), None, 0, cross_cache=t_attention.AttentionCache(_t(k), _t(v)),
                              cross_len=_t(lens) if isinstance(lens, np.ndarray) else lens)
    assert cache is None
    _close_to_scale(out.numpy(), gold, LAYER)


# ---------------------------------------------------------------------------
# The reduced model: encode, prefill, decode, the steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_encode_matches_jax(run, impl):
    _, model = _port(run)
    with torch.inference_mode():
        out = model.encode(_t(run["enc"]), impl=impl)
    assert tuple(out.shape) == (2, FRAMES, 64)
    _close_to_scale(out.numpy(), run["encoded"])


def test_prefill_logits_caches_and_context_match_jax(run):
    """The last position's logits, the 4 decoder layers' self-attention
    caches padded to 12 rows, and the context."""
    _, model = _port(run)
    gold = run["prefill"]
    with torch.inference_mode():
        logits, caches, context = model.prefill(_t(run["toks"]).long(),
                                                enc_embeds=_t(run["enc"]), impl="kernel",
                                                max_len=PROMPT + NEW)
    assert tuple(logits.shape) == (2, 1, 256)
    _close_to_scale(logits.numpy(), gold["logits"])
    _close_to_scale(context.numpy(), gold["context"])
    (key, kv), = caches[0].items()
    assert key == "attn" and tuple(kv.k.shape) == (4, 2, PROMPT + NEW, 4, 16)
    _close_to_scale(kv.k.numpy(), gold["caches"][0]["attn"].k)
    _close_to_scale(kv.v.numpy(), gold["caches"][0]["attn"].v)


def test_decode_steps_with_context_match_jax(run):
    """4 decode steps fed the reference's greedy tokens, attending to the
    context: each step's logits, then the caches after them."""
    _, model = _port(run)
    with torch.inference_mode():
        _, caches, context = model.prefill(_t(run["toks"]).long(), enc_embeds=_t(run["enc"]),
                                           max_len=PROMPT + NEW)
        for i in range(NEW):
            lg, caches = model.decode_step(_t(run["out"][:, i:i + 1]).long(), caches, PROMPT + i,
                                           context=context)
            _close_to_scale(lg.numpy(), run["step_logits"][i])
    _close_to_scale(caches[0]["attn"].k.numpy(), run["caches"][0]["attn"].k)
    _close_to_scale(caches[0]["attn"].v.numpy(), run["caches"][0]["attn"].v)


def test_prefill_then_decode_equals_full_forward_in_both_packages(run):
    """The reference's ``test_decode_matches_forward`` on both packages:
    the prefill's last logits and each decode step's equal the forward over
    the prompt and the decoded tokens (within 1e-4); the port's forward
    equals the reference's."""
    _, model = _port(run)
    full_j = run["full"]
    j_errs = [np.abs(run["prefill"]["logits"][:, 0] - full_j[:, PROMPT - 1]).max()] + [
        np.abs(lg[:, 0] - full_j[:, PROMPT + i]).max() for i, lg in enumerate(run["step_logits"])]
    assert max(j_errs) < 1e-4, j_errs
    toks = _t(np.concatenate([run["toks"], run["out"]], 1)).long()
    with torch.inference_mode():
        full = model(toks, enc_embeds=_t(run["enc"]), impl="kernel")
        last, caches, ctx = model.prefill(toks[:, :PROMPT], enc_embeds=_t(run["enc"]),
                                          max_len=PROMPT + NEW)
        errs = [(last[:, 0] - full[:, PROMPT - 1]).abs().max().item()]
        for i in range(NEW):
            lg, caches = model.decode_step(toks[:, PROMPT + i:PROMPT + i + 1], caches,
                                           PROMPT + i, context=ctx)
            errs.append((lg[:, 0] - full[:, PROMPT + i]).abs().max().item())
    assert max(errs) < 1e-4, errs
    _close_to_scale(full.numpy(), full_j)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_greedy_tokens_through_the_steps_equal_jax(run, impl):
    """``launch/steps.py``'s prefill and serve steps, greedy: the tokens
    equal the reference's, decoded through its own serve step."""
    cfg = reduced(get_config(ARCH))
    _, model = _port(run)
    prefill = steps.make_prefill_step(model, cfg, impl=impl, max_len=PROMPT + NEW)
    serve = steps.make_serve_step(model, cfg, impl=impl)
    out = []
    with torch.inference_mode():
        logits, caches, context = prefill(dict(tokens=_t(run["toks"]), enc_embeds=_t(run["enc"])))
        nxt = logits[:, -1].argmax(-1)[:, None]
        for i in range(NEW):
            out.append(nxt)
            logits, caches = serve(nxt, caches, PROMPT + i, context=context)
            nxt = logits[:, 0].argmax(-1)[:, None]
    np.testing.assert_array_equal(torch.cat(out, 1).numpy(), run["out"])


def test_workload_refuses_generate_where_the_reference_fails(run):
    """The LM workload's stages carry no frame embeddings: the reference's
    ``generate`` fails in its encoder, the port's prefill stage raises.
    ``workload_for``, ``cost_descriptor`` and ``prepare_request`` work as
    there."""
    twl, model = _port(run)
    jwl = run["jwl"]
    with pytest.raises(AttributeError):
        jwl.generate(run["params"], jnp.asarray(run["toks"]), jax.random.PRNGKey(0),
                     max_new_tokens=2)
    with pytest.raises(ValueError, match="carry no enc_embeds"):
        twl.generate(model, run["toks"], 0, device="cpu", max_new_tokens=2)
    for t, j in ((workload_for(get_config(ARCH)), j_workload_for(j_get_config(ARCH))),
                 (twl, jwl)):
        tcd, jcd = t.cost_descriptor(), j.cost_descriptor()
        assert (tcd.arch, tcd.route) == (jcd.arch, jcd.route)
        assert [dataclasses.astuple(s) for s in tcd.stages] == [
            dataclasses.astuple(s) for s in jcd.stages]
        tr, jr = t.prepare_request(1, [3, 4], max_new_tokens=2), j.prepare_request(
            1, [3, 4], max_new_tokens=2)
        assert (tr.rid, tr.modality, tr.route, tr.max_new_tokens) == (
            jr.rid, jr.modality, jr.route, jr.max_new_tokens)


@pytest.mark.parametrize("arch", [ARCH, "qwen2-vl-2b", "olmo-1b"])
def test_input_specs_are_the_references(arch):
    """Names, shapes and dtypes of each shape kind's inputs, on ``meta``:
    the reference's abstract batch with its shardings left out."""
    mesh = make_debug_mesh(1, 1)
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name, shape in SHAPES.items():
        got = steps.input_specs(cfg, shape)
        want, _ = j_steps.input_specs(jcfg, J_SHAPES[name], mesh)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in got.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}, name
        assert all(v.device.type == "meta" for v in got.values())
    assert steps.dec_len_for(cfg, 1500) == j_steps.dec_len_for(jcfg, 1500) == 187
    assert steps.dec_len_for(cfg, 100) == j_steps.dec_len_for(jcfg, 100) == 64
