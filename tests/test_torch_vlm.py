"""Parity of the port's VLM family (``qwen2-vl-2b``) with the JAX package.

What it adds to the dense LMs: M-RoPE, whose D/2 frequency channels split
into (temporal, height, width) sections, each rotated by its own position
stream, and embedding inputs (the stub ViT frontend: precomputed patch and
text embeddings with (3, B, S) streams).  On token prompts the three streams
are equal, so the LM workload runs it as the dense LMs, and a decode step
rotates at ``cur_len`` in all three streams, as the reference's does.

The reduced config (4 layers of d 64, GQA 4:1 of 16, sections (2, 3, 3))
runs in both packages on one seeded parameter tree bridged unchanged (every
bias and norm leaf drawn away from its init).  The reference's prefill runs
on the ``interpret`` tier, jitted once, its decode step jitted once, its
``generate`` eagerly as the dense LM files run it.  Tolerances are the
reference's: 2e-5 for one layer, 1e-4 for a whole chain (relative to the
output's scale).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models.layers import rope as j_rope
from repro.workload import workload_for as j_workload_for
from repro_torch.configs import get_config, reduced
from repro_torch.models.layers import rope as t_rope
from repro_torch.nn import from_jax_params, init_params, materialize, param_defs
from repro_torch.nn.module import flatten_tree
from repro_torch.workload import reduced_workload, workload_for
from test_torch_encdec import reference_tree

ARCH = "qwen2-vl-2b"
LAYER = dict(rtol=2e-5, atol=2e-5)
CHAIN = dict(rtol=1e-4, atol=1e-4)
PROMPT, NEW = 12, 4


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


def image_prompt_positions(text: int, grid: int, tail: int, batch: int = 2) -> np.ndarray:
    """(3, batch, S) M-RoPE streams of a prompt laid out as Qwen2-VL lays out
    an image (arXiv:2409.12191 §2.1): ``text`` tokens at 0.. in all streams,
    a ``grid`` x ``grid`` patch grid at t = ``text``, h = ``text`` + row,
    w = ``text`` + col, then ``tail`` text tokens from the grid's largest
    position + 1 on."""
    t0 = np.arange(text)
    row, col = np.divmod(np.arange(grid * grid), grid)
    t1 = np.arange(tail) + text + grid
    streams = [np.concatenate([t0, np.full(grid * grid, text), t1]),
               np.concatenate([t0, text + row, t1]), np.concatenate([t0, text + col, t1])]
    return np.broadcast_to(np.stack(streams)[:, None], (3, batch, text + grid * grid + tail)
                           ).astype(np.int32)


@pytest.fixture(scope="module")
def run():
    """Reduced qwen2-vl-2b on one seeded tree, with the reference's outputs
    computed once: a prefill on embeddings (2, 12, 64) with image-prompt
    M-RoPE streams (2 text tokens, a 3 x 3 grid, 1 text token) padded to 16
    rows, 4 decode steps on (2, 1, 64) embeddings, the forward over all 16
    embeddings with the streams the decode steps rotate at (``cur_len`` in
    all three), and the interpret-tier ``generate`` of 2 token prompts (16
    tokens, 4 new)."""
    jcfg = j_reduced(j_get_config(ARCH))
    jwl = j_workload_for(jcfg)
    jm = jwl.model
    abstract = jax.eval_shape(jwl.init, jax.random.PRNGKey(0))
    tree = reference_tree(abstract, init_params(reduced_workload(get_config(ARCH)).model, 0))
    params = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((2, PROMPT + NEW, 64)).astype(np.float32)
    mrope = image_prompt_positions(2, 3, 1)
    logits, caches, _ = jax.jit(jm.prefill, static_argnames=("impl", "max_len"))(
        params, None, embeds=jnp.asarray(emb[:, :PROMPT]), mrope_positions=jnp.asarray(mrope),
        impl="interpret", max_len=PROMPT + NEW)
    prefill = dict(logits=np.asarray(logits), caches=jax.tree.map(np.asarray, caches))
    decode = jax.jit(lambda p, e, c, cur: jm.decode_step(p, e, c, cur))
    step_logits = []
    for i in range(NEW):
        lg, caches = decode(params, jnp.asarray(emb[:, PROMPT + i:PROMPT + i + 1]), caches,
                            jnp.int32(PROMPT + i))
        step_logits.append(np.asarray(lg))
    tail = np.broadcast_to(np.arange(PROMPT, PROMPT + NEW, dtype=np.int32), (3, 2, NEW))
    full_pos = np.concatenate([mrope, tail], axis=2)
    full, _ = jax.jit(jm.forward, static_argnames="impl")(
        params, None, embeds=jnp.asarray(emb), mrope_positions=jnp.asarray(full_pos),
        impl="interpret")
    tokens = rng.integers(0, 256, (2, 16)).astype(np.int32)
    gen = np.asarray(jwl.generate(params, jnp.asarray(tokens), jax.random.PRNGKey(0),
                                  impl="interpret", max_new_tokens=NEW))
    return dict(abstract=abstract, state=from_jax_params(tree), emb=emb, mrope=mrope,
                full_pos=full_pos, prefill=prefill, step_logits=step_logits,
                caches=jax.tree.map(np.asarray, caches), full=np.asarray(full),
                tokens=tokens, out=gen)


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
    assert reduced(cfg).mrope_sections == (2, 3, 3) and reduced(cfg).n_kv_heads == 1
    assert cfg.param_count() == jcfg.param_count()


def test_full_width_leaves_are_the_references():
    """Keys and shapes of the port's declared leaves (on ``meta``) equal the
    reference's abstract tree: 28 dense layers with QKV bias, a tied head;
    without the norms and biases they count the reference's
    ``param_count()``, 1.54 B."""
    jcfg = j_get_config(ARCH)
    abstract = jax.eval_shape(j_workload_for(jcfg).init, jax.random.PRNGKey(0))
    j_shapes = {k: tuple(v.shape) for k, v in flatten_tree(abstract).items()}
    model = workload_for(get_config(ARCH)).model
    t_defs = param_defs(model)
    assert {k: d.shape for k, d in t_defs.items()} == j_shapes
    assert all(p.device.type == "meta" for p in model.parameters())
    assert t_defs["blocks.g0_dense.attn.wk.kernel"].shape == (28, 1536, 256)
    assert not any(k.startswith("lm_head") for k in t_defs)
    n = {k: int(np.prod(d.shape)) for k, d in t_defs.items()}
    assert sum(v for k, v in n.items() if not k.endswith(("bias", "scale"))) == (
        jcfg.param_count())
    assert round(jcfg.param_count() / 1e9, 2) == 1.54


def test_reduced_leaves_bridge_exactly(run):
    model = reduced_workload(get_config(ARCH)).model
    assert set(run["state"]) == set(param_defs(model)) == set(flatten_tree(run["abstract"]))
    materialize(model, run["state"], "cpu")


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D,sections,base", [(128, (16, 24, 24), 1e6), (16, (2, 3, 3), 1e4)])
def test_mrope_with_distinct_streams_matches_jax(D, sections, base):
    """An image prompt's three distinct streams (text, then an 8 x 8 grid of
    merged patches, then text, as ``chip_smoke.py``'s ``[mrope]`` phase lays
    out a 32 x 32 grid at full width), on two heads."""
    rng = np.random.default_rng(7)
    pos = image_prompt_positions(4, 8, 4)
    x = rng.standard_normal((2, pos.shape[2], 2, D)).astype(np.float32)
    gold = j_rope.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, base=base)
    out = t_rope.apply_mrope(_t(x), _t(pos), sections, base=base)
    _close_to_scale(out.numpy(), gold, LAYER)
    text = t_rope.apply_rope(_t(x), _t(pos[0]), base=base)  # the temporal stream alone
    assert not torch.allclose(out, text, atol=1e-3)


def test_text_mrope_is_rope_and_matches_jax():
    """Three equal streams (``text_mrope_positions``): M-RoPE is RoPE, bit
    for bit in the port, and the reference's within the fp32 tolerance."""
    rng = np.random.default_rng(8)
    pos = np.stack([np.arange(6), np.array([0, 9, 100, 2047, 2063, 40000])]).astype(np.int32)
    x = rng.standard_normal((2, 6, 3, 128)).astype(np.float32)
    streams = t_rope.text_mrope_positions(_t(pos))
    assert tuple(streams.shape) == (3, 2, 6)
    np.testing.assert_array_equal(streams.numpy(), np.asarray(
        j_rope.text_mrope_positions(jnp.asarray(pos))))
    out = t_rope.apply_mrope(_t(x), streams, (16, 24, 24), base=1e6)
    assert torch.equal(out, t_rope.apply_rope(_t(x), _t(pos), base=1e6))
    gold = j_rope.apply_mrope(jnp.asarray(x), j_rope.text_mrope_positions(jnp.asarray(pos)),
                              (16, 24, 24), base=1e6)
    _close_to_scale(out.numpy(), gold, LAYER)
    with pytest.raises(ValueError, match="sum to"):
        t_rope.apply_mrope(_t(x), streams, (16, 24, 23))


# ---------------------------------------------------------------------------
# The reduced model: embeddings with M-RoPE streams, decode, generate
# ---------------------------------------------------------------------------


def test_prefill_on_embeds_with_mrope_streams_matches_jax(run):
    """Logits and the caches (rotated keys, padded to 16 rows)."""
    _, model = _port(run)
    gold = run["prefill"]
    with torch.inference_mode():
        logits, caches, context = model.prefill(embeds=_t(run["emb"][:, :PROMPT]),
                                                mrope_positions=_t(run["mrope"]),
                                                impl="kernel", max_len=PROMPT + NEW)
    assert context is None and tuple(logits.shape) == (2, 1, 256)
    _close_to_scale(logits.numpy(), gold["logits"])
    assert tuple(caches[0]["attn"].k.shape) == (4, 2, PROMPT + NEW, 1, 16)
    _close_to_scale(caches[0]["attn"].k.numpy(), gold["caches"][0]["attn"].k)
    _close_to_scale(caches[0]["attn"].v.numpy(), gold["caches"][0]["attn"].v)


def test_decode_on_embeddings_matches_jax(run):
    """4 decode steps on (2, 1, 64) embeddings at ``cur_len``: each step's
    logits, then the caches."""
    _, model = _port(run)
    emb = _t(run["emb"])
    with torch.inference_mode():
        _, caches, _ = model.prefill(embeds=emb[:, :PROMPT], mrope_positions=_t(run["mrope"]),
                                     max_len=PROMPT + NEW)
        for i in range(NEW):
            lg, caches = model.decode_step(emb[:, PROMPT + i:PROMPT + i + 1], caches, PROMPT + i)
            _close_to_scale(lg.numpy(), run["step_logits"][i])
    _close_to_scale(caches[0]["attn"].k.numpy(), run["caches"][0]["attn"].k)
    _close_to_scale(caches[0]["attn"].v.numpy(), run["caches"][0]["attn"].v)


def test_prefill_then_decode_equals_full_forward_in_both_packages(run):
    """The forward over all 16 embeddings with the streams the decode steps
    rotate at equals the prefill's last logits and each decode step's, in
    both packages (within 1e-4); the port's forward equals the
    reference's."""
    j_errs = [np.abs(run["prefill"]["logits"][:, 0] - run["full"][:, PROMPT - 1]).max()] + [
        np.abs(lg[:, 0] - run["full"][:, PROMPT + i]).max()
        for i, lg in enumerate(run["step_logits"])]
    assert max(j_errs) < 1e-4, j_errs
    _, model = _port(run)
    emb = _t(run["emb"])
    with torch.inference_mode():
        full = model(embeds=emb, mrope_positions=_t(run["full_pos"]), impl="kernel")
        last, caches, _ = model.prefill(embeds=emb[:, :PROMPT], mrope_positions=_t(run["mrope"]),
                                        max_len=PROMPT + NEW)
        errs = [(last[:, 0] - full[:, PROMPT - 1]).abs().max().item()]
        for i in range(NEW):
            lg, caches = model.decode_step(emb[:, PROMPT + i:PROMPT + i + 1], caches, PROMPT + i)
            errs.append((lg[:, 0] - full[:, PROMPT + i]).abs().max().item())
    assert max(errs) < 1e-4, errs
    _close_to_scale(full.numpy(), run["full"])


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_reduced_generate_on_token_prompts_equals_jax(run, impl):
    """The LM workload on token prompts (three equal streams): greedy tokens
    equal the reference's live output."""
    twl, model = _port(run)
    out = twl.generate(model, run["tokens"], 0, impl=impl, device="cpu", max_new_tokens=NEW)
    assert tuple(out.shape) == run["out"].shape == (2, NEW)
    np.testing.assert_array_equal(out.numpy(), run["out"])


def test_launcher_serves_the_reduced_vlm(capsys):
    """``python -m repro_torch.launch.serve --arch qwen2-vl-2b --reduced``
    serves token prompts on the lm route."""
    from repro_torch.launch import serve as launcher

    results = launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "2",
                             "--max-new", "4"])
    out = capsys.readouterr().out
    assert sorted(results) == [0, 1] and all(len(v) == 4 for v in results.values())
    assert f"arch {ARCH}-reduced | route lm | stages prefillx1 -> decodex64" in out
