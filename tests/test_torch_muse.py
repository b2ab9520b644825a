"""Parity of the port's Muse slice (masked-transformer text-to-image:
parallel decoding, then a VQ-GAN decoder) with the JAX package, and of the
one MaskGIT rule the port writes for Muse and Phenaki.

``reduced_workload(get_config("muse"))`` (2 layers of d 64, 16 image
tokens, 3 unmasking steps) runs in both packages on one seeded parameter
tree, handed to JAX as is and bridged unchanged into the port.  The JAX side
runs ``generate`` on the ``interpret`` tier (Pallas kernels in interpret
mode); the port runs ``generate`` on both its tiers on the CPU.  The decode
is deterministic (greedy argmax, confidence-ranked unmasking), so the
tokens must be equal; at this size the smallest argmax margin and the
smallest gap at an unmasking cutoff are far above the float differences.

Tolerances are the reference's: 2e-5 for one layer, 1e-4 for a whole chain
(the backbone's logits, the VQ-GAN decoder's image), relative to the
output's scale as in ``tests/test_torch_ttv.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.suite  # noqa: F401  (registers the suite)
from repro.configs import get_config as j_get_config
from repro.models import ar_image as j_ar
from repro.models import transformer as j_transformer
from repro.models import vae as j_vae
from repro.workload import reduced_workload as j_reduced_workload
from repro.workload import workload_for as j_workload_for
from repro_torch.configs import get_config
from repro_torch.configs import suite as t_suite
from repro_torch.models import ar_image as t_ar
from repro_torch.models import transformer as t_transformer
from repro_torch.models import vae as t_vae
from repro_torch.nn import from_jax_params, init_params, materialize, param_defs
from repro_torch.nn.module import flatten_tree
from repro_torch.workload import reduced_workload, workload_for

LAYER = dict(rtol=2e-5, atol=2e-5)
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


def _close_to_scale(out, gold, tol=CHAIN):
    """|out - gold| <= atol * max(1, max|gold|) + rtol * |gold|."""
    gold = np.asarray(gold)
    scale = max(1.0, float(np.abs(gold).max()))
    np.testing.assert_allclose(np.asarray(out), gold, rtol=tol["rtol"], atol=tol["atol"] * scale)


def _capture_states(wl, states: dict):
    """Wrap ``wl.run_stage`` (either package's) to keep each stage's output."""
    run = wl.run_stage

    def run_stage(params, stage, *a, **k):
        states[stage.name] = run(params, stage, *a, **k)
        return states[stage.name]

    wl.run_stage = run_stage


def _backbone_inputs(cfg, seed=1):
    """Two token rows, all masks (a first step) and half the positions
    unmasked from a seeded draw, and a projected text context."""
    rng = np.random.default_rng(seed)
    S, mask = cfg.image_tokens, cfg.image_vocab
    half = np.where(rng.random(S) < 0.5, rng.integers(0, mask, S), mask)
    tokens = np.stack([np.full(S, mask), half]).astype(np.int32)
    ctx = rng.standard_normal((2, cfg.text.max_len, cfg.d_model)).astype(np.float32)
    return tokens, ctx


@pytest.fixture(scope="module")
def muse_run():
    """JAX reduced Muse: params, tokens, its interpret-tier generate with the
    decoded image tokens, computed once for the module."""
    jwl = j_reduced_workload(j_get_config("muse"))
    # seeded values in the port's init families, handed to both packages
    tree = _tree(init_params(reduced_workload(get_config("muse")).model, 0))
    params = jax.tree.map(jnp.asarray, tree)
    tokens = np.random.default_rng(0).integers(
        0, jwl.cfg.text.vocab, (2, jwl.cfg.text.max_len)).astype(np.int32)
    states = {}
    _capture_states(jwl, states)
    out = np.asarray(jwl.generate(params, jnp.asarray(tokens), jax.random.PRNGKey(0),
                                  impl="interpret"))
    return dict(jwl=jwl, params=params, tokens=tokens, out=out,
                img_tokens=np.asarray(states["parallel_decode"]["img_tokens"]),
                state=from_jax_params(tree))


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_generate_matches_jax_interpret(muse_run, impl):
    twl = reduced_workload(get_config("muse"))
    model = twl.load(muse_run["state"], device="cpu")
    states, stages = {}, []
    _capture_states(twl, states)
    out = twl.generate(model, muse_run["tokens"], 0, impl=impl, device="cpu",
                       on_stage=lambda name, s, b: stages.append(name))
    assert stages == ["text_encoder", "parallel_decode", "vq_decoder"]
    img_tokens = states["parallel_decode"]["img_tokens"].numpy()
    assert img_tokens.shape == (2, 16)
    assert ((img_tokens >= 0) & (img_tokens < 128)).all()
    np.testing.assert_array_equal(img_tokens, muse_run["img_tokens"])
    assert tuple(out.shape) == muse_run["out"].shape == (2, 8, 8, 3)
    assert torch.isfinite(out).all()
    _close_to_scale(out.numpy(), muse_run["out"])


@pytest.mark.parametrize("tiers", TIERS, ids=TIER_IDS)
def test_backbone_logits_match_jax(muse_run, tiers):
    jax_impl, torch_impl = tiers
    jwl = muse_run["jwl"]
    tokens, ctx = _backbone_inputs(jwl.cfg)
    gold = jax.jit(lambda p, t, c: jwl.model.backbone(p, t, c, impl=jax_impl))(
        muse_run["params"], jnp.asarray(tokens), jnp.asarray(ctx))
    model = reduced_workload(get_config("muse")).load(muse_run["state"], device="cpu")
    with torch.inference_mode():
        out = model.backbone(torch.from_numpy(tokens).long(), torch.from_numpy(ctx),
                             impl=torch_impl)
    assert tuple(out.shape) == (2, 16, 128)
    _close_to_scale(out.numpy(), gold)


def _bridge(tmod, seed=0):
    tree = _tree(init_params(tmod, seed))
    return jax.tree.map(jnp.asarray, tree), materialize(tmod, from_jax_params(tree), "cpu")


@pytest.mark.parametrize("tiers", TIERS, ids=TIER_IDS)
def test_block_matches_jax(tiers):
    """One non-causal ``Block`` with cross-attention, every leaf non-trivial."""
    jax_impl, torch_impl = tiers
    cfg = j_reduced_workload(j_get_config("muse")).cfg
    jblock = j_transformer.Block(cfg.lm_config(), "dense", causal=False, with_cross=True)
    tcfg = reduced_workload(get_config("muse")).cfg
    jp, tblock = _bridge(t_transformer.Block(tcfg.lm_config(), "dense", causal=False,
                                             with_cross=True))
    rng = np.random.default_rng(5)
    for path in ("norm1.bias", "norm_cross.scale", "norm2.bias"):
        a, b = path.split(".")
        v = (1.0 + 0.1 * rng.standard_normal(cfg.d_model)).astype(np.float32)
        jp[a][b] = jnp.asarray(v)
        getattr(tblock, a).get_parameter(b).data = torch.from_numpy(v)
    assert sorted(jp) == sorted(jblock.defs()) == [
        "attn", "cross_attn", "mlp", "norm1", "norm2", "norm_cross"]
    assert "bias" not in jp["mlp"]["wi"] and "bias" not in jp["attn"]["wq"]
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    gold, _, _ = jblock(jp, jnp.asarray(x), positions=None, context=jnp.asarray(ctx),
                        impl=jax_impl)
    out = tblock(torch.from_numpy(x), context=torch.from_numpy(ctx), impl=torch_impl)
    _close_to_scale(out.detach().numpy(), gold, LAYER)


@pytest.mark.parametrize("tiers", TIERS, ids=TIER_IDS)
def test_vqgan_decoder_matches_jax(tiers):
    jax_impl, torch_impl = tiers
    vq = j_reduced_workload(j_get_config("muse")).cfg.vq
    jp, tvq = _bridge(t_vae.VQGANDecoder(reduced_workload(get_config("muse")).cfg.vq))
    tokens = np.random.default_rng(6).integers(0, vq.codebook_size, (2, 16)).astype(np.int32)
    gold = jax.jit(lambda p, t: j_vae.VQGANDecoder(vq)(p, t, impl=jax_impl))(
        jp, jnp.asarray(tokens))
    with torch.inference_mode():
        out = tvq(torch.from_numpy(tokens).long(), impl=torch_impl)
    assert tuple(out.shape) == (2, 8, 8, 3)
    _close_to_scale(out.numpy(), gold)


# ---------------------------------------------------------------------------
# The MaskGIT rule, against both of the reference's copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq_len,steps", [(256, 12), (2816, 24), (16, 3), (48, 3)])
def test_keep_count_matches_jnp(seq_len, steps):
    """The cosine schedule in float32, as the reference traces it inside its
    ``fori_loop`` (``ar_image.py:180-181``, ``ttv.py:392-393``)."""
    count = jax.jit(lambda i: (jnp.cos((i + 1) / steps * jnp.pi / 2) * seq_len).astype(
        jnp.int32))
    gold = [int(count(jnp.int32(i))) for i in range(steps)]
    assert [t_ar.keep_count(i, steps, seq_len) for i in range(steps)] == gold


def _tied_logits(xp, tokens, conf, mask_token, vocab):
    """Logits whose argmax class is the row's masked count (so a decoded
    token tells the step that unmasked it) at height ``conf`` per position,
    and 0 elsewhere: positions with equal ``conf`` tie exactly.  ``xp`` is
    ``jnp`` or ``torch``."""
    n_masked = (tokens == mask_token).sum(-1) % vocab
    onehot = xp.arange(vocab)[None, :] == n_masked[:, None]
    return conf[:, :, None] * onehot[:, None, :]


@pytest.mark.parametrize("name", ["muse", "phenaki"])
def test_parallel_decode_with_ties_matches_reference(name):
    """Crafted logits with ties at the unmasking cutoff through the
    reference's own decode loop (``decode_parallel`` / ``decode_tokens``)
    and the port's one ``parallel_decode``: the same positions unmask at the
    same steps, ties included."""
    jwl = j_reduced_workload(j_get_config(name))
    cfg = jwl.cfg
    if name == "muse":
        S, vocab, steps = cfg.image_tokens, cfg.image_vocab, cfg.parallel_steps
    else:
        S, vocab, steps = cfg.frames * cfg.tokens_per_frame, cfg.video_vocab, cfg.parallel_steps
    mask = vocab
    # four heights, each on a quarter of the positions, shuffled per row
    rng = np.random.default_rng(7)
    conf = np.stack([rng.permutation(np.repeat([4.0, 3.0, 2.0, 1.0], S // 4))
                     for _ in range(2)]).astype(np.float32)
    model = jwl.model
    model.backbone = lambda p, t, c, impl="auto": _tied_logits(jnp, t, jnp.asarray(conf),
                                                               mask, vocab)
    decode = model.decode_parallel if name == "muse" else model.decode_tokens
    gold = np.asarray(decode({}, jnp.zeros((2, 3, 8))))
    tconf = torch.from_numpy(conf)
    out = t_ar.parallel_decode(lambda t, c: _tied_logits(torch, t, tconf, mask, vocab),
                               torch.zeros(2, 3, 8), S, steps, mask)
    np.testing.assert_array_equal(out.numpy(), gold)
    # the first step unmasks a whole tied quarter, more than its count
    n_first = S - t_ar.keep_count(0, steps, S)
    assert n_first < S // 4
    assert ((out.numpy() == S).sum(-1) == S // 4).all()


def test_maskgit_step_unmasks_every_tie_at_the_cutoff():
    S, mask = 8, 50
    tokens = torch.full((1, S), mask)
    tokens[0, 0] = 3  # already unmasked: keeps its token
    logits = torch.zeros(1, S, mask)
    conf = torch.tensor([9.0, 5.0, 5.0, 5.0, 1.0, 2.0, 1.0, 0.5])
    logits[0, torch.arange(S), torch.arange(S) + 10] = conf
    # steps 4, i 1: keep cos(pi / 4) * 8 = 5 masked, so 8 - 5 - 1 = 2 unmask,
    # but three positions tie at the second-best confidence
    assert t_ar.keep_count(1, 4, S) == 5
    out = t_ar.maskgit_step(tokens, logits, 1, 4, mask)
    assert out.tolist() == [[3, 11, 12, 13, mask, mask, mask, mask]]


# ---------------------------------------------------------------------------
# Configs, stage plans, the full-size bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ARImageConfig", "VQDecoderConfig"])
def test_config_fields_match_jax(name):
    j_cls, t_cls = {"ARImageConfig": (j_ar, t_ar), "VQDecoderConfig": (j_vae, t_vae)}[name]
    j_cls, t_cls = getattr(j_cls, name), getattr(t_cls, name)
    assert [f.name for f in dataclasses.fields(t_cls)] == [
        f.name for f in dataclasses.fields(j_cls)]
    required = dict(name="x", n_layers=1, d_model=8, n_heads=2, d_ff=8) \
        if name == "ARImageConfig" else {}
    assert _plain(t_cls(**required)) == _plain(j_cls(**required))


def test_muse_config_matches_jax():
    assert _plain(t_suite.MUSE) == _plain(j_get_config("muse"))
    assert get_config("muse") is t_suite.MUSE
    assert _plain(reduced_workload(t_suite.MUSE).cfg) == _plain(
        j_reduced_workload(j_get_config("muse")).cfg)


@pytest.mark.parametrize("decode", ["parallel", "ar"])
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_cost_descriptor_matches_jax(decode, reduced):
    jcfg = dataclasses.replace(j_get_config("muse"), decode=decode)
    tcfg = dataclasses.replace(get_config("muse"), decode=decode)
    jwl, twl = j_workload_for(jcfg), workload_for(tcfg)
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


def test_muse_stage_plan():
    stages = workload_for(get_config("muse")).cost_descriptor().stages
    assert [(s.name, s.steps, s.seq_len, s.demand) for s in stages] == [
        ("text_encoder", 1, 77, ()), ("parallel_decode", 12, 256, (256,)),
        ("vq_decoder", 1, 256, ())]


def test_autoregressive_decode_waits_for_the_parti_slice():
    """The Parti slice has landed: the reduced Muse config with ``decode="ar"``
    runs its ``ar_decode`` stage (causal blocks, a KV cache) through
    ``generate``, and ``parti`` is registered (``tests/test_torch_parti.py``
    holds both against the reference)."""
    twl = workload_for(dataclasses.replace(reduced_workload(get_config("muse")).cfg,
                                           decode="ar"))
    model = twl.init(0, device="cpu")
    assert all(b.attn.causal for b in model.blocks())
    out = twl.generate(model, np.zeros((1, 16), np.int32), 0, device="cpu")
    assert tuple(out.shape) == (1, 8, 8, 3) and torch.isfinite(out).all()
    assert get_config("parti").decode == "ar"


def test_full_size_params_bridge_without_transpose():
    """At the full Muse config the port's parameter names and shapes are the
    JAX tree's (abstract on both sides: nothing is allocated)."""
    jwl = j_workload_for(j_get_config("muse"))
    abstract = jax.eval_shape(jwl.init, jax.random.PRNGKey(0))
    j_shapes = {k: tuple(v.shape) for k, v in flatten_tree(abstract).items()}
    t_defs = param_defs(workload_for(get_config("muse")).model)
    assert {k: d.shape for k, d in t_defs.items()} == j_shapes
    assert round(sum(int(np.prod(s)) for s in j_shapes.values()) / 1e6, 1) == 3613.6
    assert t_defs["layer47.mlp.wi.kernel"].shape == (2048, 8192)
    assert t_defs["vq.decoder.conv_in.kernel"].shape == (3, 3, 256, 512)
