"""Parity of the port's text-to-video training with the JAX package on the
CPU: the temporal kernels' autograd ``Function``s and the Make-A-Video and
Phenaki losses.

The oracle is the reference's own differentiation: the temporal conv
through its ``custom_vjp`` on the ``interpret`` tier
(``repro/kernels/conv2d/ops.py`` ``_tconv_fused``), temporal attention
through its ``naive`` permute path (its Pallas kernel has no VJP), and the
losses (``MakeAVideoPipeline.train_loss``, ``PhenakiModel.train_loss``)
through ``jax.value_and_grad`` on ``blocked_jax``.  The port runs its
``kernel`` tier (the Functions, on the kernels' plain versions here) and its
``torch`` tier.

Both packages get the same seeded numpy parameters and inputs; the port's
losses get the reference's own draws (``t`` and ``eps`` for the video
denoiser, the mask for the video tokens), made with ``jax.random`` as the
reference makes them and handed to ``denoise_loss`` / ``masked_loss``.
Tolerances: the loss within 1e-4 relative, every gradient within 1e-4 of
its scale (``tests/test_kernels.py``'s gradient tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.suite  # noqa: F401  (registers the suite)
from repro.configs import get_config as j_get_config
from repro.configs.tiny import TINY_TTV_CASCADE as J_TINY_TTV
from repro.kernels.conv2d import ops as j_conv
from repro.kernels.flash_attention import ops as j_fa
from repro.models.ttv import MakeAVideoPipeline as JMakeAVideo
from repro.workload import reduced_workload as j_reduced_workload
from repro_torch.configs import get_config
from repro_torch.configs.tiny import TINY_TTV_CASCADE
from repro_torch.kernels.conv2d import ops as t_conv
from repro_torch.kernels.flash_attention import ops as t_fa
from repro_torch.models.transformer import masked_nll
from repro_torch.models.ttv import MakeAVideoPipeline
from repro_torch.nn import init_params, materialize, trainable
from repro_torch.nn.module import flatten_tree
from repro_torch.workload import reduced_workload

GRAD = dict(rtol=1e-4, atol=1e-4)
F32 = dict(rtol=2e-5, atol=2e-5)
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, grad=True):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _np(t):
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor) else t, np.float32)


def _close_scaled(out, gold, tol=GRAD, msg=""):
    """|out - gold| <= atol * max(1, max|gold|) + rtol * |gold|."""
    gold = _np(gold)
    scale = max(1.0, float(np.abs(gold).max())) if gold.size else 1.0
    np.testing.assert_allclose(_np(out), gold, rtol=tol["rtol"], atol=tol["atol"] * scale,
                               err_msg=msg)


def _node(out) -> str:
    """The autograd node that produced ``out``, past the reshapes."""
    node = out.grad_fn
    while type(node).__name__.startswith(("View", "Unsafe")):
        node = node.next_functions[0][0]
    return type(node).__name__


def _nested(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.numpy().copy() if isinstance(v, torch.Tensor) else v
    return tree


# ---------------------------------------------------------------------------
# The temporal kernels' Functions against the reference's gradients
# ---------------------------------------------------------------------------

# (B, F, H, W, C): C_out = C (the reference's ref takes square weights), F >= 3
# so every tap of the K = 3 filter reaches a frame, F = 5 past the edges
TCONV_GRAD_CASES = [(2, 3, 2, 3, 8), (1, 5, 3, 4, 4)]


@pytest.mark.parametrize("shape", TCONV_GRAD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_temporal_conv_function_grads_match_the_reference_custom_vjp(shape):
    B, F, H, W, C = shape
    rng = np.random.default_rng(11)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (0.3 * rng.standard_normal((3, C, C))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    cot = rng.standard_normal(shape).astype(np.float32)
    out, vjp = jax.vjp(lambda x, w, b: j_conv.temporal_conv1d(x, w, b, impl="interpret"),
                       *map(jnp.asarray, (x, w, bias)))
    gold = vjp(jnp.asarray(cot))
    ops = [_t(x), _t(w), _t(bias)]
    y = t_conv.temporal_conv1d(*ops, impl="kernel")
    assert _node(y) == "TemporalConv1dFnBackward"
    grads = torch.autograd.grad(y, ops, torch.from_numpy(cot))
    _close_scaled(y, out, F32)
    for name, g, gg in zip(("x", "w", "bias"), grads, gold):
        _close_scaled(g, gg, GRAD, name)


# (B, F, HW, H, D): F = 11 as Phenaki's frames, HW not a multiple of a block
TATTN_GRAD_CASES = [(2, 3, 5, 2, 8), (1, 11, 6, 3, 16)]


@pytest.mark.parametrize("shape", TATTN_GRAD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_temporal_attention_function_grads_match_the_reference_naive_tier(shape):
    rng = np.random.default_rng(13)
    q, k, v, cot = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    out, vjp = jax.vjp(lambda q, k, v: j_fa.temporal_attention(q, k, v, impl="naive"),
                       *map(jnp.asarray, (q, k, v)))
    gold = vjp(jnp.asarray(cot))
    ops = [_t(q), _t(k), _t(v)]
    y = t_fa.temporal_attention(*ops, impl="kernel")
    assert _node(y) == "TemporalAttentionFnBackward"
    grads = torch.autograd.grad(y, ops, torch.from_numpy(cot))
    _close_scaled(y, out, F32)
    for name, g, gg in zip("qkv", grads, gold):
        _close_scaled(g, gg, GRAD, name)


def test_inference_calls_record_no_function():
    """Without a graph the kernel tier calls the kernels directly."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 3, 2, 2, 4)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 4, 4)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((1, 3, 4, 2, 8)).astype(np.float32))
    with torch.no_grad():
        assert t_conv.temporal_conv1d(x, w.requires_grad_(True), torch.zeros(4),
                                      impl="kernel").grad_fn is None
        assert t_fa.temporal_attention(q, q, q.requires_grad_(True), impl="kernel").grad_fn is None


# ---------------------------------------------------------------------------
# The losses: every leaf's gradient
# ---------------------------------------------------------------------------


def _assert_leaf_grads(port: dict, ref_flat: dict, what: str):
    """Every leaf: the port's gradient (``None`` = zeros) against the
    reference's, 1e-4 of the gradient's scale."""
    assert set(port) == set(ref_flat), what
    for key, gold in ref_flat.items():
        g = port[key]
        g = torch.zeros(gold.shape) if g is None else g
        _close_scaled(g, gold, GRAD, f"{what} {key}")


def _leaf_grads(params: dict, loss) -> dict:
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()), allow_unused=True)))


@pytest.fixture(scope="module")
def mav_run():
    """The tiny TTV cascade's VideoUNet on 3 frames: seeded numpy params, a
    batch, the reference's (t, eps) from its key, and its loss and
    gradients on blocked_jax."""
    state = init_params(MakeAVideoPipeline(TINY_TTV_CASCADE), 0)
    params = jax.tree.map(jnp.asarray, _nested(state))
    cfg = TINY_TTV_CASCADE
    rng = np.random.default_rng(0)
    batch = {"video": rng.standard_normal((2, 3, cfg.image_size, cfg.image_size,
                                           cfg.unet.in_channels)).astype(np.float32),
             "text": rng.integers(0, cfg.text.vocab, (2, cfg.text.max_len)).astype(np.int32)}
    key = jax.random.PRNGKey(5)
    k_t, k_eps = jax.random.split(key)  # as repro/models/ttv.py draws them
    t = jax.random.randint(k_t, (2,), 0, 1000)
    eps = jax.random.normal(k_eps, batch["video"].shape, jnp.float32)
    jmodel = JMakeAVideo(J_TINY_TTV)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmodel.train_loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, key, impl="blocked_jax")))(params)
    return dict(state=state, batch=batch, t=np.asarray(t), eps=np.asarray(eps),
                loss=float(loss), grads={k: np.asarray(v) for k, v in flatten_tree(grads).items()})


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_make_a_video_loss_and_every_leaf_grad_match_jax(mav_run, impl):
    model = materialize(MakeAVideoPipeline(TINY_TTV_CASCADE), mav_run["state"], "cpu")
    params = trainable(model)
    batch = {k: torch.from_numpy(v) for k, v in mav_run["batch"].items()}
    loss = model.denoise_loss(batch, torch.tensor(mav_run["t"]), torch.tensor(mav_run["eps"]),
                              impl=impl)
    np.testing.assert_allclose(loss.item(), mav_run["loss"], rtol=LOSS_RTOL)
    _assert_leaf_grads(_leaf_grads(params, loss), mav_run["grads"], f"tiny TTV {impl}")


def test_make_a_video_train_loss_draws_its_noise_from_the_generator(mav_run):
    model = materialize(MakeAVideoPipeline(TINY_TTV_CASCADE), mav_run["state"], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in mav_run["batch"].items()}
    with torch.no_grad():
        loss = model.train_loss(batch, torch.Generator().manual_seed(7), impl="torch")
        t, eps = model.train_noise(tuple(batch["video"].shape), torch.Generator().manual_seed(7))
        assert t.shape == (2,) and ((t >= 0) & (t < 1000)).all()
        assert loss.item() == model.denoise_loss(batch, t, eps, impl="torch").item()


@pytest.fixture(scope="module")
def phenaki_run():
    """Reduced Phenaki: seeded numpy params (non-zero biases), a batch, the
    reference's mask from its key, its loss and gradients on blocked_jax."""
    jwl = j_reduced_workload(j_get_config("phenaki"))
    cfg = jwl.cfg
    state = init_params(reduced_workload(get_config("phenaki")).model, 1)
    rng = np.random.default_rng(3)
    for key in [k for k in state if k.endswith("bias")]:
        state[key] = torch.from_numpy((0.1 * rng.standard_normal(state[key].shape))
                                      .astype(np.float32))
    params = jax.tree.map(jnp.asarray, _nested(state))
    S = cfg.frames * cfg.tokens_per_frame
    batch = {"video_tokens": rng.integers(0, cfg.video_vocab, (2, S)).astype(np.int32),
             "text": rng.integers(0, cfg.text.vocab, (2, cfg.text.max_len)).astype(np.int32)}
    key = jax.random.PRNGKey(9)
    frac = jax.random.uniform(key, (2, 1), minval=0.3, maxval=0.9)  # as repro/models/ttv.py
    mask = jax.random.uniform(jax.random.fold_in(key, 1), (2, S)) < frac
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jwl.model.train_loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, key, impl="blocked_jax")))(params)
    return dict(state=state, batch=batch, mask=np.asarray(mask), loss=float(loss),
                grads={k: np.asarray(v) for k, v in flatten_tree(grads).items()})


def _phenaki(run):
    return reduced_workload(get_config("phenaki")).load(run["state"], device="cpu")


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_phenaki_loss_and_every_leaf_grad_match_jax(phenaki_run, impl):
    model = _phenaki(phenaki_run)
    params = trainable(model)
    batch = {k: torch.from_numpy(v) for k, v in phenaki_run["batch"].items()}
    assert 0 < phenaki_run["mask"].mean() < 1
    loss = model.masked_loss(batch, torch.tensor(phenaki_run["mask"]), impl=impl)
    np.testing.assert_allclose(loss.item(), phenaki_run["loss"], rtol=LOSS_RTOL)
    _assert_leaf_grads(_leaf_grads(params, loss), phenaki_run["grads"], f"phenaki {impl}")


def test_phenaki_mask_fraction_is_drawn_per_row(phenaki_run):
    model = _phenaki(phenaki_run)
    gen = torch.Generator().manual_seed(0)
    masks = torch.cat([model.train_mask((64, 200), gen) for _ in range(4)]).float()
    share = masks.mean(dim=1)
    assert 0.2 < float(share.min()) and float(share.max()) < 1.0  # each row's own U(0.3, 0.9)
    assert float(share.std()) > 0.1


# ---------------------------------------------------------------------------
# The masked NLL
# ---------------------------------------------------------------------------


def test_masked_nll_with_no_position_masked_is_zero_with_zero_gradients(phenaki_run):
    """With no counted label the sum is over max(0, 1): the loss is 0 and
    so is every gradient, as in the reference."""
    logits = torch.randn(2, 5, 7, requires_grad=True)
    loss = masked_nll(logits, torch.full((2, 5), -1))
    (g,) = torch.autograd.grad(loss, [logits])
    assert loss.item() == 0.0 and not g.any()
    model = _phenaki(phenaki_run)
    params = trainable(model)
    batch = {k: torch.from_numpy(v) for k, v in phenaki_run["batch"].items()}
    none = torch.zeros(batch["video_tokens"].shape, dtype=torch.bool)
    loss = model.masked_loss(batch, none, impl="kernel")
    assert loss.item() == 0.0
    assert all(g is None or not g.any() for g in _leaf_grads(params, loss).values())


def test_masked_nll_counts_only_labels_at_or_above_zero():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 6, 5)).astype(np.float32)
    labels = rng.integers(0, 5, (2, 6))
    labels[0, :4] = -1
    keep = labels >= 0
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    gold = -np.take_along_axis(logp, np.maximum(labels, 0)[..., None], -1)[..., 0][keep].mean()
    out = masked_nll(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(out.item(), gold, rtol=1e-6)
