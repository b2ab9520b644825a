"""Parity of the port's training path with the JAX package on the CPU.

The oracle is the reference's own differentiation: the fused conv through
its ``custom_vjp`` on the ``interpret`` tier (``tests/test_kernels.py``'s
``test_conv2d_grad_matches_xla``), attention through its ``blocked_jax`` and
``naive`` tiers, GroupNorm through its ``jax`` tier, and the losses
(``DiffusionPipeline.train_loss``, ``TransformerLM.loss``) through
``jax.value_and_grad`` on ``blocked_jax``, their default tier on the CPU.
The port runs its ``kernel`` tier (the hand kernels' autograd
``Function``s, on their plain versions here) and its ``torch`` tier.

Both packages get the same seeded numpy parameters (JAX's eager ``init``
is slow on the CPU) and the same inputs; the diffusion loss gets the noise
JAX draws from its key (``jax.random.split``, ``randint``, ``normal``, as
``repro/models/diffusion.py`` does).  Tolerances: fp32 2e-5 for one op and
the optimizer, gradients 1e-4 (relative to the gradient's scale for a
whole model), bf16 2e-2; emitted statistics 2e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.configs.tiny import TINY_TTI_CASCADE as J_TINY
from repro.kernels.conv2d import ops as j_conv
from repro.kernels.flash_attention import ops as j_fa
from repro.kernels.groupnorm_silu import ops as j_gn
from repro.launch import steps as j_steps
from repro.models.diffusion import DiffusionPipeline as JDiffusion
from repro.models.transformer import TransformerLM as JTransformerLM
from repro.training import optimizer as j_opt
from repro.training.trainer import make_accumulating_step as j_make_accumulating_step
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.configs.tiny import TINY_TTI_CASCADE
from repro_torch.kernels.conv2d import ops as t_conv
from repro_torch.kernels.flash_attention import ops as t_fa
from repro_torch.kernels.groupnorm_silu import ops as t_gn
from repro_torch.launch import steps as t_steps
from repro_torch.models.diffusion import DiffusionPipeline
from repro_torch.models.transformer import REMAT, TransformerLM
from repro_torch.nn import init_params, materialize, trainable
from repro_torch.nn.module import flatten_tree
from repro_torch.training import optimizer as t_opt
from repro_torch.training.trainer import make_accumulating_step

F32 = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
STATS = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
_CONV_BLOCKS = dict(block_rows=40, block_cin=4, block_cout=8)  # as tests/test_kernels.py


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


def _vjp_port(fn, ops, cot):
    """The port's gradients of ``fn(*ops)`` pulled back from ``cot``, and
    the name of the autograd node that produced the output."""
    out = fn(*ops)
    outs = out if isinstance(out, tuple) else (out,)
    node = outs[0].grad_fn
    while type(node).__name__.startswith(("View", "Unsafe")):  # past the reshapes
        node = node.next_functions[0][0]
    node = type(node).__name__
    wrt = [o for o in ops if o is not None]
    grads = iter(torch.autograd.grad(outs, wrt, cot))
    return [next(grads) if o is not None else None for o in ops], node


# ---------------------------------------------------------------------------
# The kernels' Functions against the reference's gradients
# ---------------------------------------------------------------------------

CONV_GRAD_CASES = [
    # (B, H, W, C_in, C_out, K, stride), epilogue: every operand and both outputs
    ((2, 9, 9, 8, 8, 3, 1), dict(gn=True, bias=True, temb=True, emit_stats=True)),
    ((2, 9, 9, 8, 8, 3, 1), dict(gn=True, bias=True, silu=True, residual=True,
                                 emit_stats=True)),
    ((1, 9, 7, 4, 6, 3, 2), dict(gn=True, gn_silu=False, bias=True)),
    ((2, 6, 6, 8, 4, 1, 1), dict(bias=True, residual=True)),
]


@pytest.mark.parametrize("shape,combo", CONV_GRAD_CASES,
                         ids=lambda c: "-".join(map(str, c)) if isinstance(c, tuple)
                         else "-".join(sorted(c)))
def test_conv2d_function_grads_match_the_reference_custom_vjp(shape, combo):
    B, H, W, Cin, Cout, K, s = shape
    rng = np.random.default_rng(3)
    OH, OW = (H + 2 * (K // 2) - K) // s + 1, (W + 2 * (K // 2) - K) // s + 1
    f32 = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    ops = [f32(B, H, W, Cin), 0.2 * f32(K, K, Cin, Cout),
           1 + 0.1 * f32(B, Cin) if combo.get("gn") else None,
           0.1 * f32(B, Cin) if combo.get("gn") else None,
           0.1 * f32(Cout) if combo.get("bias") else None,
           f32(B, Cout) if combo.get("temb") else None,
           f32(B, OH, OW, Cout) if combo.get("residual") else None]
    stats = combo.get("emit_stats", False)
    cot = [f32(B, OH, OW, Cout)] + ([1e-3 * f32(B, 2, Cout)] if stats else [])
    static = dict(stride=s, gn_silu=combo.get("gn_silu", True), silu=combo.get("silu", False),
                  emit_stats=stats)
    present = [i for i, o in enumerate(ops) if o is not None]

    def j_fn(*args):
        full = list(ops)
        for i, a in zip(present, args):
            full[i] = a
        x, w, a, b, bias, temb, res = full
        return j_conv.conv2d(x, w, bias=bias, gn_affine=None if a is None else (a, b),
                             temb=temb, residual=res, impl="interpret", **static,
                             **_CONV_BLOCKS)

    out, vjp = jax.vjp(j_fn, *[jnp.asarray(ops[i]) for i in present])
    gold = vjp(tuple(map(jnp.asarray, cot)) if stats else jnp.asarray(cot[0]))

    def t_fn(x, w, a, b, bias, temb, res):
        return t_conv.conv2d(x, w, bias=bias, gn_affine=None if a is None else (a, b),
                             temb=temb, residual=res, impl="kernel", **static)

    t_ops = [None if o is None else _t(o) for o in ops]
    grads, node = _vjp_port(t_fn, t_ops, tuple(torch.from_numpy(c) for c in cot))
    assert node == "Conv2dFnBackward"
    with torch.no_grad():
        t_out = t_fn(*t_ops)
    _close_scaled(t_out[0] if stats else t_out, out[0] if stats else out, F32)
    if stats:
        _close_scaled(t_out[1], out[1], STATS)
    names = ("x", "w", "gn_a", "gn_b", "bias", "temb", "residual")
    for i, g in zip(present, gold):
        _close_scaled(grads[i], g, GRAD, names[i])


ATTN_GRAD_CASES = [
    # B, Sq, Skv, H, KVH, D, causal, window, kv_offset
    (2, 24, 24, 4, 2, 16, True, None, 0),   # causal GQA
    (1, 20, 20, 2, 2, 8, True, 6, 0),       # causal local window
    (1, 12, 30, 4, 1, 8, True, None, 18),   # MQA, a query block past the first keys
    (2, 10, 14, 2, 2, 8, False, None, 0),   # cross-attention
]  # the first also against the naive tier


@pytest.mark.parametrize("case", ATTN_GRAD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_function_grads_match_the_reference_tiers(case):
    B, Sq, Skv, H, KVH, D, causal, window, offset = case
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, D), (B, Skv, KVH, D), (B, Skv, KVH, D)))
    cot = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, kv_offset=offset)
    golds = []
    for impl in ("blocked_jax", "naive")[:2 if case == ATTN_GRAD_CASES[0] else 1]:
        out, vjp = jax.vjp(lambda q, k, v: j_fa.attention(q, k, v, impl=impl, **kw),
                           *map(jnp.asarray, (q, k, v)))
        golds.append((out, vjp(jnp.asarray(cot))))
    grads, node = _vjp_port(lambda q, k, v: t_fa.attention(q, k, v, impl="kernel", **kw),
                            [_t(q), _t(k), _t(v)], (torch.from_numpy(cot),))
    assert node == "FlashAttentionFnBackward"
    for out, gold in golds:
        _close_scaled(t_fa.attention(_t(q, False), _t(k, False), _t(v, False), impl="kernel",
                                     **kw), out, F32)
        for name, g, gg in zip("qkv", grads, gold):
            _close_scaled(g, gg, GRAD, name)


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape", [(2, 30, 16, 4), (1, 12, 24, 8)])
def test_groupnorm_function_grads_match_the_reference_jax_tier(shape, silu):
    B, N, C, groups = shape
    rng = np.random.default_rng(7)
    x = (2.0 * rng.standard_normal((B, N, C)) + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    cot = rng.standard_normal((B, N, C)).astype(np.float32)
    kw = dict(groups=groups, silu=silu)
    out, vjp = jax.vjp(lambda x, s, b: j_gn.groupnorm_silu(x, s, b, impl="jax", **kw),
                       *map(jnp.asarray, (x, scale, bias)))
    gold = vjp(jnp.asarray(cot))
    grads, node = _vjp_port(lambda x, s, b: t_gn.groupnorm_silu(x, s, b, impl="kernel", **kw),
                            [_t(x), _t(scale), _t(bias)], (torch.from_numpy(cot),))
    assert node == "GroupNormSiLUFnBackward"
    _close_scaled(t_gn.groupnorm_silu(_t(x, False), _t(scale, False), _t(bias, False),
                                      impl="kernel", **kw), out, F32)
    for name, g, gg in zip(("x", "scale", "bias"), grads, gold):
        _close_scaled(g, gg, GRAD, name)


# ---------------------------------------------------------------------------
# The losses: every leaf's gradient
# ---------------------------------------------------------------------------


def _nested(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _reference_tree(abstract: dict, state: dict, path: str = "") -> dict:
    """The port's values in the reference's tree structure (an empty
    subtree where a layer has no leaves: OLMo's norms)."""
    out = {}
    for k, v in abstract.items():
        key = f"{path}.{k}" if path else k
        out[k] = (_reference_tree(v, state, key) if isinstance(v, dict)
                  else state[key].numpy().copy())
    return out


def _assert_leaf_grads(port: dict, ref_flat: dict, what: str):
    """Every leaf: the port's gradient (``None`` = zeros) against the
    reference's, 1e-4 of the gradient's scale."""
    assert set(port) == set(ref_flat), what
    for key, gold in ref_flat.items():
        g = port[key]
        g = torch.zeros(gold.shape) if g is None else g
        _close_scaled(g, gold, GRAD, f"{what} {key}")


@pytest.fixture(scope="module")
def sd_run():
    """Tiny pixel cascade: seeded numpy params, a batch, JAX's (t, eps)
    from its key, and the reference's loss and gradients on blocked_jax."""
    state = init_params(DiffusionPipeline(TINY_TTI_CASCADE), 0)
    params = jax.tree.map(jnp.asarray, _nested({k: v.numpy().copy() for k, v in state.items()}))
    rng = np.random.default_rng(0)
    cfg = TINY_TTI_CASCADE
    batch = {"latents": rng.standard_normal((2, 8, 8, 3)).astype(np.float32),
             "text": rng.integers(0, cfg.text.vocab, (2, cfg.text.max_len)).astype(np.int32)}
    key = jax.random.PRNGKey(3)
    k_t, k_eps = jax.random.split(key)  # as repro/models/diffusion.py draws them
    t = jax.random.randint(k_t, (2,), 0, 1000)
    eps = jax.random.normal(k_eps, batch["latents"].shape, jnp.float32)
    jmodel = JDiffusion(J_TINY)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmodel.train_loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, key, impl="blocked_jax")))(params)
    return dict(state=state, batch=batch, t=np.asarray(t), eps=np.asarray(eps),
                loss=float(loss), grads={k: np.asarray(v) for k, v in flatten_tree(grads).items()})


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_diffusion_train_loss_and_every_leaf_grad_match_jax(sd_run, impl):
    model = materialize(DiffusionPipeline(TINY_TTI_CASCADE), sd_run["state"], "cpu")
    params = trainable(model)
    batch = {k: torch.from_numpy(v) for k, v in sd_run["batch"].items()}
    loss = model.denoise_loss(batch, torch.tensor(sd_run["t"]), torch.tensor(sd_run["eps"]),
                              impl=impl)
    np.testing.assert_allclose(loss.item(), sd_run["loss"], rtol=1e-4)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                 allow_unused=True)))
    assert all(grads[k] is None for k in grads if k.startswith("sr0."))
    _assert_leaf_grads(grads, sd_run["grads"], f"tiny SD {impl}")


LM_ARCHS = ["olmo-1b", "deepseek-moe-16b"]


@pytest.fixture(scope="module")
def lm_runs():
    """Reduced olmo-1b and a reduced MoE (deepseek-moe-16b: a dense group,
    then MoE layers with shared experts): one seeded tree each, a batch
    with masked labels, the reference's ``loss`` and its gradients."""
    out = {}
    for arch in LM_ARCHS:
        jcfg = j_reduced(j_get_config(arch))
        jlm = JTransformerLM(jcfg)
        abstract = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
        state = init_params(TransformerLM(reduced(get_config(arch))), 1)
        tree = jax.tree.map(jnp.asarray, _reference_tree(abstract, state))
        rng = np.random.default_rng(2)
        tokens = rng.integers(0, jcfg.vocab, (2, 17)).astype(np.int32)
        labels = tokens[:, 1:].copy()
        labels[0, :3] = -1  # masked positions
        batch = {"tokens": tokens[:, :-1], "labels": labels}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            lambda p: (jlm.loss(p, jb, impl="blocked_jax"),
                       jlm.forward(p, jb["tokens"], impl="blocked_jax")[1]),
            has_aux=True))(tree)
        out[arch] = dict(jlm=jlm, jcfg=jcfg, tree=tree, state=state, batch=batch,
                         loss=float(loss), aux=float(aux),
                         grads={k: np.asarray(v) for k, v in flatten_tree(grads).items()})
    return out


@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_and_every_leaf_grad_match_jax(lm_runs, arch, impl):
    run = lm_runs[arch]
    model = materialize(TransformerLM(reduced(get_config(arch))), run["state"], "cpu")
    params = trainable(model)
    batch = {k: torch.from_numpy(v) for k, v in run["batch"].items()}
    loss = model.loss(batch, impl=impl)
    np.testing.assert_allclose(loss.item(), run["loss"], rtol=2e-5)
    _, aux = model.forward_train(batch["tokens"], impl=impl)
    np.testing.assert_allclose(aux.item(), run["aux"], rtol=2e-5, atol=1e-7)
    if arch == "deepseek-moe-16b":
        assert run["aux"] > 0  # the MoE's auxiliary loss is in the loss
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                 allow_unused=True)))
    _assert_leaf_grads(grads, run["grads"], f"{arch} {impl}")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_remat_changes_neither_loss_nor_grads(lm_runs, arch):
    run = lm_runs[arch]
    model = materialize(TransformerLM(reduced(get_config(arch))), run["state"], "cpu")
    params = trainable(model)
    batch = {k: torch.from_numpy(v) for k, v in run["batch"].items()}
    out = {}
    for remat in REMAT:
        loss = model.loss(batch, impl="torch", remat=remat)
        out[remat] = (loss, torch.autograd.grad(loss, list(params.values()), allow_unused=True))
    for remat in ("dots", "full"):
        assert out[remat][0].item() == out["none"][0].item()
        for key, a, b in zip(params, out[remat][1], out["none"][1]):
            assert (a is None) == (b is None), key
            if a is not None:
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=key)
    with pytest.raises(ValueError, match="remat"):
        model.loss(batch, remat="some")


def _port_olmo(run):
    """A model of its own values: the optimizer updates them in place."""
    state = {k: v.clone() for k, v in run["state"].items()}
    return materialize(TransformerLM(reduced(get_config("olmo-1b"))), state, "cpu")


def _olmo_step_inputs(lm_runs):
    run = lm_runs["olmo-1b"]
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, run["jcfg"].vocab, (4, 13)).astype(np.int32)
    return run, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def _assert_step_matches(model, params, state, metrics, j_params, j_state, j_metrics):
    """Loss, norm, moments and parameters after one step.  A first Adam
    step moves each element by lr * g / (|g| + eps), about lr * sign(g):
    where |g| is near 0 its sign may differ with the summation order, so
    these steps take eps = 1e-4, which keeps the update a smooth function
    of g (``test_adamw_update_matches_the_reference`` holds the default
    eps on equal gradients)."""
    np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]), rtol=2e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(j_metrics["grad_norm"]),
                               rtol=1e-4)
    j_flat, j_m = flatten_tree(j_params), flatten_tree(j_state["m"])
    for key, p in params.items():
        _close_scaled(p, j_flat[key], F32, key)
        _close_scaled(state["m"][key], j_m[key], GRAD, key)
    assert int(state["step"]) == int(j_state["step"]) == 1


@pytest.mark.parametrize("microbatches", [1, 2])
def test_accumulating_step_matches_the_reference(lm_runs, microbatches):
    run, batch = _olmo_step_inputs(lm_runs)
    cfg = j_opt.AdamWConfig(lr=1e-3, eps=1e-4, warmup_steps=1, total_steps=10)
    jlm = run["jlm"]
    j_step = j_make_accumulating_step(lambda p, b, k: jlm.loss(p, b), cfg, microbatches)
    j_params, j_state, j_metrics = j_step(run["tree"], j_opt.adamw_init(run["tree"]),
                                          {k: jnp.asarray(v) for k, v in batch.items()},
                                          jax.random.PRNGKey(0))
    model = _port_olmo(run)
    params = trainable(model)
    step = make_accumulating_step(lambda b, gen: model.loss(b),
                                  t_opt.AdamWConfig(**dataclasses.asdict(cfg)), microbatches)
    params, state, metrics = step(params, t_opt.adamw_init(params),
                                  {k: torch.from_numpy(v) for k, v in batch.items()}, 0, 0)
    _assert_step_matches(model, params, state, metrics, j_params, j_state, j_metrics)


def test_make_train_step_matches_the_reference(lm_runs):
    """Both packages' ``make_train_step`` (``remat="dots"``, the plain tier,
    2 microbatches); the reference's on a one-device mesh."""
    run, batch = _olmo_step_inputs(lm_runs)
    cfg = j_opt.AdamWConfig(lr=1e-3, eps=1e-4, warmup_steps=1, total_steps=10)
    # Auto axes: on jax 0.9 ``make_debug_mesh``'s mesh has Explicit axes, on
    # which the reference's microbatch split (``shlib.constrain``) raises
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    j_step, _, _ = j_steps.make_train_step(run["jlm"], run["jcfg"], mesh, opt_cfg=cfg,
                                           microbatches=2)
    with mesh:
        j_params, j_state, j_metrics = jax.jit(j_step)(
            run["tree"], j_opt.adamw_init(run["tree"]),
            {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port_olmo(run)
    params = trainable(model)
    step = t_steps.make_train_step(model, model.cfg, microbatches=2,
                                   opt_cfg=t_opt.AdamWConfig(**dataclasses.asdict(cfg)))
    params, state, metrics = step(params, t_opt.adamw_init(params),
                                  {k: torch.from_numpy(v) for k, v in batch.items()})
    _assert_step_matches(model, params, state, metrics, j_params, j_state, j_metrics)


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip_norm", [0.05, 100.0], ids=["clipped", "unclipped"])
def test_adamw_update_matches_the_reference(clip_norm):
    """fp32 and bf16 leaves and a leaf with no gradient (zeros in JAX, None
    in the port: it still decays), 6 steps through a warmup of 3 and into
    the cosine decay."""
    rng = np.random.default_rng(11)
    p0 = {"w": rng.standard_normal((8, 4)).astype(np.float32),
          "b": rng.standard_normal((6,)).astype(np.float32),
          "frozen": rng.standard_normal((5,)).astype(np.float32)}
    dtypes = {"w": (jnp.float32, torch.float32), "b": (jnp.bfloat16, torch.bfloat16),
              "frozen": (jnp.float32, torch.float32)}
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=8, weight_decay=0.1, clip_norm=clip_norm)
    j_params = {k: jnp.asarray(v, dtypes[k][0]) for k, v in p0.items()}
    t_params = {k: torch.tensor(v).to(dtypes[k][1]) for k, v in p0.items()}
    j_state, t_state = j_opt.adamw_init(j_params), t_opt.adamw_init(t_params)
    j_update = jax.jit(lambda p, g, s: j_opt.adamw_update(p, g, s, j_opt.AdamWConfig(**cfg)))
    clipped = []
    for step in range(6):
        g = {"w": rng.standard_normal((8, 4)).astype(np.float32),
             "b": rng.standard_normal((6,)).astype(np.float32)}
        j_grads = {"w": jnp.asarray(g["w"]), "b": jnp.asarray(g["b"], jnp.bfloat16),
                   "frozen": jnp.zeros(5, jnp.float32)}
        t_grads = {"w": torch.from_numpy(g["w"]),
                   "b": torch.from_numpy(g["b"]).bfloat16(), "frozen": None}
        j_params, j_state, jm = j_update(j_params, j_grads, j_state)
        t_params, t_state, tm = t_opt.adamw_update(t_params, t_grads, t_state,
                                                   t_opt.AdamWConfig(**cfg))
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        clipped.append(float(jm["grad_norm"]) > clip_norm)
        assert int(t_state["step"]) == int(j_state["step"]) == step + 1
        for k in p0:
            assert t_params[k].dtype == dtypes[k][1]
            tol = BF16 if k == "b" else F32
            _close_scaled(t_params[k], np.asarray(j_params[k], np.float32), tol, k)
            _close_scaled(t_state["m"][k], j_state["m"][k], F32, k)
            _close_scaled(t_state["v"][k], j_state["v"][k], F32, k)
    assert all(clipped) == (clip_norm < 1)
    assert not np.allclose(_np(t_params["frozen"]), p0["frozen"])  # decayed


def test_cosine_lr_matches_the_reference():
    cfg = dict(lr=2e-4, warmup_steps=50, total_steps=300)
    for step in (0, 1, 25, 50, 51, 175, 299, 300, 400):
        np.testing.assert_allclose(t_opt.cosine_lr(t_opt.AdamWConfig(**cfg), step),
                                   float(j_opt.cosine_lr(j_opt.AdamWConfig(**cfg),
                                                         jnp.int32(step))), rtol=1e-6,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------


def _train_state(seed):
    rng = np.random.default_rng(seed)
    flat = {"unet.conv_in.kernel": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
            "unet.conv_in.bias": rng.standard_normal(4).astype(np.float32),
            "blocks.g0_dense.attn.wq.kernel": rng.standard_normal((2, 4, 4)).astype(np.float32),
            "embed.embedding": rng.standard_normal((5, 4)).astype(ml_dtypes.bfloat16)}
    m = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in flat.items()}
    v = {k: rng.random(v.shape).astype(np.float32) for k, v in flat.items()}
    return flat, m, v


def _port_tensor(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(a)


def test_a_reference_checkpoint_restores_into_the_port(tmp_path):
    flat, m, v = _train_state(0)
    j_tree = {"params": _nested(flat), "opt": {"step": jnp.int32(9), "m": _nested(m),
                                                "v": _nested(v)},
              "key": jax.random.PRNGKey(0)}
    JCheckpointer(str(tmp_path), async_save=False).save(9, jax.tree.map(jnp.asarray, j_tree))
    like = {"params": {k: torch.zeros(a.shape, dtype=_port_tensor(a).dtype)
                       for k, a in flat.items()},
            "opt": {"step": torch.zeros((), dtype=torch.int32),
                    "m": {k: torch.zeros(a.shape) for k, a in m.items()},
                    "v": {k: torch.zeros(a.shape) for k, a in v.items()}}}
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == 9
    out = ck.restore(like, device="cpu")
    assert int(out["opt"]["step"]) == 9 and out["opt"]["step"].dtype == torch.int32
    for k, a in flat.items():
        assert out["params"][k].dtype == _port_tensor(a).dtype
        assert torch.equal(out["params"][k], _port_tensor(a)), k
        assert torch.equal(out["opt"]["m"][k], torch.from_numpy(m[k]))
        assert torch.equal(out["opt"]["v"][k], torch.from_numpy(v[k]))


def test_a_port_checkpoint_restores_into_the_reference(tmp_path):
    """The reference reads the port's paths and files; its ``restore``
    returns a bf16 leaf as the raw 2-byte array ``np.load`` gives (it casts
    no leaf, for its own checkpoints too), which views back as bf16."""
    flat, m, v = _train_state(1)
    state = {"params": {k: _port_tensor(a) for k, a in flat.items()},
             "opt": {"step": torch.tensor(4, dtype=torch.int32),
                     "m": {k: torch.from_numpy(a) for k, a in m.items()},
                     "v": {k: torch.from_numpy(a) for k, a in v.items()}},
             "seed": torch.tensor(0, dtype=torch.int64)}
    Checkpointer(str(tmp_path), async_save=False).save(4, state)
    like = {"params": _nested({k: jnp.zeros(a.shape, a.dtype) for k, a in flat.items()}),
            "opt": {"step": jnp.int32(0), "m": _nested({k: jnp.zeros(a.shape)
                                                        for k, a in m.items()}),
                    "v": _nested({k: jnp.zeros(a.shape) for k, a in v.items()})}}
    out = JCheckpointer(str(tmp_path)).restore(like)
    assert int(out["opt"]["step"]) == 4
    got = flatten_tree(out["params"])
    for k, a in flat.items():
        b = np.asarray(got[k])
        if a.dtype == ml_dtypes.bfloat16:
            b = b.view(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(b, a, err_msg=k)
        np.testing.assert_array_equal(flatten_tree(out["opt"]["m"])[k], m[k])
        np.testing.assert_array_equal(flatten_tree(out["opt"]["v"])[k], v[k])
