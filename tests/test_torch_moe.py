"""Parity of the port's Mixture-of-Experts LMs (``deepseek-moe-16b``,
``qwen3-moe-30b-a3b``) with the JAX package.

What the family adds to the dense LMs: the MoE FFN
(``models/layers/moe.py``: fp32 router, top-k with the lower index first on
ties, capacity-bounded scatter dispatch, shared experts), qk-norm in
attention (Qwen3), deepseek's leading dense layer (``g0_dense`` then
``g1_moe``), and the ``dispatch`` category of the tracer.

The MoE layer runs in both packages on one set of seeded numpy parameters
at small widths, within 2e-5 in fp32 (2e-2 in bf16), in five regimes: a
capacity that drops assignments, ``no_drop``, shared experts, an all-zero
router (every probability tied: the lower index must win), and a bf16 model
with its fp32 router.  Each reduced config (``configs.reduced``: 8 experts,
top-2, capacity 8.0, so nothing drops) runs on one seeded tree, handed to
JAX in the reference's own structure and bridged unchanged (the stacked 4-D
expert leaves included); JAX runs on the ``interpret`` tier, so its prefill
reaches the Pallas flash-attention kernel in interpret mode.  Greedy tokens
must equal the reference's live output.  The full-width event streams are
in ``tests/test_torch_trace_parity_moe.py``.
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
from repro.models.layers import attention as j_attention
from repro.models.layers import moe as j_moe
from repro.workload import workload_for as j_workload_for
from repro_torch import configs as t_configs
from repro_torch.configs import get_config, reduced
from repro_torch.core import tracer
from repro_torch.models.layers import attention as t_attention
from repro_torch.models.layers import moe as t_moe
from repro_torch.nn import from_jax_params, init_params, materialize, param_defs
from repro_torch.nn.module import flatten_tree
from repro_torch.workload import reduced_workload, workload_for

ARCHS = ["deepseek-moe-16b", "qwen3-moe-30b-a3b"]
LAYER = dict(rtol=2e-5, atol=2e-5)
CHAIN = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
PROMPT, NEW = 16, 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: under several test workers, 8
    threads a worker oversubscribe the cores.  Restored after."""
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
    gold = np.asarray(jnp.asarray(gold, jnp.float32))
    scale = max(1.0, float(np.abs(gold).max()))
    np.testing.assert_allclose(np.asarray(out, np.float32), gold, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _t(a):
    return torch.from_numpy(np.array(a))


def _events(t):
    return [(e.op, e.name, e.flops, e.bytes_hbm, e.seq_len, e.meta) for e in t.events]


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------

# (kwargs of both layers, forward kwargs, tokens (B, S), router scale)
MOE_CASES = {
    "drops": (dict(), dict(), (2, 24), 1.0),
    "no_drop": (dict(), dict(no_drop=True), (2, 24), 1.0),
    "shared": (dict(n_shared=2, d_ff_shared=24), dict(), (2, 24), 1.0),
    "ties": (dict(), dict(), (2, 12), 0.0),
    "bf16": (dict(dtype="bf16"), dict(), (2, 24), 1.0),
    "no_norm_topk": (dict(norm_topk=False, n_shared=1), dict(), (1, 16), 1.0),
}
D, F_EXPERT, E, K = 32, 16, 8, 2


def _moe_pair(kw, router_scale, seed=11):
    """The reference's MoE and the port's on one set of seeded parameters
    (numpy, fp32; cast to the model dtype on both sides)."""
    bf16 = kw.get("dtype") == "bf16"
    kw = {k: v for k, v in kw.items() if k != "dtype"}
    jlayer = j_moe.MoE(d_model=D, d_ff_expert=F_EXPERT, n_experts=E, top_k=K,
                       dtype=jnp.bfloat16 if bf16 else jnp.float32, **kw)
    tlayer = t_moe.MoE(D, F_EXPERT, E, K, dtype=torch.bfloat16 if bf16 else torch.float32, **kw)
    assert set(jlayer.defs()) == set(tlayer.param_defs)
    rng = np.random.default_rng(seed)
    jp, state = {}, {}
    for name, d in jlayer.defs().items():
        val = (rng.standard_normal(d.shape) / np.sqrt(d.shape[-2])).astype(np.float32)
        if name == "router":
            val = val * router_scale
        assert tuple(tlayer.param_defs[name].shape) == tuple(d.shape)
        jp[name] = jnp.asarray(val).astype(d.dtype)
        state[name] = _t(val).to(tlayer.param_defs[name].dtype)
    assert state["router"].dtype == torch.float32 and jp["router"].dtype == jnp.float32
    return jlayer, jp, materialize(tlayer, state, "cpu")


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_layer_matches_jax(case):
    kw, call, (B, S), router_scale = MOE_CASES[case]
    jlayer, jp, tlayer = _moe_pair(kw, router_scale)
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    x = np.random.default_rng(12).standard_normal((B, S, D)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if case == "bf16" else jnp.float32)
    with j_tracer.trace() as jt:
        gold, gold_aux = jlayer(jp, xj, **call)
    with tracer.trace() as tt:
        out, aux = tlayer(_t(x).to(dtype), **call)
    assert out.dtype == dtype and tuple(out.shape) == (B, S, D)
    tol = BF16 if case == "bf16" else LAYER
    _close_to_scale(out.float().numpy(), gold, tol)
    _close_to_scale(np.asarray([aux.item()]), np.asarray([float(gold_aux)]), tol)
    assert _events(tt) == _events(jt)
    assert [e.op for e in tt.events] == ["linear"] + ["linear"] * bool(
        kw.get("n_shared")) + ["dispatch"]
    # what the case is for
    _, _, top_i = tlayer.route(_t(x).to(dtype).reshape(B * S, D))
    load = torch.bincount(top_i.reshape(-1), minlength=E)
    C = tlayer.capacity(B * S, **call)
    dropped = int((load - C).clamp(min=0).sum())
    if case in ("drops", "ties", "shared"):
        assert dropped > 0, (load, C)
    if case == "no_drop":
        assert C == B * S * K and dropped == 0
    if case == "ties":  # every probability 1/E: experts 0 and 1, in that order
        assert (top_i == torch.tensor([0, 1])).all()
        np.testing.assert_array_equal(np.asarray(jax.lax.top_k(
            jnp.full((3, E), 1.0 / E), K)[1]), np.tile([0, 1], (3, 1)))


def test_top_k_breaks_ties_as_jax():
    """Ties at every rank, in several places of each row: the indices of
    ``jax.lax.top_k``, lower index first."""
    rng = np.random.default_rng(13)
    p = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4.0
    vals, idx = t_moe.top_k_lower_index_first(_t(p), 6)
    jvals, jidx = jax.lax.top_k(jnp.asarray(p), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("n_experts,skew", [(8, 0.0), (64, 0.0), (128, 2.0), (8, "one")])
def test_position_in_expert_is_the_references_exclusive_cumsum(n_experts, skew):
    """Each assignment's row in its expert, from the port's stable sort,
    equals the reference's ``cumsum(one_hot) - one_hot`` (``moe.py``) in
    token-major then k order: uniform, skewed, and all to one expert."""
    rng = np.random.default_rng(18)
    if skew == "one":
        eid = np.full(300, 3)
    else:
        w = np.exp(skew * rng.standard_normal(n_experts))
        eid = rng.choice(n_experts, size=4096, p=w / w.sum())
    one_hot = np.eye(n_experts, dtype=np.int64)[eid]
    want = np.sum((np.cumsum(one_hot, axis=0) - one_hot) * one_hot, axis=-1)
    got = t_moe._position_in_expert(torch.from_numpy(eid), n_experts)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dropped_assignments_give_zero_and_the_rest_keep_their_weight():
    """At capacity 1 with top-1 and a router that sends every token to
    expert 0, only the first token is served: the others' routed output is
    0, the first one's is its expert's output times its (renormalized)
    weight, with no renormalization over the kept assignments."""
    layer = t_moe.MoE(8, 4, 4, 1, capacity_factor=1.0)
    rng = np.random.default_rng(14)
    state = {k: _t(rng.standard_normal(d.shape).astype(np.float32))
             for k, d in layer.param_defs.items()}
    state["router"] = torch.zeros((8, 4))
    state["router"][:, 0] = 1.0
    layer = materialize(layer, state, "cpu")
    x = torch.from_numpy(np.abs(rng.standard_normal((1, 4, 8))).astype(np.float32))
    y, _ = layer(x)
    assert layer.capacity(4) == 1
    assert torch.equal(y[0, 1:], torch.zeros((3, 8)))
    h = torch.nn.functional.silu(x[0, 0] @ layer.wg[0]) * (x[0, 0] @ layer.wi[0])
    torch.testing.assert_close(y[0, 0], h @ layer.wo[0], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# qk-norm attention (Qwen3)
# ---------------------------------------------------------------------------


def _qk_norm_pair():
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16)
    jattn = j_attention.Attention(**kw, qk_norm=True, rope=True, rope_base=1e6, causal=True)
    tattn = t_attention.Attention(64, 4, 16, n_kv_heads=2, qk_norm=True, rope=True,
                                  rope_base=1e6, causal=True)
    rng = np.random.default_rng(15)
    jp, state = {}, {}
    for key, d in flatten_tree(jattn.defs()).items():
        val = (rng.standard_normal(d.shape) / np.sqrt(d.shape[0])).astype(np.float32)
        if key.endswith("norm.scale"):
            val = (1.0 + 0.3 * rng.standard_normal(d.shape)).astype(np.float32)
        state[key] = _t(val)
        node = jp
        for p in key.split(".")[:-1]:
            node = node.setdefault(p, {})
        node[key.split(".")[-1]] = jnp.asarray(val)
    assert {"q_norm.scale", "k_norm.scale"} <= set(state)
    assert set(state) == set(param_defs(tattn))
    return jattn, jp, materialize(tattn, state, "cpu")


def test_qk_norm_attention_prefill_matches_jax():
    jattn, jp, tattn = _qk_norm_pair()
    rng = np.random.default_rng(16)
    x = (3.0 * rng.standard_normal((2, 11, 64))).astype(np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    with j_tracer.trace() as jt:
        gold, gold_kv = jattn(jp, jnp.asarray(x), positions=jnp.asarray(pos),
                              impl="interpret", return_kv=True)
    with tracer.trace() as tt:
        out, kv = tattn(_t(x), positions=_t(pos), impl="kernel", return_kv=True)
    _close_to_scale(out.numpy(), gold, LAYER)
    _close_to_scale(kv.k.numpy(), gold_kv.k, LAYER)  # normalized, then rotated
    _close_to_scale(kv.v.numpy(), gold_kv.v, LAYER)
    got = [(e.op, e.name, e.flops, e.bytes_hbm) for e in tt.events]
    assert got == [(e.op, e.name, e.flops, e.bytes_hbm) for e in jt.events]
    assert [n for op, n, *_ in got if op == "norm"] == ["rmsnorm", "rmsnorm"]


def test_qk_norm_attention_decode_matches_jax():
    """Four decode steps from 3 prefilled rows: q and the new k normalized
    before RoPE at each position; the cross branch normalizes q only."""
    jattn, jp, tattn = _qk_norm_pair()
    rng = np.random.default_rng(17)
    k0 = np.zeros((2, 8, 2, 16), np.float32)
    v0 = np.zeros((2, 8, 2, 16), np.float32)
    k0[:, :3], v0[:, :3] = rng.standard_normal((2, 2, 3, 2, 16))
    jcache = j_attention.AttentionCache(k=jnp.asarray(k0), v=jnp.asarray(v0))
    tcache = t_attention.AttentionCache(_t(k0.copy()), _t(v0.copy()))
    for cur in range(3, 7):
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        gold, jcache = jattn.decode(jp, jnp.asarray(x), jcache, jnp.int32(cur))
        out, tcache = tattn.decode(_t(x), tcache, cur)
        _close_to_scale(out.numpy(), gold, LAYER)
        _close_to_scale(tcache.k.numpy(), jcache.k, LAYER)
    jcross = dataclasses.replace(jattn, cross=True, rope=False, causal=False)
    tattn.cross, tattn.rope = True, False
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    gold, _ = jcross.decode(jp, jnp.asarray(x), None, jnp.int32(0), cross_cache=jcache)
    out, _ = tattn.decode(_t(x), None, 0, cross_cache=tcache)
    _close_to_scale(out.numpy(), gold, LAYER)


# ---------------------------------------------------------------------------
# Configs, leaves and the bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_its_reduction_match_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert _plain(cfg) == _plain(jcfg)
    assert cfg.dtype == torch.float32 and cfg.source == jcfg.source and cfg.source
    assert cfg.block_types() == jcfg.block_types()
    assert _plain(reduced(cfg)) == _plain(j_reduced(jcfg))
    assert _plain(workload_for(cfg).reduced()) == _plain(j_reduced(jcfg))
    assert reduced(cfg).moe.capacity_factor == 8.0


def test_registry_lists_the_moe_archs_in_the_references_order():
    assert t_configs.ASSIGNED_ARCHS == [
        a for a in j_configs.ASSIGNED_ARCHS if a in t_configs.ASSIGNED_ARCHS]
    assert set(ARCHS) <= set(t_configs.ASSIGNED_ARCHS) <= set(t_configs.list_configs())


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_leaves_and_param_counts_are_the_references(arch):
    """Keys and shapes of the port's declared leaves (on ``meta``) equal the
    reference's abstract tree; without the norm scales they count the
    reference's ``param_count()``."""
    jcfg = j_get_config(arch)
    abstract = jax.eval_shape(j_workload_for(jcfg).init, jax.random.PRNGKey(0))
    j_shapes = {k: tuple(v.shape) for k, v in flatten_tree(abstract).items()}
    model = workload_for(get_config(arch)).model
    t_defs = param_defs(model)
    assert {k: d.shape for k, d in t_defs.items()} == j_shapes
    assert all(p.device.type == "meta" for p in model.parameters())
    n = {k: int(np.prod(d.shape)) for k, d in t_defs.items()}
    assert sum(v for k, v in n.items() if "norm" not in k) == jcfg.param_count()
    if arch == "deepseek-moe-16b":
        assert [g for g in model.groups] == [("dense", 1), ("moe", 27)]
        assert t_defs["blocks.g1_moe.moe.wi"].shape == (27, 64, 2048, 1408)
        assert t_defs["blocks.g1_moe.moe.router"].dtype == torch.float32
        assert t_defs["blocks.g0_dense.mlp.wi.kernel"].shape == (1, 2048, 10944)
        assert t_defs["blocks.g1_moe.moe.shared_wo"].shape == (27, 2816, 2048)
        assert round(sum(n.values()) / 1e9, 1) == 16.4
    else:
        assert t_defs["blocks.g0_moe.attn.q_norm.scale"].shape == (48, 128)
        assert t_defs["blocks.g0_moe.moe.wo"].shape == (48, 128, 768, 2048)
        assert round(sum(n.values()) / 1e9, 1) == 30.5


@pytest.mark.parametrize("arch", ARCHS)
def test_cost_descriptor_matches_jax(arch):
    for jcfg, tcfg in ((j_get_config(arch), get_config(arch)),
                       (j_reduced(j_get_config(arch)), reduced(get_config(arch)))):
        jcd, tcd = j_workload_for(jcfg).cost_descriptor(), workload_for(tcfg).cost_descriptor()
        assert (tcd.arch, tcd.route) == (jcd.arch, jcd.route)
        assert [dataclasses.astuple(s) for s in tcd.stages] == [
            dataclasses.astuple(s) for s in jcd.stages]
        assert tcd.step_demands() == jcd.step_demands()


def _reference_tree(abstract: dict, state: dict, seed: int = 3, path: str = "") -> dict:
    """The port's seeded values in the reference's tree structure, every
    norm scale drawn around 1 so that no leaf is trivial."""
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
        out[arch] = dict(jwl=jwl, tree=tree, params=params, tokens=tokens, out=gen,
                         state=from_jax_params(tree))
    return out


def _port(run, arch):
    twl = reduced_workload(get_config(arch))
    return twl, twl.load(run["state"], device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_stacked_expert_leaves_bridge_unchanged(runs, arch):
    """The reference's stacked 4-D expert leaves load as they are: the same
    keys, shapes and values, no restacking."""
    run = runs[arch]
    group = "g1_moe" if arch == "deepseek-moe-16b" else "g0_moe"
    wi = run["tree"]["blocks"][group]["moe"]["wi"]
    n = 3 if arch == "deepseek-moe-16b" else 4
    assert wi.shape == (n, 8, 64, 32)
    twl = reduced_workload(get_config(arch))
    assert set(run["state"]) == set(param_defs(twl.model))
    model = materialize(twl.model, run["state"], "cpu")
    stacked = getattr(model.blocks, group).moe
    np.testing.assert_array_equal(stacked.wi.numpy(), wi)
    np.testing.assert_array_equal(model.layers()[-1][1].moe.wo.numpy(),
                                  run["tree"]["blocks"][group]["moe"]["wo"][1])


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
    for got, want in zip(caches, gold_caches):
        _close_to_scale(got["attn"].k.numpy(), want["attn"].k)
        _close_to_scale(got["attn"].v.numpy(), want["attn"].v)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_greedy_tokens_equal_jax(runs, arch, impl):
    run = runs[arch]
    twl, model = _port(run, arch)
    out = twl.generate(model, run["tokens"], 0, impl=impl, device="cpu", max_new_tokens=NEW)
    assert tuple(out.shape) == run["out"].shape == (2, NEW)
    np.testing.assert_array_equal(out.numpy(), run["out"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_full_forward(runs, arch):
    """prefill + step-by-step decode (``no_drop``) == the full forward, as the
    reference's ``test_decode_matches_forward``: capacity 8.0 drops nothing."""
    run = runs[arch]
    _, model = _port(run, arch)
    S0, EXTRA = 12, 4
    toks = _t(run["tokens"]).long()
    with torch.inference_mode():
        full = model(toks, impl="kernel")
        last, caches, _ = model.prefill(toks[:, :S0], impl="kernel", max_len=S0 + EXTRA)
        errs = [(last[:, 0] - full[:, S0 - 1]).abs().max().item()]
        for i in range(EXTRA):
            lg, caches = model.decode_step(toks[:, S0 + i:S0 + i + 1], caches, S0 + i)
            errs.append((lg[:, 0] - full[:, S0 + i]).abs().max().item())
    assert max(errs) < 1e-4, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_reduced_moe_lm(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <moe> --reduced`` takes the
    MoE configs with no MoE logic of its own: the lm route, prefill then
    decode."""
    from repro_torch.launch import serve as launcher

    results = launcher.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "2",
                             "--max-new", "4"])
    out = capsys.readouterr().out
    assert sorted(results) == [0, 1] and all(len(v) == 4 for v in results.values())
    assert f"arch {arch}-reduced | route lm | stages prefillx1 -> decodex64" in out
