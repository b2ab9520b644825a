"""Parity of the port's sub-quadratic LMs (``mamba2-780m``,
``recurrentgemma-9b``) with the JAX package.

What the two families add to the dense LMs: the short causal depthwise conv
(``models/layers/conv.py::CausalDepthwiseConv1D``), the Mamba-2 SSD mixer
(``models/layers/ssm.py``), the Griffin RG-LRU block
(``models/layers/rglru.py``), local-window attention with its ring-buffer
decode cache, ``decode_attention``'s ``window``, and a recurrent decode
state in place of a KV cache.

Each layer runs in both packages on one set of seeded numpy parameters at
small widths, forward and ``step``, within 2e-5 in fp32: the mixer over one
padded chunk (S = 12) and three chunks (S = 40), and from an initial state;
the RG-LRU over 40 tokens from a nonzero ``h0`` (the port's doubling scan
groups its products otherwise than ``jax.lax.associative_scan``, so the two
agree to the tolerance, not bit for bit).  Local attention runs a 13-token
prompt through a window of 8, the ring laid out by the reference's
``_to_capacity`` (rolled by 5), then 8 decode steps that wrap the ring.
Each reduced config (``configs.reduced``) runs on one seeded tree, handed to
JAX in the reference's structure and bridged unchanged; JAX runs on the
``interpret`` tier, so recurrentgemma's prefill reaches the Pallas
flash-attention kernel's window branch in interpret mode.  Greedy tokens
must equal the reference's live output.  The full-width event streams are
in ``tests/test_torch_trace_parity_recurrent.py``.
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
from repro.kernels.flash_attention import ops as j_attn_ops
from repro.models import transformer as j_transformer
from repro.models.layers import attention as j_attention
from repro.models.layers import conv as j_conv
from repro.models.layers import rglru as j_rglru
from repro.models.layers import ssm as j_ssm
from repro.workload import workload_for as j_workload_for
from repro_torch import configs as t_configs
from repro_torch.configs import get_config, reduced
from repro_torch.core import tracer
from repro_torch.kernels.flash_attention import ops as t_attn_ops
from repro_torch.models import transformer as t_transformer
from repro_torch.models.layers import attention as t_attention
from repro_torch.models.layers import conv as t_conv
from repro_torch.models.layers import rglru as t_rglru
from repro_torch.models.layers import ssm as t_ssm
from repro_torch.nn import from_jax_params, init_params, materialize, param_defs
from repro_torch.nn.module import flatten_tree
from repro_torch.workload import reduced_workload, workload_for

ARCHS = ["mamba2-780m", "recurrentgemma-9b"]
LAYER = dict(rtol=2e-5, atol=2e-5)
CHAIN = dict(rtol=1e-4, atol=1e-4)
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


def _leaf(key: str, shape, rng) -> np.ndarray:
    """A seeded value for a leaf, none of them trivial: weights scaled by
    their fan-in, norm scales and ``D`` around 1, biases small, ``A_log``
    and ``lam`` over the reference's init ranges."""
    name = key.split(".")[-1]
    if name == "A_log":
        return np.log(rng.uniform(1.0, 16.0, shape)).astype(np.float32)
    if name == "lam":
        return rng.uniform(2.0, 7.0, shape).astype(np.float32)
    if name in ("scale", "D"):
        return (1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    if len(shape) == 1:  # biases, dt_bias
        return (0.3 * rng.standard_normal(shape)).astype(np.float32)
    return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)


def _pair(jlayer, tlayer, seed):
    """The reference's layer and the port's on one set of seeded parameters."""
    rng = np.random.default_rng(seed)
    jp, state = {}, {}
    for key, d in flatten_tree(jlayer.defs()).items():
        val = _leaf(key, d.shape, rng)
        state[key] = _t(val)
        node = jp
        for p in key.split(".")[:-1]:
            node = node.setdefault(p, {})
        node[key.split(".")[-1]] = jnp.asarray(val)
    assert set(state) == set(param_defs(tlayer))
    return jp, materialize(tlayer, state, "cpu")


# ---------------------------------------------------------------------------
# The layers
# ---------------------------------------------------------------------------


def test_causal_depthwise_conv_matches_jax():
    """Forward over 13 tokens (the reference's grouped conv event), then 3
    steps from the forward's last 3 raw inputs."""
    jl, tl = j_conv.CausalDepthwiseConv1D(24, 4), t_conv.CausalDepthwiseConv1D(24, 4)
    jp, tl = _pair(jl, tl, 20)
    x = np.random.default_rng(21).standard_normal((2, 13, 24)).astype(np.float32)
    with j_tracer.trace() as jt:
        gold = jl(jp, jnp.asarray(x))
    with tracer.trace() as tt:
        out = tl(_t(x))
    _close_to_scale(out.numpy(), gold, LAYER)
    assert _events(tt) == _events(jt) and [e.op for e in tt.events] == ["conv"]
    jst, tst = jnp.asarray(x[:, -3:]), _t(x[:, -3:])
    for i in range(3):
        xn = np.random.default_rng(22 + i).standard_normal((2, 24)).astype(np.float32)
        gy, jst = jl.step(jp, jnp.asarray(xn), jst)
        ty, tst = tl.step(_t(xn), tst)
        _close_to_scale(ty.numpy(), gy, LAYER)
        _close_to_scale(tst.numpy(), jst, LAYER)


# d_model 32, d_state 8, head_dim 16 (4 heads), chunk 16
MIXER = dict(d_model=32, d_state=8, d_conv=4, expand=2, head_dim=16, chunk=16)


def _mixer_pair(seed=23):
    jl = j_ssm.Mamba2Mixer(**MIXER)
    return (jl,) + _pair(jl, t_ssm.Mamba2Mixer(**MIXER), seed)


@pytest.mark.parametrize("S,init", [(12, False), (40, False), (40, True)],
                         ids=["one_padded_chunk", "three_chunks", "initial_state"])
def test_mamba2_mixer_matches_jax(S, init):
    jl, jp, tl = _mixer_pair()
    rng = np.random.default_rng(24)
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    jinit = tinit = None
    if init:
        ssm0 = rng.standard_normal((2, 4, 16, 8)).astype(np.float32)
        conv0 = np.zeros((2, 3, tl.conv_dim), np.float32)
        jinit = j_ssm.Mamba2State(ssm=jnp.asarray(ssm0), conv=jnp.asarray(conv0))
        tinit = t_ssm.Mamba2State(_t(ssm0), _t(conv0))
    with j_tracer.trace() as jt:
        gold, gst = jax.jit(jl.__call__)(jp, jnp.asarray(x), initial_state=jinit)
    with tracer.trace() as tt:
        out, st = tl(_t(x), initial_state=tinit)
    _close_to_scale(out.numpy(), gold, LAYER)
    _close_to_scale(st.ssm.numpy(), gst.ssm, LAYER)
    _close_to_scale(st.conv.numpy(), gst.conv, LAYER)
    assert _events(tt) == _events(jt)
    assert [e.op for e in tt.events] == ["linear", "conv", "norm", "linear", "scan"]


def test_mamba2_step_continues_the_forward_as_jax():
    """Three decode steps from the state a 12-token forward leaves."""
    jl, jp, tl = _mixer_pair()
    rng = np.random.default_rng(25)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    _, jst = jax.jit(jl.__call__)(jp, jnp.asarray(x))
    _, tst = tl(_t(x))
    jstep = jax.jit(jl.step)  # traced once: the reference records its events then
    for i in range(3):
        xn = rng.standard_normal((2, 1, 32)).astype(np.float32)
        with j_tracer.trace() as jt:
            gold, jst = jstep(jp, jnp.asarray(xn), jst)
        with tracer.trace() as tt:
            out, tst = tl.step(_t(xn), tst)
        _close_to_scale(out.numpy(), gold, LAYER)
        _close_to_scale(tst.ssm.numpy(), jst.ssm, LAYER)
        _close_to_scale(tst.conv.numpy(), jst.conv, LAYER)
        if i == 0:
            assert _events(tt) == _events(jt)
            assert [e.name for e in tt.events if e.op == "scan"] == ["mamba2_step"]


def test_mamba2_init_is_the_references():
    """``A_log = log(linspace(1, 16, H))``, ``dt_bias`` 0 and ``D`` 1, as the
    reference's deterministic inits (``torch.linspace`` and ``jnp.linspace``
    round some points apart by an ulp)."""
    defs = j_ssm.Mamba2Mixer(**MIXER).defs()
    jp = {k: defs[k].init(jax.random.PRNGKey(0), defs[k].shape, defs[k].dtype)
          for k in ("A_log", "dt_bias", "D")}
    tp = init_params(t_ssm.Mamba2Mixer(**MIXER), 0)
    for k in ("A_log", "dt_bias", "D"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=2.5e-7, atol=0)


def _rglru_pair(seed=26):
    jl = j_rglru.RGLRUBlock(d_model=32, d_rnn=24)
    return (jl,) + _pair(jl, t_rglru.RGLRUBlock(32, 24), seed)


def test_rglru_block_matches_jax_from_a_nonzero_state():
    """40 tokens from a nonzero ``h0`` (and a conv window the forward does
    not read, as the reference's), then 3 decode steps."""
    jl, jp, tl = _rglru_pair()
    rng = np.random.default_rng(27)
    x = rng.standard_normal((2, 40, 32)).astype(np.float32)
    h0 = rng.standard_normal((2, 24)).astype(np.float32)
    conv0 = np.zeros((2, 3, 24), np.float32)
    with j_tracer.trace() as jt:
        gold, jst = jax.jit(jl.__call__)(jp, jnp.asarray(x), initial_state=j_rglru.RGLRUState(
            hidden=jnp.asarray(h0), conv=jnp.asarray(conv0)))
    with tracer.trace() as tt:
        out, tst = tl(_t(x), initial_state=t_rglru.RGLRUState(_t(h0), _t(conv0)))
    _close_to_scale(out.numpy(), gold, LAYER)
    _close_to_scale(tst.hidden.numpy(), jst.hidden, LAYER)
    _close_to_scale(tst.conv.numpy(), jst.conv, LAYER)
    assert _events(tt) == _events(jt)
    assert [e.op for e in tt.events] == ["linear", "linear", "conv", "linear", "scan"]
    jstep = jax.jit(jl.step)  # traced once: the reference records its events then
    for i in range(3):
        xn = rng.standard_normal((2, 1, 32)).astype(np.float32)
        with j_tracer.trace() as jt:
            gold, jst = jstep(jp, jnp.asarray(xn), jst)
        with tracer.trace() as tt:
            out, tst = tl.step(_t(xn), tst)
        _close_to_scale(out.numpy(), gold, LAYER)
        _close_to_scale(tst.hidden.numpy(), jst.hidden, LAYER)
        if i == 0:
            assert _events(tt) == _events(jt)


def test_rglru_init_is_the_references():
    """``lam = linspace(2, 7, D)`` (to an ulp) and zero gate biases."""
    defs = j_rglru.RGLRUBlock(d_model=32, d_rnn=24).defs()
    jp = {k: defs[k].init(jax.random.PRNGKey(0), defs[k].shape, defs[k].dtype)
          for k in ("lam", "b_a", "b_x")}
    tp = init_params(t_rglru.RGLRUBlock(32, 24), 0)
    for k in ("lam", "b_a", "b_x"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=2.5e-7, atol=0)


@pytest.mark.parametrize("S", [1, 2, 5, 64, 3072])
def test_lru_scan_is_the_linear_recurrence(S):
    """The doubling scan against the recurrence written out in float64,
    from a nonzero ``h0``, at lengths around and past powers of two (3072:
    recurrentgemma's chip prompt, 12 doubling steps)."""
    rng = np.random.default_rng(28)
    la = -rng.uniform(0.0, 0.5, (2, S, 3))
    b = rng.standard_normal((2, S, 3))
    h0 = rng.standard_normal((2, 3))
    got = t_rglru.lru_scan(*(torch.from_numpy(a.astype(np.float32)) for a in (la, b, h0)))
    want, h = np.empty_like(b), h0
    for t in range(S):
        h = np.exp(la[:, t]) * h + b[:, t]
        want[:, t] = h
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# Local-window attention and decode attention's window
# ---------------------------------------------------------------------------


def test_local_attention_ring_matches_jax():
    """A 13-token prompt through a window of 8 (the flash kernel's window
    branch, interpret mode on the reference's side), its keys and values
    laid out as the ring of 8 rows rolled by 13 % 8 = 5, then 8 decode steps
    at positions 13..20 that write rows 5, 6, 7, 0, ..., 4 (the ring wraps)."""
    kw = dict(d_model=64, n_heads=4, n_kv_heads=1, head_dim=16)
    jattn = j_attention.Attention(**kw, rope=True, causal=True, window=8)
    tattn = t_attention.Attention(64, 4, 16, n_kv_heads=1, rope=True, causal=True, window=8)
    jp, tattn = _pair(jattn, tattn, 29)
    rng = np.random.default_rng(30)
    x = rng.standard_normal((2, 13, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(13, dtype=np.int32), (2, 13))
    with j_tracer.trace() as jt:
        gold, jkv = jax.jit(jattn.__call__, static_argnames=("impl", "return_kv"))(
            jp, jnp.asarray(x), positions=jnp.asarray(pos), impl="interpret", return_kv=True)
    with tracer.trace() as tt:
        out, tkv = tattn(_t(x), positions=_t(pos), impl="interpret", return_kv=True)
    _close_to_scale(out.numpy(), gold, LAYER)
    assert _events(tt) == _events(jt)
    jring = j_transformer._to_capacity(
        j_attention.AttentionCache(k=jkv.k[None], v=jkv.v[None]), 13, 21, window=8)
    tring = t_attention.AttentionCache(*(t_transformer._ring(a, 13, 8) for a in tkv))
    for got, want in zip(tring, jring):
        _close_to_scale(got.numpy(), want[0], LAYER)
    for p in range(5, 13):  # position p in row p % 8
        np.testing.assert_array_equal(tring.k[:, p % 8].numpy(), tkv.k[:, p].numpy())
    jcache = j_attention.AttentionCache(k=jring.k[0], v=jring.v[0])
    jdecode = jax.jit(jattn.decode)  # traced once: the reference records its events then
    for cur in range(13, 21):
        xn = rng.standard_normal((2, 1, 64)).astype(np.float32)
        with j_tracer.trace() as jt:
            gold, jcache = jdecode(jp, jnp.asarray(xn), jcache, jnp.int32(cur))
        with tracer.trace() as tt:
            out, tring = tattn.decode(_t(xn), tring, cur)
        _close_to_scale(out.numpy(), gold, LAYER)
        _close_to_scale(tring.k.numpy(), jcache.k, LAYER)
        _close_to_scale(tring.v.numpy(), jcache.v, LAYER)
        if cur == 13:
            assert _events(tt) == _events(jt)


@pytest.mark.parametrize("kv_len", ["one", "per-request"])
@pytest.mark.parametrize("window", [None, 1, 5, 40])
def test_decode_attention_window_matches_jax(kv_len, window):
    """Keys below ``kv_len - window`` and at or past ``kv_len`` are masked,
    MQA over a cache of 24 rows; an int ``kv_len`` reads only the rows in
    the window."""
    rng = np.random.default_rng(31)
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    kc, vc = rng.standard_normal((2, 3, 24, 1, 16)).astype(np.float32)
    lens = np.array([17, 17, 17] if kv_len == "one" else [24, 9, 1], np.int32)
    gold = j_attn_ops.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                       kv_len=jnp.asarray(lens), window=window)
    arg = 17 if kv_len == "one" else _t(lens)
    out = t_attn_ops.decode_attention(_t(q), _t(kc), _t(vc), kv_len=arg, window=window)
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


def test_registry_lists_the_archs_in_the_references_order():
    assert t_configs.ASSIGNED_ARCHS == [
        a for a in j_configs.ASSIGNED_ARCHS if a in t_configs.ASSIGNED_ARCHS]
    assert set(ARCHS) <= set(t_configs.ASSIGNED_ARCHS) <= set(t_configs.list_configs())


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_leaves_and_param_counts_are_the_references(arch):
    """Keys and shapes of the port's declared leaves (on ``meta``) equal the
    reference's abstract tree; without the norm scales, the RG-LRU's gate
    biases, ``lam`` and the convs (which its analytic count leaves out),
    they count the reference's ``param_count()``."""
    jcfg = j_get_config(arch)
    abstract = jax.eval_shape(j_workload_for(jcfg).init, jax.random.PRNGKey(0))
    j_shapes = {k: tuple(v.shape) for k, v in flatten_tree(abstract).items()}
    model = workload_for(get_config(arch)).model
    t_defs = param_defs(model)
    assert {k: d.shape for k, d in t_defs.items()} == j_shapes
    assert all(p.device.type == "meta" for p in model.parameters())
    n = {k: int(np.prod(d.shape)) for k, d in t_defs.items()}
    if arch == "mamba2-780m":
        assert model.groups == [("mamba2", 48)]
        assert t_defs["blocks.g0_mamba2.mixer.in_proj.kernel"].shape == (48, 1536, 6448)
        assert t_defs["blocks.g0_mamba2.mixer.conv.kernel"].shape == (48, 4, 3328)
        extra = ("norm", "conv", "dt_bias", "A_log", ".D")
        assert round(sum(n.values()) / 1e6, 1) == 780.1
    else:
        assert model.groups[:3] == [("rglru", 2), ("local_attn", 1), ("rglru", 2)]
        assert len(model.groups) == 25
        assert t_defs["blocks.g1_local_attn.attn.wk.kernel"].shape == (1, 4096, 256)
        assert t_defs["blocks.g0_rglru.rglru.w_a"].shape == (2, 4096, 4096)
        extra = ("norm", "conv", "b_a", "b_x", "lam", "bias")
        assert round(sum(n.values()) / 1e9, 2) == 9.40
    assert sum(v for k, v in n.items() if not any(e in k for e in extra)) == jcfg.param_count()


VECTORS = ("scale", "D", "A_log", "lam", "dt_bias", "b_a", "b_x", "bias")


def _reference_tree(abstract: dict, state: dict, seed: int = 3, path: str = "") -> dict:
    """The port's seeded values in the reference's tree structure, every
    vector leaf (norm scales, biases, the SSM's and RG-LRU's vectors) drawn
    by :func:`_leaf`, layer by layer in a stacked group, so that none is
    trivial."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in abstract.items():
        key = f"{path}.{k}" if path else k
        if isinstance(v, dict):
            out[k] = _reference_tree(v, state, seed + len(out) + 1, key)
        elif k in VECTORS:
            shape = tuple(v.shape)
            out[k] = (np.stack([_leaf(k, shape[1:], rng) for _ in range(shape[0])])
                      if key.startswith("blocks.") else _leaf(k, shape, rng))
        else:
            out[k] = state[key].numpy()
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
def test_reduced_prefill_logits_and_states_match_jax(runs, arch):
    """The prefill's logits and every group's state: the ring of each local
    window (8 rows of a 16-token prompt, rolled by 0), the SSM's and the
    RG-LRU's recurrent and conv states."""
    run = runs[arch]
    cap = PROMPT + NEW
    gold, gold_caches, _ = jax.jit(run["jwl"].model.prefill, static_argnames=(
        "impl", "max_len"))(run["params"], jnp.asarray(run["tokens"]), impl="interpret",
                            max_len=cap)
    _, model = _port(run, arch)
    with torch.inference_mode():
        logits, caches, _ = model.prefill(_t(run["tokens"]).long(), impl="kernel", max_len=cap)
    assert tuple(logits.shape) == (2, 1, 256)
    _close_to_scale(logits.numpy(), gold)
    assert [set(c) for c in caches] == [set(c) for c in gold_caches]
    for got, want in zip(caches, gold_caches):
        (key, g), = got.items()
        for a, b in zip(g, want[key]):
            assert tuple(a.shape) == tuple(b.shape)
            _close_to_scale(a.numpy(), b)
    if arch == "recurrentgemma-9b":
        assert caches[1]["attn"].k.shape == (1, 2, 8, 1, 16)


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
    """prefill + step-by-step decode == the full forward, as the reference's
    ``test_decode_matches_forward`` (12 + 4 tokens; recurrentgemma's window
    of 8 is a ring of 8 rows rolled by 4, wrapping during the decode)."""
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
def test_launcher_serves_the_reduced_lm(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <arch> --reduced`` takes the
    recurrent states with no logic of its own: the lm route, prefill then
    decode, the states split and restacked per request like KV caches."""
    from repro_torch.launch import serve as launcher

    results = launcher.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "2",
                             "--max-new", "4"])
    out = capsys.readouterr().out
    assert sorted(results) == [0, 1] and all(len(v) == 4 for v in results.values())
    assert f"arch {arch}-reduced | route lm | stages prefillx1 -> decodex64" in out
