"""Kernel parity of the PyTorch/CUDA port against the JAX package.

On the CPU every port kernel wrapper takes its plain version, so these tests
hold the port's plain versions (and the ``kernel`` tier they sit behind)
against the JAX oracles (``ref``) and the Pallas kernels in interpret mode,
on the same numpy inputs.  Tolerances are the repo's own
(``tests/test_kernels.py``): 2e-5 in fp32, 2e-4 for emitted stats, 2e-2 in
bf16.

The same kernels on the card, against these plain versions:
``tests/test_torch_cuda.py`` (marked ``gpu``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d import ops as j_conv_ops
from repro.kernels.conv2d import ref as j_conv_ref
from repro.kernels.flash_attention import ops as j_fa_ops
from repro.kernels.flash_attention import ref as j_fa_ref
from repro.kernels.groupnorm_silu import ops as j_gn_ops
from repro.kernels.groupnorm_silu import ref as j_gn_ref
from repro_torch.kernels import build
from repro_torch.kernels.conv2d import ops as t_conv_ops
from repro_torch.kernels.flash_attention import ops as t_fa_ops
from repro_torch.kernels.flash_attention import ref as t_fa_ref
from repro_torch.kernels.groupnorm_silu import ops as t_gn_ops
from repro.kernels.flash_attention import flash_attention as j_fa_kernel
from repro_torch.kernels.conv2d import conv2d as t_conv_kernel
from repro_torch.kernels.flash_attention import flash_attention as t_fa_kernel
from test_torch_cuda import (ATTN_CASES, BF16, CONV_SHAPES, EPILOGUES, F32, STATS, TATTN_CASES,
                             TCONV_CASES, TEMPORAL_F32, _attn_inputs, _close, _conv_case,
                             _tattn_inputs, _tconv_inputs)


# ---------------------------------------------------------------------------
# conv2d
# ---------------------------------------------------------------------------

# tiny Pallas blocks force multi-block grids (row halo + cin/cout reduction)
_CONV_BLOCKS = dict(block_rows=40, block_cin=4, block_cout=8)


def _jax_conv(x, w, kw, impl):
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    if impl == "ref":
        return j_conv_ref.conv2d_ref(jnp.asarray(x), jnp.asarray(w), **kw)
    gn = (kw.pop("gn_a"), kw.pop("gn_b")) if "gn_a" in kw else None
    return j_conv_ops.conv2d(jnp.asarray(x), jnp.asarray(w), gn_affine=gn, impl=impl,
                             **kw, **_CONV_BLOCKS)


def _torch_conv(x, w, kw, impl, dtype=torch.float32):
    kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    if "residual" in kw:
        kw["residual"] = kw["residual"].to(dtype)
    gn = (kw.pop("gn_a"), kw.pop("gn_b")) if "gn_a" in kw else None
    return t_conv_ops.conv2d(torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype),
                             gn_affine=gn, impl=impl, **kw)


def _check_conv(out, gold, emit_stats):
    if emit_stats:
        _close(out[0], gold[0], F32)
        _close(out[1], gold[1], STATS)
    else:
        _close(out, gold, F32)


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv2d_plain_matches_jax(shape):
    """Plain conv over the shape sweep: port kernel tier (plain on CPU) and
    torch tier vs the JAX ref and the Pallas kernel in interpret mode."""
    x, w, kw = _conv_case(shape, {})
    gold = _jax_conv(x, w, kw, "ref")
    interp = _jax_conv(x, w, kw, "interpret")
    for impl in ("kernel", "torch"):
        out = _torch_conv(x, w, kw, impl)
        assert tuple(out.shape) == gold.shape
        _close(out, gold, F32)
        _close(out, interp, F32)


@pytest.mark.parametrize("shape,combo", [(CONV_SHAPES[1], c) for c in EPILOGUES]
                         + [(CONV_SHAPES[2], c) for c in EPILOGUES[-2:]],
                         ids=lambda c: "-".join(sorted(c)) if isinstance(c, dict) else
                         ("odd" if c == CONV_SHAPES[1] else "stride2"))
def test_conv2d_epilogues_match_jax(shape, combo):
    x, w, kw = _conv_case(shape, combo, seed=1)
    emit = kw["emit_stats"]
    gold = _jax_conv(x, w, kw, "ref")
    interp = _jax_conv(x, w, kw, "interpret")
    out = _torch_conv(x, w, kw, "kernel")
    _check_conv(out, gold, emit)
    _check_conv(out, interp, emit)


@pytest.mark.parametrize("shape", CONV_SHAPES[:3])
def test_conv2d_bf16_matches_jax_ref(shape):
    x, w, kw = _conv_case(shape, dict(bias=True, residual=True), seed=2)
    xb, wb, kw["residual"] = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                              for a in (x, w, kw["residual"]))
    jkw = dict(kw, residual=jnp.asarray(kw["residual"], jnp.bfloat16))
    gold = j_conv_ref.conv2d_ref(jnp.asarray(xb, jnp.bfloat16), jnp.asarray(wb, jnp.bfloat16),
                                 **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                    for k, v in jkw.items()})
    out = _torch_conv(xb, wb, kw, "kernel", dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    _close(out, gold.astype(jnp.float32), BF16)


def test_groupnorm_affine_and_stats_match_jax():
    """groupnorm_affine (one-pass variance) and affine_from_stats vs JAX."""
    rng = np.random.default_rng(3)
    y = (rng.standard_normal((2, 6, 5, 16)) * 2 + 0.5).astype(np.float32)
    scale = np.linspace(0.5, 1.5, 16, dtype=np.float32)
    bias = np.linspace(-0.2, 0.2, 16, dtype=np.float32)
    ja = j_conv_ops.groupnorm_affine(jnp.asarray(y), jnp.asarray(scale), jnp.asarray(bias),
                                     groups=4)
    ta = t_conv_ops.groupnorm_affine(torch.from_numpy(y), torch.from_numpy(scale),
                                     torch.from_numpy(bias), groups=4)
    stats = np.stack([y.sum((1, 2)), (y * y).sum((1, 2))], axis=1)
    js = j_conv_ops.affine_from_stats(jnp.asarray(stats), jnp.asarray(scale),
                                      jnp.asarray(bias), groups=4, count=30)
    ts = t_conv_ops.affine_from_stats(torch.from_numpy(stats), torch.from_numpy(scale),
                                      torch.from_numpy(bias), groups=4, count=30)
    for j, t in ((ja, ta), (js, ts)):
        for a, b in zip(j, t):
            _close(b, a, F32)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_attention_matches_jax(case):
    causal, window = case[6], case[7]
    q, k, v = _attn_inputs(case)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    gold = j_fa_ref.attention_ref(jq, jk, jv, causal=causal, window=window)
    interp = j_fa_ops.attention(jq, jk, jv, causal=causal, window=window, impl="interpret",
                                block_q=128, block_kv=128)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for impl in ("kernel", "torch"):
        out = t_fa_ops.attention(tq, tk, tv, causal=causal, window=window, impl=impl)
        assert tuple(out.shape) == gold.shape
        _close(out, gold, F32)
        _close(out, interp, F32)


def test_attention_kv_offset_matches_jax_ref():
    q, k, v = _attn_inputs((1, 8, 40, 2, 2, 16), seed=4)
    gold = j_fa_ref.attention_ref(*map(jnp.asarray, (q, k, v)), causal=True, window=12,
                                  kv_offset=32)
    out = t_fa_ref.attention_ref(*map(torch.from_numpy, (q, k, v)), causal=True, window=12,
                                 kv_offset=32)
    _close(out, gold, F32)


# ---------------------------------------------------------------------------
# temporal attention and temporal conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(Sq=37, Skv=37, H=4, KVH=2, causal=True, window=9, kv_offset=0),
    dict(Sq=21, Skv=40, H=4, KVH=4, causal=True, window=None, kv_offset=19),
    dict(Sq=50, Skv=13, H=3, KVH=3, causal=False, window=None, kv_offset=0),
], ids=["causal-window-gqa", "causal-offset", "cross"])
def test_attention_ref_chunks_query_rows_without_changing_the_result(case, monkeypatch):
    """The plain attention bounds its memory by computing the scores over
    chunks of query rows; the result is the single-chunk one."""
    rng = np.random.default_rng(7)
    B, D = 2, 16
    q = torch.from_numpy(rng.standard_normal((B, case["Sq"], case["H"], D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, case["Skv"], case["KVH"], D)).astype(
        np.float32)) for _ in range(2))
    kw = dict(causal=case["causal"], window=case["window"], kv_offset=case["kv_offset"],
              scale=D ** -0.5)
    whole = t_fa_ref.attention_ref(q, k, v, **kw)
    row_bytes = B * case["H"] * case["Skv"] * 4
    assert t_fa_ref.SCORE_BYTES >= case["Sq"] * row_bytes  # one chunk by default
    for rows in (1, 5, case["Sq"] - 1):  # ragged last chunk included
        monkeypatch.setattr(t_fa_ref, "SCORE_BYTES", rows * row_bytes)
        chunked = t_fa_ref.attention_ref(q, k, v, **kw)
        np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("F,HW", TATTN_CASES)
def test_temporal_attention_matches_jax(F, HW):
    """Port kernel tier (plain on CPU) and torch tier vs the JAX oracle and
    the Pallas kernel in interpret mode (tiny spatial blocks)."""
    q, k, v = _tattn_inputs((2, F, HW, 4, 32), seed=12)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    gold = j_fa_ref.temporal_attention_ref(jq, jk, jv)
    interp = j_fa_ops.temporal_attention(jq, jk, jv, impl="interpret", block_hw=32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for impl in ("kernel", "torch"):
        out = t_fa_ops.temporal_attention(tq, tk, tv, impl=impl)
        assert tuple(out.shape) == gold.shape
        _close(out, gold, TEMPORAL_F32)
        _close(out, interp, TEMPORAL_F32)


@pytest.mark.parametrize("frames_valid", [1, 5, 8])
def test_temporal_attention_frames_valid_matches_pallas(frames_valid):
    """The wrapper's frame mask (plain version on CPU) vs the TPU kernel's
    ``frames_valid`` in interpret mode, which the JAX dispatcher never sets."""
    q, k, v = _tattn_inputs((2, 8, 40, 3, 16), seed=13)
    gold = j_fa_kernel.temporal_flash_attention(
        *map(jnp.asarray, (q, k, v)), scale=0.25, block_hw=8, frames_valid=frames_valid,
        interpret=True)
    out = t_fa_kernel.temporal_flash_attention(*map(torch.from_numpy, (q, k, v)), scale=0.25,
                                               frames_valid=frames_valid)
    _close(out, gold, TEMPORAL_F32)
    with pytest.raises(ValueError, match="frames_valid"):
        t_fa_kernel.temporal_flash_attention(*map(torch.from_numpy, (q, k, v)), scale=0.25,
                                             frames_valid=9)


@pytest.mark.parametrize("case", TCONV_CASES, ids=lambda c: "x".join(map(str, c)))
def test_temporal_conv1d_matches_jax(case):
    x, w, b = _tconv_inputs(*case, seed=14)
    jx, jw, jb = map(jnp.asarray, (x, w, b))
    gold = j_conv_ref.temporal_conv1d_ref(jx, jw, jb)
    interp = j_conv_ops.temporal_conv1d(jx, jw, jb, impl="interpret", block_n=16)
    for impl in ("kernel", "torch"):
        out = t_conv_ops.temporal_conv1d(*map(torch.from_numpy, (x, w, b)), impl=impl)
        assert tuple(out.shape) == gold.shape
        _close(out, gold, F32)
        _close(out, interp, F32)


def test_temporal_conv1d_wide_taps_and_bf16_match_jax_ref():
    """K=5, and bf16 inputs (weights cast to the input type before the conv,
    as in the reference).  The reference oracle takes C_out == C only (its
    output reshape uses C)."""
    x, w, b = _tconv_inputs(6, 3, 2, 5, K=5, seed=15)
    gold = j_conv_ref.temporal_conv1d_ref(*map(jnp.asarray, (x, w, b)))
    _close(t_conv_ops.temporal_conv1d(*map(torch.from_numpy, (x, w, b)), impl="kernel"),
           gold, F32)
    xb = jnp.asarray(x, jnp.bfloat16)
    gold = j_conv_ref.temporal_conv1d_ref(xb, jnp.asarray(w), jnp.asarray(b))
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    out = t_conv_ops.temporal_conv1d(xt, torch.from_numpy(w), torch.from_numpy(b), impl="kernel")
    assert out.dtype == torch.bfloat16
    _close(out, gold.astype(jnp.float32), BF16)


# ---------------------------------------------------------------------------
# groupnorm + silu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape", [(2, 100, 64, 8), (1, 37, 96, 32)])
def test_groupnorm_silu_matches_jax(shape, silu):
    B, N, C, G = shape
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((B, N, C)) * 3 + 1).astype(np.float32)
    s = (rng.standard_normal(C) * 0.5 + 1).astype(np.float32)
    b = (rng.standard_normal(C) * 0.1).astype(np.float32)
    gold = j_gn_ref.groupnorm_silu_ref(*map(jnp.asarray, (x, s, b)), groups=G, silu=silu)
    interp = j_gn_ops.groupnorm_silu(*map(jnp.asarray, (x, s, b)), groups=G, silu=silu,
                                     impl="interpret", block_n=32)
    for impl in ("kernel", "torch"):
        out = t_gn_ops.groupnorm_silu(*map(torch.from_numpy, (x, s, b)), groups=G,
                                      silu=silu, impl=impl)
        _close(out, gold, F32)
        _close(out, interp, F32)


def test_kernel_wrappers_on_cpu_count_no_launch():
    """A CPU tensor takes the plain version: no CUDA launch is counted."""
    before = dict(build.launches)
    x = torch.randn(1, 4, 4, 8)
    t_conv_ops.conv2d(x, torch.randn(3, 3, 8, 8), impl="kernel")
    t_gn_ops.groupnorm_silu(x, torch.ones(8), torch.zeros(8), groups=2, impl="kernel")
    q = torch.randn(1, 4, 2, 8)
    t_fa_ops.attention(q, q, q, impl="kernel")
    assert dict(build.launches) == before


def test_temporal_wrappers_on_cpu_count_no_launch():
    before = dict(build.launches)
    q = torch.randn(1, 4, 6, 2, 8)
    t_fa_ops.temporal_attention(q, q, q, impl="kernel")
    t_conv_kernel.temporal_conv1d(torch.randn(1, 4, 6, 8), torch.randn(3, 8, 8), torch.zeros(8))
    assert dict(build.launches) == before


def test_tier_names_map_like_the_reference():
    from repro_torch.kernels.tiers import resolve_model_impl

    assert {i: resolve_model_impl(i) for i in
            ("auto", "kernel", "pallas", "interpret", "torch", "blocked_jax", "xla",
             "naive")} == {"auto": "kernel", "kernel": "kernel", "pallas": "kernel",
                           "interpret": "kernel", "torch": "torch", "blocked_jax": "torch",
                           "xla": "torch", "naive": "torch"}
    with pytest.raises(ValueError):
        resolve_model_impl("emulate")
