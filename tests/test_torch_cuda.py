"""The port's CUDA kernels on the card, each against its plain version.

These tests carry the ``gpu`` marker: they build the kernels from
``src/repro_torch/kernels/csrc`` and need an sm_90 (Hopper) card, and skip
with a reason elsewhere.  The file imports no JAX, so it also runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX.)  The case generators
here are shared with ``tests/test_torch_kernels.py``, which holds the same
plain versions against the JAX package on the CPU.  Tolerances are the
repo's own (``tests/test_kernels.py``): 2e-5 in fp32, 2e-4 for emitted
stats, 2e-2 in bf16; 3e-5 for temporal attention (its sweep's own,
``tests/test_kernels.py``).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.conv2d import ref as t_conv_ref
from repro_torch.kernels.flash_attention import ref as t_fa_ref
from repro_torch.kernels.groupnorm_silu import ref as t_gn_ref

F32 = dict(rtol=2e-5, atol=2e-5)
TEMPORAL_F32 = dict(rtol=3e-5, atol=3e-5)
STATS = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32))


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


# ---------------------------------------------------------------------------
# conv2d
# ---------------------------------------------------------------------------

CONV_SHAPES = [
    # B, H, W, Cin, Cout, K, stride
    (1, 16, 16, 8, 8, 3, 1),     # aligned, square
    (2, 9, 13, 6, 10, 3, 1),     # odd H/W
    (1, 17, 11, 4, 4, 3, 2),     # stride-2 downsample, C_in=4, odd H/W
    (2, 12, 12, 8, 16, 1, 1),    # 1x1 skip conv
    (2, 8, 8, 4, 6, 3, 1),       # C_in=4 (conv_in)
]
# Shapes that take the tensor-core conv kernel's other paths (``conv2d.plan``):
# split-K slices, each block tile of ``conv2d.TILES`` unsplit, 16-byte copies
# on 32-aligned C_in, the narrow tile with 4-byte copies of a C_out = 3 weight.
TC_CONV_SHAPES = [
    # B, H, W, Cin, Cout, K, stride
    (2, 16, 16, 64, 96, 3, 1),      # 32-aligned C_in; split-K (R = 576, 4 slices)
    (2, 8, 8, 64, 320, 3, 1),       # C_out = 320 at a small image: 64-wide tiles, split
    (1, 16, 16, 128, 3, 3, 1),      # C_out = 3 after C_in = 128: the 128 x 16 tile
    (2, 8, 8, 1280, 1280, 3, 1),    # SD 8x8 3x3: split-K
    (2, 8, 8, 2560, 1280, 1, 1),    # SD 8x8 1x1 skip conv: split-K
    (2, 16, 16, 64, 64, 3, 2),      # stride 2 on an aligned C_in
    (5, 64, 64, 32, 128, 3, 1),     # unsplit 128 x 128
    (2, 64, 64, 32, 320, 3, 1),     # unsplit 128 x 64
    (32, 8, 8, 32, 640, 3, 1),      # unsplit 64 x 128
    (2, 16, 16, 64, 1280, 3, 1),    # SD 16x16 widths: 128 x 128, split
]
EPILOGUES = [
    dict(bias=True),
    dict(bias=True, temb=True),
    dict(bias=True, silu=True),
    dict(bias=True, residual=True),
    dict(gn=True),
    dict(gn=True, gn_silu=False),
    dict(gn=True, bias=True, temb=True, emit_stats=True),
    dict(gn=True, bias=True, silu=True, residual=True, emit_stats=True),
]


def _conv_case(shape, combo, seed=0):
    B, H, W, Cin, Cout, K, s = shape
    rng = np.random.default_rng(seed)
    pad = K // 2
    OH, OW = (H + 2 * pad - K) // s + 1, (W + 2 * pad - K) // s + 1
    x = rng.standard_normal((B, H, W, Cin), np.float32)
    kw = dict(stride=s)
    if combo.get("bias"):
        kw["bias"] = 0.1 * rng.standard_normal(Cout, np.float32)
    if combo.get("temb"):
        kw["temb"] = rng.standard_normal((B, Cout), np.float32)
    if combo.get("silu"):
        kw["silu"] = True
    if combo.get("residual"):
        kw["residual"] = rng.standard_normal((B, OH, OW, Cout), np.float32)
    if combo.get("gn"):
        kw["gn_a"] = (1 + 0.1 * rng.standard_normal((B, Cin))).astype(np.float32)
        kw["gn_b"] = (0.1 * rng.standard_normal((B, Cin))).astype(np.float32)
        kw["gn_silu"] = combo.get("gn_silu", True)
    kw["emit_stats"] = combo.get("emit_stats", False)
    w = (0.2 * rng.standard_normal((K, K, Cin, Cout))).astype(np.float32)
    return x, w, kw


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # B, Sq, Skv, H, KVH, D, causal, window
    (2, 40, 40, 2, 2, 40, False, None),    # SD level-0 head dim
    (1, 33, 77, 2, 2, 64, False, None),    # cross-attention to 77 text tokens
    (1, 50, 50, 2, 2, 80, False, None),    # SD level-1 head dim
    (1, 70, 70, 4, 2, 64, True, None),     # causal + GQA
    (1, 70, 70, 2, 2, 32, True, 16),       # causal local window
]


def _attn_inputs(case, seed=0):
    B, Sq, Skv, H, KVH, D = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D), np.float32),
            rng.standard_normal((B, Skv, KVH, D), np.float32),
            rng.standard_normal((B, Skv, KVH, D), np.float32))


# ---------------------------------------------------------------------------
# temporal attention and temporal conv (the Make-A-Video slice)
# ---------------------------------------------------------------------------

# (F, HW) of the reference's sweep (tests/test_kernels.py), q (2, F, HW, 4, 32)
TATTN_CASES = [(4, 64), (8, 100), (16, 32)]
# (F, H, W, C) of the reference's sweep; w (3, C, C)
TCONV_CASES = [(4, 8, 8, 8), (5, 7, 9, 6), (16, 4, 4, 12)]


def _tattn_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, np.float32) for _ in range(3))


def _tconv_inputs(F, H, W, C, C_out=None, K=3, seed=0):
    rng = np.random.default_rng(seed)
    C_out = C if C_out is None else C_out
    return (rng.standard_normal((2, F, H, W, C), np.float32),
            (0.2 * rng.standard_normal((K, C, C_out))).astype(np.float32),
            (0.1 * rng.standard_normal(C_out)).astype(np.float32))


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version (skips elsewhere)
# ---------------------------------------------------------------------------


@pytest.fixture
def h100():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: pytest -m gpu)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the CUDA kernels are built for sm_90a (Hopper)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, dtype, *arrays):
    return [None if a is None else torch.from_numpy(a).to(dev, dtype) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("combo", EPILOGUES, ids=lambda c: "-".join(sorted(c)))
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv2d_cuda_matches_plain(h100, shape, combo, dtype):
    from repro_torch.kernels.conv2d import conv2d as kernel

    x, w, kw = _conv_case(shape, combo, seed=6)
    tkw = {k: torch.from_numpy(v).to(h100) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    if "residual" in tkw:
        tkw["residual"] = tkw["residual"].to(dtype)
    xt, wt = _on(h100, dtype, x, w)
    n = build.launches["conv2d"]
    out = kernel.conv2d(xt, wt, **tkw)
    assert build.launches["conv2d"] == n + 1
    gold = t_conv_ref.conv2d_ref(xt, wt, **tkw)
    tol = F32 if dtype == torch.float32 else BF16
    if kw["emit_stats"]:
        _close(out[0].cpu(), gold[0].cpu(), tol)
        _close(out[1].cpu(), gold[1].cpu(), STATS)
    else:
        _close(out.cpu(), gold.cpu(), tol)


def _close_scaled(a, b, tol):
    """``chip_smoke.py``'s criterion: |a - b| <= atol * max(1, max|b|) + rtol * |b|
    (summation-order error follows the magnitude of the summed terms)."""
    a, b = _np(a), _np(b)
    scale = max(1.0, float(np.abs(b).max()))
    bad = np.abs(a - b) > tol["atol"] * scale + tol["rtol"] * np.abs(b)
    assert not bad.any(), (f"{int(bad.sum())} of {b.size} off by more than {tol}; "
                           f"max abs err {np.abs(a - b).max():.3e}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("combo", EPILOGUES[-2:], ids=lambda c: "-".join(sorted(c)))
@pytest.mark.parametrize("shape", TC_CONV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv2d_tensor_core_paths_match_plain(h100, shape, combo, dtype):
    from repro_torch.kernels.conv2d import conv2d as kernel

    x, w, kw = _conv_case(shape, combo, seed=12)
    tkw = {k: torch.from_numpy(v).to(h100) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw["residual"] = tkw["residual"].to(dtype) if "residual" in tkw else None
    xt, wt = _on(h100, dtype, x, w)
    n = build.launches["conv2d"]
    out, stats = kernel.conv2d(xt, wt, **tkw)
    assert build.launches["conv2d"] == n + 1  # one count per call, however many kernels ran
    gold, gold_stats = t_conv_ref.conv2d_ref(xt, wt, **tkw)
    # fp32: the repo's 2e-5 holds for reductions up to R = 72; summation-order
    # error grows as sqrt(R), so it is widened by sqrt(R / 64) as chip_smoke.py does
    R = shape[5] ** 2 * shape[3]
    widen = max(1.0, (R / 64) ** 0.5)
    tol = ({k: v * widen for k, v in F32.items()} if dtype == torch.float32 else BF16)
    _close_scaled(out.cpu(), gold.cpu(), tol)
    _close_scaled(stats.cpu(), gold_stats.cpu(), STATS)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ATTN_CASES + [(2, 300, 300, 8, 8, 160, False, None),
                                               (1, 64, 64, 2, 2, 256, False, None)],
                         ids=lambda c: "x".join(map(str, c)))
def test_attention_cuda_matches_plain(h100, case, dtype):
    from repro_torch.kernels.flash_attention import flash_attention as kernel

    q, k, v = _on(h100, dtype, *_attn_inputs(case, seed=7))
    kw = dict(causal=case[6], window=case[7], scale=case[5] ** -0.5)
    out = kernel.flash_attention(q, k, v, **kw)
    gold = t_fa_ref.attention_ref(q, k, v, **kw)
    _close(out.cpu(), gold.cpu(), F32 if dtype == torch.float32 else BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape", [(2, 100, 64, 8), (2, 4096, 320, 32), (2, 64, 1280, 32)])
def test_groupnorm_cuda_matches_plain(h100, shape, silu, dtype):
    from repro_torch.kernels.groupnorm_silu import groupnorm_silu as kernel

    B, N, C, G = shape
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((B, N, C)) * 3 + 1).astype(np.float32)
    (xt,) = _on(h100, dtype, x)
    s, b = _on(h100, torch.float32, (rng.standard_normal(C) * 0.5 + 1).astype(np.float32),
               (rng.standard_normal(C) * 0.1).astype(np.float32))
    out = kernel.groupnorm_silu(xt, s, b, groups=G, silu=silu)
    gold = t_gn_ref.groupnorm_silu_ref(xt, s, b, groups=G, silu=silu)
    _close(out.cpu(), gold.cpu(), F32 if dtype == torch.float32 else BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,frames_valid", [
    ((2, 4, 64, 4, 32), None), ((2, 8, 100, 4, 32), None), ((2, 16, 32, 4, 32), None),
    ((2, 16, 37, 3, 64), None),   # F=16, D=64 as at full width; ragged spatial tail
    ((1, 16, 50, 2, 64), 11),     # frames_valid < F
    ((1, 5, 13, 2, 6), 3),        # odd F and a head dim that is no multiple of 4
    ((1, 32, 9, 1, 64), None),    # the frame limit
], ids=lambda c: "x".join(map(str, c)) if isinstance(c, tuple) else f"fv{c}")
def test_temporal_attention_cuda_matches_plain(h100, shape, frames_valid, dtype):
    from repro_torch.kernels.flash_attention import flash_attention as kernel

    q, k, v = _on(h100, dtype, *_tattn_inputs(shape, seed=9))
    kw = dict(scale=shape[-1] ** -0.5, frames_valid=frames_valid)
    n = build.launches["temporal_flash_attention"]
    out = kernel.temporal_flash_attention(q, k, v, **kw)
    assert build.launches["temporal_flash_attention"] == n + 1
    gold = t_fa_ref.temporal_attention_ref(q, k, v, **kw)
    _close(out.cpu(), gold.cpu(), TEMPORAL_F32 if dtype == torch.float32 else BF16)


@pytest.mark.gpu
def test_temporal_attention_cuda_reads_strided_views(h100):
    """q, k, v as column slices of one fused projection (no copy)."""
    from repro_torch.kernels.flash_attention import flash_attention as kernel

    (qkv,) = _on(h100, torch.float32, *_tattn_inputs((2, 8, 30, 4, 96), seed=10)[:1])
    q, k, v = qkv[..., :32], qkv[..., 32:64], qkv[..., 64:]
    out = kernel.temporal_flash_attention(q, k, v, scale=0.2)
    _close(out.cpu(), t_fa_ref.temporal_attention_ref(q, k, v, scale=0.2).cpu(), TEMPORAL_F32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", TCONV_CASES + [(16, 5, 5, 40, 136, 3), (20, 3, 3, 17, 9, 5)],
                         ids=lambda c: "x".join(map(str, c)))
def test_temporal_conv1d_cuda_matches_plain(h100, case, dtype):
    from repro_torch.kernels.conv2d import conv2d as kernel

    F, H, W, C = case[:4]
    x, w, b = _tconv_inputs(*case, seed=11)
    xt, wt = _on(h100, dtype, x, w)
    (bt,) = _on(h100, torch.float32, b)
    n = build.launches["temporal_conv1d"]
    out = kernel.temporal_conv1d(xt.reshape(2, F, H * W, C), wt, bt)
    assert build.launches["temporal_conv1d"] == n + 1
    gold = t_conv_ref.temporal_conv1d_ref(xt, wt, bt)
    _close(out.reshape(gold.shape).cpu(), gold.cpu(), F32 if dtype == torch.float32 else BF16)
