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
    (1, 48, 48, 2, 2, 160, False, None),   # SD 16x16/8x8 and MAV head dim
    (1, 40, 40, 2, 1, 36, False, None),    # head dim no multiple of 8, GQA
    (1, 45, 45, 2, 2, 33, True, None),     # odd head dim (4-byte copies), causal
    (1, 130, 77, 2, 2, 64, False, None),   # Sq, Skv no multiple of the block
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
# (B, N, C, groups) of the GroupNorm card tests
GN_CARD_SHAPES = [
    (2, 100, 64, 8), (2, 4096, 320, 32), (2, 64, 1280, 32),
    # Make-A-Video's three calls: clusters of 8, 4 and 1 blocks
    (32, 1024, 640, 32), (32, 256, 1280, 32), (32, 64, 1280, 32),
    (3, 1001, 320, 32),    # C = 320 (40-byte groups) with a ragged N
    (2, 7, 96, 32),        # N < 8: a cluster of 7 one-row blocks; 3-channel groups
    (1, 65536, 320, 32),   # rows past the cluster's shared memory: the re-read plan
    (2, 50, 27, 9),        # no chunk of whole groups is 4 channels wide: scalar loads
]
# ((B, F, HW, H, D), frames_valid) of the temporal attention card tests
TATTN_CARD_CASES = [
    ((2, 4, 64, 4, 32), None), ((2, 8, 100, 4, 32), None), ((2, 16, 32, 4, 32), None),
    ((2, 16, 37, 3, 64), None),   # F=16, D=64 as at full width; ragged spatial tail
    ((1, 16, 50, 2, 64), 11),     # frames_valid < F
    ((1, 5, 13, 2, 6), 3),        # odd F and a head dim that is no multiple of 4
    ((1, 32, 9, 1, 64), None),    # the frame limit
    ((2, 16, 1024, 10, 64), None),  # Make-A-Video's largest call, full width
    ((2, 16, 64, 20, 64), None),    # and its smallest: 1280 items on 528 warps
    ((1, 16, 8, 2, 64), None),      # 8 work items, fewer than the card's SMs
    ((1, 32, 9, 1, 256), 30),       # the largest head dim: one warp a block
    ((2, 11, 256, 24, 64), None),   # Phenaki's call: F = 11 on 16 lanes, full width
]
# The pixel SR cascade's new shapes (Imagen's SR UNets, prod-image's heads).
# conv2d (B, H, W, C_in, C_out, K, stride): the SR conv_in of [z, up] (6
# channels) and conv_out to RGB (3 channels), at 256 px: 4-byte copies of A
# and B.
SR_CONV_SHAPES = [(2, 256, 256, 6, 128, 3, 1), (2, 256, 256, 128, 3, 3, 1)]
# flash attention (B, Sq, Skv, H, KVH, D, causal, window): prod-image's fixed
# 8 heads at its three widths, Imagen's cross-attention to 128 text tokens
SR_ATTN_CASES = [
    (2, 144, 144, 8, 8, 48, False, None), (2, 144, 144, 8, 8, 96, False, None),
    (2, 144, 144, 8, 8, 192, False, None), (2, 1024, 128, 16, 16, 64, False, None),
]
# The masked transformers' flash attention (B, Sq, Skv, H, KVH, D, causal,
# window), at full width: Muse's self- and cross-attention (16 heads of 128),
# Phenaki's spatial attention (frames folded into the batch) and its
# cross-attention from 2816 video tokens to the 77 text tokens
TRANSFORMER_ATTN_CASES = [
    (2, 256, 256, 16, 16, 128, False, None), (2, 256, 77, 16, 16, 128, False, None),
    (22, 256, 256, 24, 24, 64, False, None), (2, 2816, 77, 24, 24, 64, False, None),
]
# The LM slice's causal flash attention (B, Sq, Skv, H, KVH, D, kv_offset):
# LLaMA2-7B's prefill at full width, and a query block that starts past the
# first keys (a chunked prefill: rows at kv_offset.. see keys 0..row)
CAUSAL_ATTN_CASES = [(2, 2048, 2048, 32, 32, 128, 0), (1, 300, 364, 4, 4, 128, 64)]
# GroupNorm (B, N, C, groups): 2 and 4 channels a group over rows that
# overflow the cluster's shared memory (SR2's widths at 512 px)
GN_SR_SHAPES = [(2, 262144, 64, 32), (2, 262144, 128, 32)]
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
def test_attention_cuda_rows_with_no_key_in_the_window_give_zero(h100, dtype):
    """Every query position lies past the last key by more than the window:
    the kernel skips every key tile, and the rows give 0 (the plain version
    spreads their weight evenly over the masked keys instead)."""
    from repro_torch.kernels.flash_attention import flash_attention as kernel

    q, k, v = _on(h100, dtype, *_attn_inputs((1, 130, 77, 2, 2, 64), seed=13))
    n = build.launches["flash_attention"]
    out = kernel.flash_attention(q, k, v, scale=0.125, window=16, kv_offset=300)
    assert build.launches["flash_attention"] == n + 1
    assert out.shape == q.shape and torch.count_nonzero(out).item() == 0


@pytest.mark.gpu
def test_attention_cuda_reads_strided_views(h100):
    """q, k, v as column slices of one fused projection (no copy): 16-byte
    copies from rows 3 * H * D floats apart."""
    from repro_torch.kernels.flash_attention import flash_attention as kernel

    (qkv,) = _on(h100, torch.float32, *_attn_inputs((2, 100, 100, 4, 4, 120), seed=14)[:1])
    q, k, v = qkv[..., :40], qkv[..., 40:80], qkv[..., 80:]
    out = kernel.flash_attention(q, k, v, scale=40 ** -0.5)
    _close(out.cpu(), t_fa_ref.attention_ref(q, k, v, scale=40 ** -0.5).cpu(), F32)


@pytest.mark.gpu
def test_attention_cuda_main_path_shape(h100):
    """SD's level-0 self-attention, (2, 4096, 8, 40), once in fp32."""
    from repro_torch.kernels.flash_attention import flash_attention as kernel

    q, k, v = _on(h100, torch.float32, *_attn_inputs((2, 4096, 4096, 8, 8, 40), seed=15))
    out = kernel.flash_attention(q, k, v, scale=40 ** -0.5)
    gold = t_fa_ref.attention_ref(q, k, v, scale=40 ** -0.5)
    _close(out.cpu(), gold.cpu(), F32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape", GN_CARD_SHAPES, ids=lambda c: "x".join(map(str, c)))
def test_groupnorm_cuda_matches_plain(h100, shape, silu, dtype):
    from repro_torch.kernels.groupnorm_silu import groupnorm_silu as kernel

    B, N, C, G = shape
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((B, N, C)) * 3 + 1).astype(np.float32)
    (xt,) = _on(h100, dtype, x)
    s, b = _on(h100, torch.float32, (rng.standard_normal(C) * 0.5 + 1).astype(np.float32),
               (rng.standard_normal(C) * 0.1).astype(np.float32))
    n = build.launches["groupnorm_silu"]
    out = kernel.groupnorm_silu(xt, s, b, groups=G, silu=silu)
    assert build.launches["groupnorm_silu"] == n + 1
    gold = t_gn_ref.groupnorm_silu_ref(xt, s, b, groups=G, silu=silu)
    _close(out.cpu(), gold.cpu(), F32 if dtype == torch.float32 else BF16)


@pytest.mark.gpu
def test_groupnorm_cuda_plans_of_the_card_cases(h100):
    """The cases above reach the kernel's cached and re-read plans, both
    vector widths, and clusters of 8 and of fewer blocks."""
    from repro_torch.kernels.groupnorm_silu import groupnorm_silu as kernel

    plans = {s: kernel.plan(*s, 4) for s in
             [(1, 65536, 320, 32), (2, 50, 27, 9), (2, 7, 96, 32), (2, 4096, 320, 32)]}
    assert not plans[(1, 65536, 320, 32)].cached and plans[(2, 4096, 320, 32)].cached
    assert plans[(2, 50, 27, 9)].vec == 1 and plans[(2, 4096, 320, 32)].vec == 4
    assert plans[(2, 7, 96, 32)].cluster == 7 and plans[(2, 4096, 320, 32)].cluster == 8


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_groupnorm_cuda_two_launches_give_identical_bits(h100, dtype):
    """Every sum is taken in a fixed order: no atomics, no race."""
    from repro_torch.kernels.groupnorm_silu import groupnorm_silu as kernel

    rng = np.random.default_rng(17)
    (xt,) = _on(h100, dtype, (rng.standard_normal((32, 1024, 640)) * 3 + 1).astype(np.float32))
    s, b = _on(h100, torch.float32, rng.standard_normal(640).astype(np.float32),
               rng.standard_normal(640).astype(np.float32))
    first = kernel.groupnorm_silu(xt, s, b, groups=32, silu=False)
    assert torch.equal(first, kernel.groupnorm_silu(xt, s, b, groups=32, silu=False))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,frames_valid", TATTN_CARD_CASES,
                         ids=lambda c: "x".join(map(str, c)) if isinstance(c, tuple) else f"fv{c}")
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_temporal_attention_cuda_two_launches_give_identical_bits(h100, dtype):
    from repro_torch.kernels.flash_attention import flash_attention as kernel

    q, k, v = _on(h100, dtype, *_tattn_inputs((2, 16, 256, 20, 64), seed=18))
    first = kernel.temporal_flash_attention(q, k, v, scale=0.125)
    assert torch.equal(first, kernel.temporal_flash_attention(q, k, v, scale=0.125))


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
@pytest.mark.parametrize("case", TCONV_CASES + [
    (16, 5, 5, 40, 136, 3), (20, 3, 3, 17, 9, 5),
    (16, 5, 7, 40, 72, 1),      # K = 1, C_out != C, 560 rows: a ragged row tile
    (9, 6, 11, 64, 96, 5),      # K = 5, 16-byte copies, ragged rows
    (8, 4, 4, 128, 64, 3),      # a grid of 2 blocks: split-K with the bias epilogue
    (16, 32, 32, 64, 128, 3),   # 16 frames of 1024 positions, as at full width: unsplit
], ids=lambda c: "x".join(map(str, c)))
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


@pytest.mark.gpu
def test_temporal_conv1d_cuda_counts_only_its_own_launches(h100):
    """The temporal conv runs on conv2d's GEMM kernel, under its own count."""
    from repro_torch.kernels.conv2d import conv2d as kernel

    x, w, b = _tconv_inputs(16, 8, 8, 64, seed=16)
    xt, wt, bt = _on(h100, torch.float32, x, w, b)
    before = dict(build.launches)
    out = kernel.temporal_conv1d(xt.reshape(2, 16, 64, 64), wt, bt)
    assert build.launches["temporal_conv1d"] == before.get("temporal_conv1d", 0) + 1
    assert build.launches["conv2d"] == before.get("conv2d", 0)
    gold = t_conv_ref.temporal_conv1d_ref(xt, wt, bt)
    _close_scaled(out.reshape(gold.shape).cpu(), gold.cpu(), F32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("combo", [dict(bias=True), dict(gn=True, bias=True)],
                         ids=lambda c: "-".join(sorted(c)))
@pytest.mark.parametrize("shape", SR_CONV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv2d_cuda_sr_channel_counts_match_plain(h100, shape, combo, dtype):
    """C_in = 6 and C_out = 3 at 256 px, with and without the GroupNorm
    producer: the kernel's 4-byte copy paths at a grid of 1024 row tiles."""
    from repro_torch.kernels.conv2d import conv2d as kernel

    x, w, kw = _conv_case(shape, combo, seed=19)
    tkw = {k: torch.from_numpy(v).to(h100) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    xt, wt = _on(h100, dtype, x, w)
    n = build.launches["conv2d"]
    out = kernel.conv2d(xt, wt, **tkw)
    assert build.launches["conv2d"] == n + 1
    gold = t_conv_ref.conv2d_ref(xt, wt, **tkw)
    R = shape[5] ** 2 * shape[3]
    widen = max(1.0, (R / 64) ** 0.5)  # as in test_conv2d_tensor_core_paths_match_plain
    tol = ({k: v * widen for k, v in F32.items()} if dtype == torch.float32 else BF16)
    _close_scaled(out.cpu(), gold.cpu(), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", SR_ATTN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_attention_cuda_sr_head_widths_match_plain(h100, case, dtype):
    from repro_torch.kernels.flash_attention import flash_attention as kernel

    q, k, v = _on(h100, dtype, *_attn_inputs(case, seed=20))
    out = kernel.flash_attention(q, k, v, scale=case[5] ** -0.5)
    gold = t_fa_ref.attention_ref(q, k, v, scale=case[5] ** -0.5)
    _close(out.cpu(), gold.cpu(), F32 if dtype == torch.float32 else BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", TRANSFORMER_ATTN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_attention_cuda_transformer_shapes_match_plain(h100, case, dtype):
    from repro_torch.kernels.flash_attention import flash_attention as kernel

    q, k, v = _on(h100, dtype, *_attn_inputs(case, seed=23))
    out = kernel.flash_attention(q, k, v, scale=case[5] ** -0.5)
    gold = t_fa_ref.attention_ref(q, k, v, scale=case[5] ** -0.5)
    _close(out.cpu(), gold.cpu(), F32 if dtype == torch.float32 else BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CAUSAL_ATTN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_attention_cuda_causal_lm_shapes_match_plain(h100, case, dtype):
    from repro_torch.kernels.flash_attention import flash_attention as kernel

    q, k, v = _on(h100, dtype, *_attn_inputs(case, seed=29))
    kw = dict(scale=case[5] ** -0.5, causal=True, kv_offset=case[6])
    n = build.launches["flash_attention"]
    out = kernel.flash_attention(q, k, v, **kw)
    assert build.launches["flash_attention"] == n + 1
    gold = t_fa_ref.attention_ref(q, k, v, **kw)
    _close(out.cpu(), gold.cpu(), F32 if dtype == torch.float32 else BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decode_attention_on_the_card_matches_the_cpu(h100, dtype):
    """Decode attention (plain PyTorch on every tier) at Parti's width, one
    length for the batch and one a request: the card against the CPU."""
    from repro_torch.kernels.flash_attention import ops

    rng = np.random.default_rng(31)
    q = rng.standard_normal((2, 1, 32, 128), np.float32)
    kc, vc = rng.standard_normal((2, 2, 1024, 32, 128), np.float32)
    for kv_len in (1, 700, torch.tensor([1024, 513])):
        got = ops.decode_attention(*_on(h100, dtype, q, kc, vc), kv_len=kv_len if isinstance(
            kv_len, int) else kv_len.to(h100))
        gold = ops.decode_attention(*_on("cpu", dtype, q, kc, vc), kv_len=kv_len)
        _close(got.cpu(), gold, F32 if dtype == torch.float32 else BF16)


@pytest.mark.gpu
def test_attention_cuda_sr2_mid_block_length(h100):
    """16384 tokens, SR2's mid-block self-attention (one batch, 8 heads of
    64), once in fp32; the plain version computes its scores in chunks of
    query rows."""
    from repro_torch.kernels.flash_attention import flash_attention as kernel

    q, k, v = _on(h100, torch.float32, *_attn_inputs((1, 16384, 16384, 8, 8, 64), seed=21))
    out = kernel.flash_attention(q, k, v, scale=0.125)
    gold = t_fa_ref.attention_ref(q, k, v, scale=0.125)
    _close(out.cpu(), gold.cpu(), F32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", GN_SR_SHAPES, ids=lambda c: "x".join(map(str, c)))
def test_groupnorm_cuda_sr_widths_re_read_their_rows(h100, shape, dtype):
    from repro_torch.kernels.groupnorm_silu import groupnorm_silu as kernel

    B, N, C, G = shape
    assert not kernel.plan(B, N, C, G, 2 if dtype == torch.bfloat16 else 4).cached
    rng = np.random.default_rng(22)
    (xt,) = _on(h100, dtype, (rng.standard_normal((B, N, C)) * 3 + 1).astype(np.float32))
    s, b = _on(h100, torch.float32, (rng.standard_normal(C) * 0.5 + 1).astype(np.float32),
               (rng.standard_normal(C) * 0.1).astype(np.float32))
    out = kernel.groupnorm_silu(xt, s, b, groups=G, silu=True)
    gold = t_gn_ref.groupnorm_silu_ref(xt, s, b, groups=G, silu=True)
    _close(out.cpu(), gold.cpu(), F32 if dtype == torch.float32 else BF16)


# ---------------------------------------------------------------------------
# Serving: the engine's routes on the card against the CPU
# ---------------------------------------------------------------------------

SMALL = dict(rtol=1e-4, atol=1e-4)  # chip_smoke.py phase 7: reduced generate, card vs CPU


def _served(wl, state, dev, route, prompts, **kw):
    from repro_torch.serving import ServeConfig, ServeEngine

    eng = ServeEngine(wl, wl.load(state, dev), ServeConfig(max_batch=2, buckets=(8,),
                                                           route=route, **kw))
    for rid, p in enumerate(prompts):
        eng.submit(rid, p, max_new_tokens=6)
    return eng.run()


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["auto", "cascade"])
@pytest.mark.parametrize("name", ["tti", "ttv"])
def test_tiny_cascade_served_on_the_card_matches_the_cpu(h100, name, route):
    """The tiny SR and TTV cascades on the pod and cascade routes: the card's
    kernels against the CPU's plain versions, within phase 7's tolerance
    relative to the output's scale."""
    from repro_torch.configs.tiny import TINY_TTI_CASCADE, TINY_TTV_CASCADE
    from repro_torch.nn import init_params
    from repro_torch.workload import workload_for

    wl = workload_for({"tti": TINY_TTI_CASCADE, "ttv": TINY_TTV_CASCADE}[name])
    state = init_params(wl.model, 0)
    rng = np.random.default_rng(40)
    prompts = [rng.integers(0, wl.prompt_vocab, 8) for _ in range(4)]
    card, cpu = (_served(wl, state, dev, route, prompts) for dev in ("cuda", "cpu"))
    assert sorted(card) == sorted(cpu) == [0, 1, 2, 3]
    for rid in range(4):
        gold = cpu[rid].float()
        scale = max(1.0, gold.abs().max().item())
        np.testing.assert_allclose(card[rid].float().numpy(), gold.numpy(), rtol=SMALL["rtol"],
                                   atol=SMALL["atol"] * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
@pytest.mark.parametrize("route", ["auto", "cascade"])
def test_reduced_llama_served_on_the_card_gives_the_cpu_tokens(h100, route, temperature):
    from repro_torch.configs import get_config
    from repro_torch.nn import init_params
    from repro_torch.workload import reduced_workload

    wl = reduced_workload(get_config("llama2-7b"))
    state = init_params(wl.model, 0)
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, wl.prompt_vocab, n) for n in (5, 8, 3, 7)]
    card, cpu = (_served(wl, state, dev, route, prompts, temperature=temperature)
                 for dev in ("cuda", "cpu"))
    assert {r: list(map(int, v)) for r, v in card.items()} == {
        r: list(map(int, v)) for r, v in cpu.items()}
