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
``tests/test_kernels.py``).  The last tests run the mesh's coverage of
``tests/test_torch_mesh.py`` on a CPU gloo world under this host's torch
(``tests/torch_mesh_ranks.py``).
"""

import os

import numpy as np
import pytest
import torch
import torch_mesh_ranks

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
# The dense assigned LMs' causal prefills at full width (B, Sq, Skv, H,
# KVH, D, kv_offset): olmo-1b (16 heads of 128), stablelm-3b (32 heads of 80,
# 20 of them rotary), glm4-9b (GQA 32:2, a group of 16), and qwen2-72b's GQA
# 64:8 at a shorter prompt (its path waits for several cards)
DENSE_LM_ATTN_CASES = [(2, 2048, 2048, 16, 16, 128, 0), (2, 2048, 2048, 32, 32, 80, 0),
                       (2, 2048, 2048, 32, 2, 128, 0), (1, 512, 512, 64, 8, 128, 0)]
# The MoE LMs' causal prefills at full width (B, Sq, Skv, H, KVH, D,
# kv_offset): qwen3-moe-30b-a3b's GQA 32:4 (a group of 8) after qk-norm;
# deepseek-moe-16b's MHA 16 x 128 is olmo-1b's shape above
MOE_LM_ATTN_CASES = [(2, 2048, 2048, 32, 4, 128, 0)]
# recurrentgemma-9b's local-attention prefill at full width (B, Sq, Skv, H,
# KVH, D, window): MQA 16:1 at D = 256, causal, a window of 2048 over the
# 3072-token prompt of its chip run (the last 1024 rows lose their early
# keys, and whole key tiles are skipped)
LOCAL_LM_ATTN_CASES = [(2, 3072, 3072, 16, 1, 256, 2048)]
# The enc-dec and VLM calls at full width (B, Sq, Skv, H, KVH, D, causal):
# whisper-base's encoder over 1500 frames (non-causal), its decoder's causal
# self-attention over 187 tokens and its cross-attention from them to the
# 1500 frames (no tile filled exactly, rows and keys masked at both tails);
# qwen2-vl-2b's causal GQA 12:2, a group of 6
ENCDEC_VLM_ATTN_CASES = [(2, 1500, 1500, 8, 8, 64, False), (2, 187, 187, 8, 8, 64, True),
                         (2, 187, 1500, 8, 8, 64, False), (2, 2048, 2048, 12, 2, 128, True)]
# One MoE layer at full width (d, E, f, k, n_shared, d_ff_shared) over 256
# tokens at capacity 1.25: deepseek-moe-16b's and qwen3-moe-30b-a3b's
MOE_CARD_WIDTHS = {"deepseek-moe-16b": (2048, 64, 1408, 6, 2, 2816),
                   "qwen3-moe-30b-a3b": (2048, 128, 768, 8, 0, 0)}
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
@pytest.mark.parametrize("case", DENSE_LM_ATTN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_attention_cuda_dense_lm_prefills_match_plain(h100, case, dtype):
    """Causal GQA with a group of 16 (glm4-9b) and 8 (qwen2-72b), and causal
    D = 80 (stablelm-3b): the kernel against its plain version."""
    from repro_torch.kernels.flash_attention import flash_attention as kernel

    q, k, v = _on(h100, dtype, *_attn_inputs(case, seed=37))
    kw = dict(scale=case[5] ** -0.5, causal=True, kv_offset=case[6])
    n = build.launches["flash_attention"]
    out = kernel.flash_attention(q, k, v, **kw)
    assert build.launches["flash_attention"] == n + 1
    gold = t_fa_ref.attention_ref(q, k, v, **kw)
    _close(out.cpu(), gold.cpu(), F32 if dtype == torch.float32 else BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", MOE_LM_ATTN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_attention_cuda_moe_lm_prefills_match_plain(h100, case, dtype):
    """Causal GQA with a group of 8 (qwen3-moe-30b-a3b's prefill): the kernel
    against its plain version."""
    from repro_torch.kernels.flash_attention import flash_attention as kernel

    q, k, v = _on(h100, dtype, *_attn_inputs(case, seed=43))
    kw = dict(scale=case[5] ** -0.5, causal=True, kv_offset=case[6])
    n = build.launches["flash_attention"]
    out = kernel.flash_attention(q, k, v, **kw)
    assert build.launches["flash_attention"] == n + 1
    gold = t_fa_ref.attention_ref(q, k, v, **kw)
    _close(out.cpu(), gold.cpu(), F32 if dtype == torch.float32 else BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", LOCAL_LM_ATTN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_attention_cuda_local_window_prefill_matches_plain(h100, case, dtype):
    """The D = 256 instance with a window that masks (recurrentgemma-9b's
    prefill): the kernel against its plain version, one launch."""
    from repro_torch.kernels.flash_attention import flash_attention as kernel

    q, k, v = _on(h100, dtype, *_attn_inputs(case, seed=53))
    kw = dict(scale=case[5] ** -0.5, causal=True, window=case[6])
    n = build.launches["flash_attention"]
    out = kernel.flash_attention(q, k, v, **kw)
    assert build.launches["flash_attention"] == n + 1
    gold = t_fa_ref.attention_ref(q, k, v, **kw)
    _close(out.cpu(), gold.cpu(), F32 if dtype == torch.float32 else BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ENCDEC_VLM_ATTN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_attention_cuda_encdec_and_vlm_shapes_match_plain(h100, case, dtype):
    """whisper-base's encoder, decoder and cross calls, and qwen2-vl-2b's
    GQA prefill: the kernel against its plain version, one launch each."""
    from repro_torch.kernels.flash_attention import flash_attention as kernel

    q, k, v = _on(h100, dtype, *_attn_inputs(case, seed=67))
    kw = dict(scale=case[5] ** -0.5, causal=case[6])
    n = build.launches["flash_attention"]
    out = kernel.flash_attention(q, k, v, **kw)
    assert build.launches["flash_attention"] == n + 1
    gold = t_fa_ref.attention_ref(q, k, v, **kw)
    _close(out.cpu(), gold.cpu(), F32 if dtype == torch.float32 else BF16)


def _seeded(layer, seed):
    from repro_torch.nn import init_params, materialize

    return materialize(layer, init_params(layer, seed), "cpu")


def _close_scaled_f32(a, b, tol=F32):
    """Within ``tol`` of ``b``'s scale: a chain of fp32 products and sums."""
    b = b.float()
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol["rtol"],
                               atol=tol["atol"] * max(1.0, b.abs().max().item()))


# The Mamba-2 mixer's output through its gated RMSNorm: its own fp32
# rounding, the CPU's fp32 against fp64 (seed 59 below), reaches 9.8e-5 at
# max |out| 5.0 (relative L2 4.2e-6), about the kernel tolerance at that
# scale, so the card and the CPU, each that far from exact, are held to
# 5x it; the states stay at the kernel tolerance
MIXER_OUT = dict(rtol=F32["rtol"], atol=5 * F32["atol"])


@pytest.mark.gpu
def test_mamba2_mixer_at_full_width_on_the_card_matches_the_cpu(h100):
    """One mamba2-780m mixer (d 1536, 48 heads of 64, state 128, chunk 256)
    over 300 tokens (a whole chunk and a padded one) from a nonzero state,
    then one decode step: the card against the CPU (``MIXER_OUT`` for the
    outputs, relative L2 within 2e-5)."""
    from repro_torch.models.layers.ssm import Mamba2Mixer, Mamba2State

    layer = _seeded(Mamba2Mixer(1536), 59)
    g = torch.Generator().manual_seed(60)
    x = torch.randn((2, 300, 1536), generator=g)
    st0 = Mamba2State(0.1 * torch.randn((2, 48, 64, 128), generator=g),
                      torch.zeros((2, 3, layer.conv_dim)))
    x1 = torch.randn((2, 1, 1536), generator=g)
    with torch.inference_mode():
        gold, gst = layer(x, initial_state=st0)
        gstep, gst1 = layer.step(x1, gst)
        card = layer.to(h100)
        out, st = card(x.to(h100), initial_state=Mamba2State(*(a.to(h100) for a in st0)))
        step, st1 = card.step(x1.to(h100), st)
    for a, b in ((out, gold), (step, gstep)):
        _close_scaled_f32(a.cpu(), b, MIXER_OUT)
        assert ((a.cpu() - b).norm() / b.norm()).item() < 2e-5
    for a, b in ((st.ssm, gst.ssm), (st.conv, gst.conv), (st1.ssm, gst1.ssm)):
        _close_scaled_f32(a.cpu(), b)


@pytest.mark.gpu
def test_rglru_block_at_full_width_on_the_card_matches_the_cpu(h100):
    """One recurrentgemma-9b RG-LRU block (d 4096) over 200 tokens from a
    nonzero ``h0`` (8 doubling steps), then one decode step: the card
    against the CPU."""
    from repro_torch.models.layers.rglru import RGLRUBlock, RGLRUState

    layer = _seeded(RGLRUBlock(4096, 4096), 61)
    g = torch.Generator().manual_seed(62)
    x = torch.randn((2, 200, 4096), generator=g)
    st0 = RGLRUState(torch.randn((2, 4096), generator=g), torch.zeros((2, 3, 4096)))
    x1 = torch.randn((2, 1, 4096), generator=g)
    with torch.inference_mode():
        gold, gst = layer(x, initial_state=st0)
        gstep, gst1 = layer.step(x1, gst)
        card = layer.to(h100)
        out, st = card(x.to(h100), initial_state=RGLRUState(*(a.to(h100) for a in st0)))
        step, st1 = card.step(x1.to(h100), st)
    for a, b in ((out, gold), (st.hidden, gst.hidden), (st.conv, gst.conv), (step, gstep),
                 (st1.hidden, gst1.hidden)):
        _close_scaled_f32(a.cpu(), b)


@pytest.mark.gpu
def test_mrope_on_the_card_matches_the_cpu(h100):
    """qwen2-vl-2b's M-RoPE at full width (2 x 2048 tokens, 12 heads of 128,
    sections (16, 24, 24), base 1e6) at an image prompt's three distinct
    streams: the card against the CPU."""
    from repro_torch.models.layers import rope

    g = torch.Generator().manual_seed(71)
    x = torch.randn((2, 2048, 12, 128), generator=g)
    cell = torch.arange(1024)
    tail = torch.arange(1008) + 48
    pos = torch.stack([torch.cat([torch.arange(16), torch.full_like(cell, 16), tail]),
                       torch.cat([torch.arange(16), 16 + cell // 32, tail]),
                       torch.cat([torch.arange(16), 16 + cell % 32, tail])])
    pos = pos[:, None].expand(3, 2, 2048).to(torch.int32)
    gold = rope.apply_mrope(x, pos, (16, 24, 24), base=1e6)
    out = rope.apply_mrope(x.to(h100), pos.to(h100), (16, 24, 24), base=1e6)
    _close_scaled_f32(out.cpu(), gold)


@pytest.mark.gpu
def test_whisper_decoder_block_at_full_width_on_the_card_matches_the_cpu(h100):
    """One whisper-base decoder block (d 512, 8 heads of 64, LayerNorm,
    QKV bias, tanh-GELU MLP of 2048, cross-attention) over 187 tokens against
    a context of 1500 frames, on the kernel tier, then one decode step with
    the cross K/V projected from the context: the card against the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers.attention import AttentionCache
    from repro_torch.models.transformer import Block

    cfg = get_config("whisper-base")
    block = _seeded(Block(cfg, "dense", causal=True, with_cross=True), 73)
    g = torch.Generator().manual_seed(74)
    with torch.no_grad():  # biases and scales away from their init: none is trivial
        for name, p in block.named_parameters():
            if name.endswith(("bias", "scale")):
                p.copy_(0.1 * torch.randn(p.shape, generator=g) + name.endswith("scale"))
    x = torch.randn((2, 187, 512), generator=g)
    ctx = torch.randn((2, 1500, 512), generator=g)
    x1 = torch.randn((2, 1, 512), generator=g)
    with torch.inference_mode():
        gold, gkv = block(x, context=ctx, impl="kernel", return_state=True)
        cache = AttentionCache(*(torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 1))
                                 for a in gkv["attn"]))
        gstep, _ = block.decode(x1, {"attn": cache}, 187,
                                cross_cache=block.cross_attn.project_kv(ctx))
        card = block.to(h100)
        out, kv = card(x.to(h100), context=ctx.to(h100), impl="kernel", return_state=True)
        ccache = AttentionCache(*(torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 1))
                                  for a in kv["attn"]))
        step, _ = card.decode(x1.to(h100), {"attn": ccache}, 187,
                              cross_cache=card.cross_attn.project_kv(ctx.to(h100)))
    for a, b in ((out, gold), (kv["attn"].k, gkv["attn"].k), (step, gstep)):
        _close_scaled_f32(a.cpu(), b)


def _moe_layer(arch, seed=47):
    """One MoE layer at ``arch``'s full width, seeded CPU weights."""
    from repro_torch.models.layers.moe import MoE
    from repro_torch.nn import init_params, materialize

    d, E, f, k, n_shared, d_ff_shared = MOE_CARD_WIDTHS[arch]
    layer = MoE(d, f, E, k, n_shared=n_shared, d_ff_shared=d_ff_shared)
    return materialize(layer, init_params(layer, seed), "cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(MOE_CARD_WIDTHS))
def test_moe_layer_on_the_card_routes_and_drops_as_the_cpu(h100, arch):
    """256 tokens through one full-width MoE layer at capacity 1.25, on the
    card against the CPU: the same top-k experts, so the same drops (some
    expert is over capacity), and the output within 2e-5 of its scale."""
    layer = _moe_layer(arch)
    x = torch.randn((2, 128, layer.d_model), generator=torch.Generator().manual_seed(48))
    with torch.inference_mode():
        gold, gold_aux = layer(x)
        _, _, top_i = layer.route(x.reshape(-1, layer.d_model))
        card = layer.to(h100)
        out, aux = card(x.to(h100))
        _, _, top_i_card = card.route(x.to(h100).reshape(-1, layer.d_model))
    assert torch.equal(top_i_card.cpu(), top_i)
    load = torch.bincount(top_i.reshape(-1), minlength=layer.n_experts)
    assert int(load.max()) > layer.capacity(256), (load.max(), layer.capacity(256))
    scale = max(1.0, gold.abs().max().item())
    np.testing.assert_allclose(out.cpu().numpy(), gold.numpy(), rtol=F32["rtol"],
                               atol=F32["atol"] * scale)
    np.testing.assert_allclose(aux.item(), gold_aux.item(), rtol=F32["rtol"])


@pytest.mark.gpu
def test_moe_all_tied_router_takes_the_lower_experts_on_the_card(h100):
    """A zero router ties every probability: on the card as on the CPU the
    top k are experts 0..k-1 in order (``jax.lax.top_k``), so expert 0
    takes the first ``capacity`` tokens and drops the rest."""
    layer = _moe_layer("qwen3-moe-30b-a3b")
    layer.router.data.zero_()
    x = torch.randn((1, 64, layer.d_model), generator=torch.Generator().manual_seed(49))
    with torch.inference_mode():
        gold, _ = layer(x)
        card = layer.to(h100)
        _, top_p, top_i = card.route(x.to(h100).reshape(-1, layer.d_model))
        out, _ = card(x.to(h100))
    assert torch.equal(top_i.cpu(), torch.arange(layer.top_k).expand(64, -1))
    torch.testing.assert_close(top_p.cpu(), torch.full((64, layer.top_k), 1 / layer.top_k))
    scale = max(1.0, gold.abs().max().item())
    np.testing.assert_allclose(out.cpu().numpy(), gold.numpy(), rtol=F32["rtol"],
                               atol=F32["atol"] * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_len", [1, 1500, "per-request"])
def test_decode_attention_gqa_group_16_matches_a_materialized_softmax(h100, kv_len):
    """glm4-9b's decode step: 32 query heads on 2 kv heads of 128 against a
    cache of 2064 rows, held to the softmax written out in float64."""
    from repro_torch.kernels.flash_attention import ops

    rng = np.random.default_rng(41)
    q = rng.standard_normal((2, 1, 32, 128), np.float32)
    kc, vc = rng.standard_normal((2, 2, 2064, 2, 128), np.float32)
    lens = np.array([2064, 1031]) if kv_len == "per-request" else np.array([kv_len] * 2)
    arg = torch.tensor(lens, device=h100) if kv_len == "per-request" else kv_len
    got = ops.decode_attention(*_on(h100, torch.float32, q, kc, vc), kv_len=arg).cpu()
    k64 = np.repeat(kc.astype(np.float64), 16, axis=2)  # kv head h // 16 for query head h
    v64 = np.repeat(vc.astype(np.float64), 16, axis=2)
    s = np.einsum("bhd,bshd->bhs", q[:, 0].astype(np.float64), k64) / np.sqrt(128.0)
    s = np.where(np.arange(2064)[None, None] < lens[:, None, None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    gold = np.einsum("bhs,bshd->bhd", p, v64)[:, None]
    _close(got, torch.from_numpy(gold.astype(np.float32)), F32)


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


@pytest.mark.gpu
def test_profiler_analysis_attributes_the_hand_kernels(h100):
    """A real conv2d and flash-attention launch under ``torch.profiler``,
    inside a tracer scope: ``core.profiler_analysis`` puts their device time
    under ``conv`` and ``attention`` and under the scope, and counts them."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import profiler_analysis as pa
    from repro_torch.core import tracer
    from repro_torch.kernels.conv2d import conv2d as conv_k
    from repro_torch.kernels.flash_attention import flash_attention as fa_k

    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((2, 32, 32, 64), generator=g, device="cuda")
    w = torch.randn((3, 3, 64, 64), generator=g, device="cuda")
    q = torch.randn((2, 256, 8, 64), generator=g, device="cuda")
    conv_k.conv2d(x, w)
    fa_k.flash_attention(q, q, q, scale=0.125)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with tracer.scope("stage"):
            conv_k.conv2d(x, w)
            fa_k.flash_attention(q, q, q, scale=0.125)
        torch.cuda.synchronize()
    hist = pa.op_histogram(prof)
    names = {pa.kernel_category(n) for n in hist if "conv2d_kernel" in n or "fa_kernel" in n}
    assert names == {"conv", "attention"}, list(hist)
    cats = pa.by_category(prof)
    assert cats["conv"] > 0 and cats["attention"] > 0
    assert cats["attention_temporal"] == 0
    scopes = pa.by_scope(prof)
    assert scopes.get("stage", 0) >= 0.9 * (cats["conv"] + cats["attention"]), scopes
    b = pa.busy(prof, window_ms=1e3)
    assert 0 < b["busy_ms"] < 1e3 and b["launches"] >= 2
    # busy and the histogram read the kineto results, the scopes the
    # FunctionEvents: both views hold the same work
    events = pa.device_events(prof)
    assert b["launches"] == len(events) == sum(v["launches"] for v in hist.values())
    assert sum(v["ms"] for v in hist.values()) == pytest.approx(
        sum(e.time_range.end - e.time_range.start for e in events) / 1e3, rel=1e-6)


# ---------------------------------------------------------------------------
# Training: the kernel tier's autograd Functions and a train step on the card
# ---------------------------------------------------------------------------

# (B, H, W, C_in, C_out, K, stride) and the epilogues whose every operand
# (and the emitted statistics' cotangent) the conv's Function pulls back
GRAD_CONV_CASES = [((2, 16, 16, 32, 64, 3, 1), EPILOGUES[6]), ((2, 16, 16, 32, 64, 3, 1),
                                                               EPILOGUES[7]),
                   ((1, 17, 11, 8, 16, 3, 2), EPILOGUES[5]), ((2, 12, 12, 64, 32, 1, 1),
                                                               EPILOGUES[3])]
# (B, Sq, Skv, H, KVH, D, causal, window, kv_offset)
GRAD_ATTN_CASES = [(2, 256, 256, 8, 8, 40, False, None, 0), (2, 256, 77, 8, 8, 80, False, None, 0),
                   (1, 300, 300, 8, 2, 64, True, None, 0), (1, 200, 200, 4, 4, 64, True, 64, 0),
                   (1, 100, 164, 4, 1, 128, True, None, 64)]
GRAD = dict(rtol=1e-4, atol=1e-4)


def _grads_of(fn, ops, cot):
    leaves = [None if o is None else o.detach().requires_grad_(True) for o in ops]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    wrt = [t for t in leaves if t is not None]
    grads = iter(torch.autograd.grad(outs, wrt, cot))
    return out, [next(grads) if t is not None else None for t in leaves]


def _function_vs_plain(kernel_fn, plain_fn, ops, cot, name):
    """The kernel tier's Function on the card against plain autograd on the
    same inputs: one launch in the forward, none in the backward, and every
    operand's gradient within 1e-4 of the output's scale."""
    build.launches.clear()
    out, grads = _grads_of(kernel_fn, ops, cot)
    assert build.launches[name] == 1, dict(build.launches)
    gold_out, gold = _grads_of(plain_fn, ops, cot)
    for g, gg in zip(grads, gold):
        assert (g is None) == (gg is None)
        if g is not None:
            _close_scaled(g.cpu(), gg.cpu(), GRAD)
    return out, gold_out


@pytest.mark.gpu
@pytest.mark.parametrize("shape,combo", GRAD_CONV_CASES,
                         ids=lambda c: "-".join(map(str, c)) if isinstance(c, tuple)
                         else "-".join(sorted(c)))
def test_conv2d_function_grads_on_the_card_match_plain(h100, shape, combo):
    from repro_torch.kernels.conv2d import ops as conv_ops

    x, w, kw = _conv_case(shape, combo, seed=9)
    t = {k: torch.from_numpy(v).to(h100) for k, v in kw.items() if isinstance(v, np.ndarray)}
    ops = [torch.from_numpy(x).to(h100), torch.from_numpy(w).to(h100), t.get("gn_a"),
           t.get("gn_b"), t.get("bias"), t.get("temb"), t.get("residual")]
    static = dict(stride=kw["stride"], gn_silu=kw.get("gn_silu", True),
                  silu=kw.get("silu", False), emit_stats=kw["emit_stats"])

    def run(impl):
        def f(x, w, a, b, bias, temb, res):
            return conv_ops.conv2d(x, w, gn_affine=None if a is None else (a, b), bias=bias,
                                   temb=temb, residual=res, impl=impl, **static)
        return f

    B, H, W, Cin, Cout, K, s = shape
    OH, OW = (H + 2 * (K // 2) - K) // s + 1, (W + 2 * (K // 2) - K) // s + 1
    g = torch.Generator(device="cuda").manual_seed(1)
    cot = (torch.randn((B, OH, OW, Cout), generator=g, device=h100),)
    if kw["emit_stats"]:
        cot += (1e-3 * torch.randn((B, 2, Cout), generator=g, device=h100),)
    _function_vs_plain(run("kernel"), run("torch"), ops, cot, "conv2d")


@pytest.mark.gpu
@pytest.mark.parametrize("case", GRAD_ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_function_grads_on_the_card_match_plain(h100, case):
    from repro_torch.kernels.flash_attention import ops as fa_ops

    B, Sq, Skv, H, KVH, D, causal, window, offset = case
    q, k, v = (torch.from_numpy(a).to(h100) for a in _attn_inputs(case, seed=3))
    kw = dict(causal=causal, window=window, kv_offset=offset)
    cot = (torch.randn_like(q),)
    _function_vs_plain(lambda q, k, v: fa_ops.attention(q, k, v, impl="kernel", **kw),
                       lambda q, k, v: fa_ops.attention(q, k, v, impl="torch", **kw),
                       [q, k, v], cot, "flash_attention")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 4096, 320, 32), (2, 64, 1280, 32), (2, 100, 64, 8)])
def test_groupnorm_function_grads_on_the_card_match_plain(h100, shape):
    """The Function's backward differentiates the one-pass variance the
    kernel computes; the torch tier's plain version is two-pass."""
    from repro_torch.kernels.groupnorm_silu import ops as gn_ops
    from repro_torch.kernels.groupnorm_silu import ref as gn_ref

    B, N, C, groups = shape
    rng = np.random.default_rng(4)
    x = torch.from_numpy((2 * rng.standard_normal((B, N, C)) + 1).astype(np.float32)).to(h100)
    scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(C)).astype(np.float32)).to(h100)
    bias = torch.from_numpy((0.1 * rng.standard_normal(C)).astype(np.float32)).to(h100)
    cot = (torch.randn_like(x),)
    _function_vs_plain(
        lambda x, s, b: gn_ops.groupnorm_silu(x, s, b, groups=groups, impl="kernel"),
        lambda x, s, b: gn_ref.groupnorm_silu_onepass_ref(x, s, b, groups=groups),
        [x, scale, bias], cot, "groupnorm_silu")


# The temporal Functions at a train microbatch of one Make-A-Video video (B·F
# = 16 frames): its three temporal sites' (B, F, N, C) conv inputs and (B, F,
# HW, H, D) attention inputs, and Phenaki's F = 11 attention
GRAD_TCONV_SHAPES = [(1, 16, 1024, 640), (1, 16, 256, 1280), (1, 16, 64, 1280)]
GRAD_TATTN_SHAPES = [(1, 16, 1024, 10, 64), (1, 16, 256, 20, 64), (1, 16, 64, 20, 64),
                     (2, 11, 256, 24, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GRAD_TCONV_SHAPES, ids=lambda c: "x".join(map(str, c)))
def test_temporal_conv_function_grads_on_the_card_match_plain(h100, shape):
    from repro_torch.kernels.conv2d import ops as conv_ops

    B, F, N, C = shape
    rng = np.random.default_rng(6)
    x, w, b = _on(h100, torch.float32, rng.standard_normal((B, F, N, 1, C)).astype(np.float32),
                  (0.05 * rng.standard_normal((3, C, C))).astype(np.float32),
                  (0.1 * rng.standard_normal(C)).astype(np.float32))
    cot = (torch.randn_like(x),)
    _function_vs_plain(lambda x, w, b: conv_ops.temporal_conv1d(x, w, b, impl="kernel"),
                       lambda x, w, b: conv_ops.temporal_conv1d(x, w, b, impl="torch"),
                       [x, w, b], cot, "temporal_conv1d")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GRAD_TATTN_SHAPES, ids=lambda c: "x".join(map(str, c)))
def test_temporal_attention_function_grads_on_the_card_match_plain(h100, shape):
    from repro_torch.kernels.flash_attention import ops as fa_ops

    q, k, v = _on(h100, torch.float32, *_tattn_inputs(shape, seed=12))
    cot = (torch.randn_like(q),)
    _function_vs_plain(lambda q, k, v: fa_ops.temporal_attention(q, k, v, impl="kernel"),
                       lambda q, k, v: fa_ops.temporal_attention(q, k, v, impl="torch"),
                       [q, k, v], cot, "temporal_flash_attention")


def _step_grads(model, loss_of):
    from repro_torch.nn import trainable

    params = trainable(model)
    loss = loss_of()
    return loss.detach(), dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                               allow_unused=True)))


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["tiny-sd", "olmo-1b", "make-a-video"])
def test_reduced_train_step_kernel_tier_matches_torch_tier(h100, which):
    """A reduced model's loss and every leaf's gradient on the card: the
    kernel tier (the Functions, the fused structure) against the torch
    tier; the forward launches the hand kernels and the backward none."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.tiny import TINY_TTI_CASCADE
    from repro_torch.data import SyntheticLMData, SyntheticTTIData
    from repro_torch.models.diffusion import DiffusionPipeline
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.nn import init_module
    from repro_torch.training.trainer import step_generator
    from repro_torch.workload import reduced_workload

    if which == "tiny-sd":
        cfg = TINY_TTI_CASCADE
        model = init_module(DiffusionPipeline(cfg), 0, h100)
        b = SyntheticTTIData(latent_hw=cfg.latent_size, latent_ch=cfg.unet.in_channels,
                             text_vocab=cfg.text.vocab, text_len=cfg.text.max_len,
                             global_batch=2).batch_at(0)
        batch = {k: torch.from_numpy(v).to(h100) for k, v in b.items()}
        t, eps = model.train_noise(tuple(batch["latents"].shape), step_generator(0, 0))
        kernels = ("conv2d", "flash_attention", "groupnorm_silu")

        def loss_of(impl):
            return lambda: model.denoise_loss(batch, t, eps, impl=impl)
    elif which == "make-a-video":
        wl = reduced_workload(get_config("make-a-video"))
        cfg = wl.cfg
        model = wl.init(0, h100)
        rng = np.random.default_rng(0)
        video = rng.standard_normal((2, cfg.frames, cfg.image_size, cfg.image_size,
                                     cfg.unet.in_channels)).astype(np.float32)
        batch = {"video": torch.from_numpy(video).to(h100),
                 "text": torch.from_numpy(rng.integers(0, cfg.text.vocab,
                                                       (2, cfg.text.max_len))).to(h100)}
        t, eps = model.train_noise(tuple(batch["video"].shape), step_generator(0, 0))
        kernels = ("conv2d", "flash_attention", "groupnorm_silu", "temporal_conv1d",
                   "temporal_flash_attention")

        def loss_of(impl):
            return lambda: model.denoise_loss(batch, t, eps, impl=impl)
    else:
        model = init_module(TransformerLM(reduced(get_config("olmo-1b"))), 0, h100)
        b = SyntheticLMData(vocab=model.cfg.vocab, seq_len=64, global_batch=2).batch_at(0)
        batch = {k: torch.from_numpy(v).to(h100) for k, v in b.items()}
        kernels = ("flash_attention",)

        def loss_of(impl):
            return lambda: model.loss(batch, impl=impl)

    build.launches.clear()
    with torch.no_grad():
        loss_of("kernel")()
    plan = dict(build.launches)
    assert all(plan.get(k, 0) > 0 for k in kernels), plan
    build.launches.clear()
    k_loss, k_grads = _step_grads(model, loss_of("kernel"))
    assert dict(build.launches) == plan  # the backward launches no hand kernel
    t_loss, t_grads = _step_grads(model, loss_of("torch"))
    assert abs(float(k_loss) - float(t_loss)) <= 1e-3 * abs(float(t_loss))
    total = torch.sqrt(sum(g.norm() ** 2 for g in t_grads.values() if g is not None))
    for key, g in t_grads.items():
        if g is None or not g.abs().max() > 0:
            continue
        kg = k_grads[key]
        assert kg is not None and kg.abs().max() > 0, key
        # relative to the leaf's norm, or to 1e-6 of the global norm where the
        # exact gradient is 0 (an attention key bias: roundoff on both tiers)
        assert float((kg - g).norm() / torch.clamp(g.norm(), min=1e-6 * total)) < 1e-2, key


@pytest.mark.gpu
def test_train_launcher_runs_reduced_on_the_card(h100, tmp_path):
    from repro_torch.launch import train

    build.launches.clear()
    model, state, history = train.main(
        ["--arch", "olmo-1b", "--reduced", "--steps", "3", "--batch", "2", "--seq", "64",
         "--ckpt-dir", str(tmp_path)], log=lambda *_: None)
    assert next(model.parameters()).device.type == "cuda"
    assert len(history) == 3 and all(np.isfinite(history))
    assert build.launches["flash_attention"] == 3 * model.cfg.n_layers


# ---------------------------------------------------------------------------
# The step counter (core.hlo_analysis): a launch counts as its plain version
# ---------------------------------------------------------------------------


def _counted_prefill(model, cfg, tokens):
    from repro_torch.core import hlo_analysis
    from repro_torch.launch import steps
    from repro_torch.nn import param_defs

    prefill = steps.make_prefill_step(model, cfg, impl="kernel")
    leaves = {k: model.get_parameter(k) for k in param_defs(model)}
    with torch.inference_mode():
        return hlo_analysis.record_step(lambda params, batch: prefill(batch), leaves,
                                        {"tokens": tokens})


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmo-1b", "glm4-9b"])
def test_step_counter_counts_a_prefill_alike_on_meta_and_on_the_card(h100, arch):
    """A reduced LM's prefill on the kernel tier: on the card each layer
    launches the flash kernel, counted as its plain version on ``meta``, so
    the flops, bytes and op histogram equal the ``meta`` count's exactly."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import hlo_analysis
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.nn import init_params, materialize

    cfg = reduced(get_config(arch))
    tokens = torch.randint(0, cfg.vocab, (2, 96), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(0))
    card = materialize(TransformerLM(cfg), init_params(TransformerLM(cfg), 0), "cuda")
    _, on_meta = _counted_prefill(TransformerLM(cfg), cfg, tokens.to("meta"))
    build.launches.clear()
    (logits, _, _), on_card = _counted_prefill(card, cfg, tokens.cuda())
    torch.cuda.synchronize()
    assert build.launches["flash_attention"] == cfg.n_layers
    assert torch.isfinite(logits).all()
    assert on_card.flops == on_meta.flops > 0
    assert on_card.bytes_accessed == on_meta.bytes_accessed > 0
    assert on_card.ops == on_meta.ops
    assert (hlo_analysis.memory_summary(on_card)["argument_size_in_bytes"]
            == hlo_analysis.memory_summary(on_meta)["argument_size_in_bytes"])


# ---------------------------------------------------------------------------
# the mesh under the torch installed beside the card
# ---------------------------------------------------------------------------

MESH_COVER = torch_mesh_ranks.cover_cases()


@pytest.fixture(scope="module")
def mesh_cover(tmp_path_factory):
    """``tests/torch_mesh_ranks.py``'s coverage, alone, on a CPU gloo world of
    4 ranks (2 x 2) and seeded models.  ``tests/test_torch_mesh.py`` runs it
    under the CPU tests' torch; here it runs under the card's, whose DTensor
    lacks rules the port registers (``parallel/sharding.py::
    install_dtensor_rules``), so those rules run on every card test run."""
    if not torch.cuda.is_available():
        pytest.skip("needs the torch installed beside the card (run on the H100: pytest -m gpu)")
    workdir = str(tmp_path_factory.mktemp("mesh_cover"))
    torch.save({}, os.path.join(workdir, "inputs.pt"))
    return torch_mesh_ranks.spawn(4, workdir, 600.0, only=("coverage",))


@pytest.mark.gpu
@pytest.mark.parametrize("arch,route,n", MESH_COVER, ids=[f"{a}-{r}-{n}" for a, r, n in MESH_COVER])
def test_mesh_serves_uneven_batches_under_the_card_torch(mesh_cover, arch, route, n):
    """A stage batch of 1 or 3 on the 2 x 2 mesh gives each request the
    output the mesh-free engine gives it (tokens equal, images within
    fp32), on every rank."""
    torch_mesh_ranks.check_coverage(mesh_cover, arch, route, n)
