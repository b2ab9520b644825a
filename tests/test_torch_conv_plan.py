"""The conv2d kernel's launch plan and its 3xTF32 arithmetic, on the CPU.

``csrc/conv2d.cu`` runs on the card only; what can be checked here is the
Python around it:

- ``conv2d.plan`` at every conv call of the two ported paths at full width,
  found by running the full-size models on the ``meta`` device (shapes
  only, no arithmetic): the grid fills the card or is left whole, and the
  split-K slices are whole chunks that cover the reduction exactly;
- why the kernel spends three TF32 MMAs on each fp32 product: a numpy
  emulation of TF32 rounding against a float64 product;
- the wrapper on CPU tensors, which takes the plain version.

No JAX here: the file runs in a few seconds.
"""

import collections

import numpy as np
import pytest
import torch

from repro_torch.configs.suite import MAKE_A_VIDEO, STABLE_DIFFUSION
from repro_torch.kernels import build
from repro_torch.kernels.conv2d import conv2d as kernel
from repro_torch.kernels.conv2d import ref as conv_ref
from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.groupnorm_silu import groupnorm_silu as gn_kernel
from repro_torch.kernels.groupnorm_silu import ref as gn_ref
from repro_torch.workload import workload_for
from test_torch_cuda import EPILOGUES, F32, TC_CONV_SHAPES, _conv_case


def _temporal_conv_ref(x, w, bias):
    B, F, N, C = x.shape
    return conv_ref.temporal_conv1d_ref(x.reshape(B, F, N, 1, C), w, bias).reshape(
        B, F, N, w.shape[-1])


@pytest.fixture(scope="module")
def conv_calls():
    """(B, OH, OW, C_out, R) -> count, for every conv2d call of one UNet
    step, one VideoUNet step and the VAE decoder at full width, per config."""
    calls = {}

    def recording(x, w, **kw):
        K, s = w.shape[0], kw.get("stride", 1)
        B, H, W, C_in = x.shape
        OH, OW = (H + 2 * (K // 2) - K) // s + 1, (W + 2 * (K // 2) - K) // s + 1
        calls[name][(B, OH, OW, w.shape[3], K * K * C_in)] += 1
        return conv_ref.conv2d_ref(x, w, **kw)

    meta = dict(device="meta")
    with pytest.MonkeyPatch.context() as mp, torch.inference_mode():
        # the wrappers take their plain versions, which run on meta tensors
        mp.setattr(kernel, "conv2d", recording)
        mp.setattr(kernel, "temporal_conv1d", _temporal_conv_ref)
        mp.setattr(fa_kernel, "flash_attention", fa_ref.attention_ref)
        mp.setattr(fa_kernel, "temporal_flash_attention", fa_ref.temporal_attention_ref)
        mp.setattr(gn_kernel, "groupnorm_silu", gn_ref.groupnorm_silu_ref)
        ctx = torch.empty(2, 77, 768, **meta)
        name = STABLE_DIFFUSION.name
        calls[name] = collections.Counter()
        sd = workload_for(STABLE_DIFFUSION).model
        sd.unet(torch.empty(2, 64, 64, 4, **meta), torch.empty(2, **meta), ctx, impl="kernel")
        sd.vae(torch.empty(2, 64, 64, 4, **meta), impl="kernel")
        name = MAKE_A_VIDEO.name
        calls[name] = collections.Counter()
        mav = workload_for(MAKE_A_VIDEO).model
        # keyframe stage: the 16 frames folded into the batch; temporal stage
        mav.vunet.unet(torch.empty(32, 64, 64, 4, **meta), torch.empty(32, **meta),
                       torch.empty(32, 77, 768, **meta), impl="kernel")
        mav.vunet(torch.empty(2, 16, 64, 64, 4, **meta), torch.empty(2, **meta), ctx,
                  impl="kernel")
    return calls


def _blocks(B, OH, OW, C_out, bm, bn):
    return B * -(-(OH * OW) // bm) * -(-C_out // bn)


@pytest.mark.parametrize("cfg", [STABLE_DIFFUSION, MAKE_A_VIDEO], ids=lambda c: c.name)
def test_plan_fills_the_card_at_every_main_path_conv(conv_calls, cfg):
    shapes = conv_calls[cfg.name]
    assert len(shapes) > 20
    for (B, OH, OW, C_out, R) in shapes:
        bm, bn, splits = kernel.plan(B, OH, OW, C_out, R)
        assert (bm, bn) in kernel.TILES
        blocks = _blocks(B, OH, OW, C_out, bm, bn)
        full = any(_blocks(B, OH, OW, C_out, *t) >= kernel.SMS for t in kernel.TILES
                   if (t[1] == 16) == (C_out <= 16))
        if full:  # a tile already fills the card: the reduction stays whole
            assert splits == 1, (B, OH, OW, C_out, R)
        else:  # split-K brings the grid to at least one wave
            assert splits > 1 and blocks * splits >= kernel.SMS, (B, OH, OW, C_out, R)
        got = kernel.slices(R, splits)
        assert len(got) == splits
        assert got[0][0] == 0 and got[-1][1] == R
        for (a, b), (c, _) in zip(got, got[1:]):
            assert b == c and (b - a) % kernel.CHUNK == 0
            assert (b - a) // kernel.CHUNK >= kernel.MIN_SLICE_CHUNKS
        # every MAV conv (B*F = 32) and those of SD's 64x64 (320 channels) and
        # 32x32 (640) levels; SD's level-0 downsample to 32x32 keeps 320
        # channels, an 80-block grid, and is split
        if cfg is MAKE_A_VIDEO or (C_out >= 320 and (OH >= 64 or (OH >= 32 and C_out >= 640))):
            assert splits == 1, (B, OH, OW, C_out, R)
    # SD's 8x8 level, the card's most starved grid (20 blocks), is split
    if cfg is STABLE_DIFFUSION:
        assert kernel.plan(2, 8, 8, 1280, 11520)[2] > 1


def test_card_test_shapes_reach_every_tile_split_and_unsplit():
    seen = collections.defaultdict(set)
    for B, H, W, C_in, C_out, K, s in TC_CONV_SHAPES:
        OH, OW = (H + 2 * (K // 2) - K) // s + 1, (W + 2 * (K // 2) - K) // s + 1
        bm, bn, splits = kernel.plan(B, OH, OW, C_out, K * K * C_in)
        seen[(bm, bn)].add(splits > 1)
    assert set(seen) == set(kernel.TILES)
    assert any(True in v for v in seen.values()) and any(False in v for v in seen.values())


def test_slices_cover_ragged_reductions():
    assert kernel.slices(36, 1) == [(0, 36)]
    assert kernel.slices(100, 3) == [(0, 64), (64, 100)]  # 4 chunks: no empty slice
    assert kernel.slices(11520, 13)[-1] == (10752, 11520)


# ---------------------------------------------------------------------------
# Why three MMAs: TF32 rounding emulated in numpy
# ---------------------------------------------------------------------------


def _tf32(v: np.ndarray) -> np.ndarray:
    """fp32 -> TF32 (10 stored significand bits), round to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``."""
    u = v.astype(np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_truncated(v: np.ndarray) -> np.ndarray:
    """An fp32 operand as the tensor core reads it: the low 13 bits dropped."""
    return (v.astype(np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _products(R, seed=0):
    """A (64, R) @ B (R, 64) with conv-like operands: SiLU'd activations and
    weights of the model's fan-in scale; the float64 product of the fp32
    inputs is the reference."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((64, R)).astype(np.float32)
    a = (a / (1 + np.exp(-a))).astype(np.float32)
    b = (rng.standard_normal((R, 64)) / np.sqrt(R)).astype(np.float32)
    return a, b, a.astype(np.float64) @ b.astype(np.float64)


def _passes(out, gold, R):
    """``chip_smoke.py``'s fp32 criterion for a conv of reduction length R:
    2e-5 widened by sqrt(R / 64), the absolute part scaled by max(1, max|gold|)."""
    widen = max(1.0, np.sqrt(R / 64))
    scale = max(1.0, np.abs(gold).max())
    return bool(np.all(np.abs(out - gold)
                       <= F32["atol"] * widen * scale + F32["rtol"] * widen * np.abs(gold)))


def _three_tf32(a, b):
    """``mma_tf32.cuh::split_tf32``: big rounded, small = v - big truncated."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32_truncated(a - a_big), _tf32_truncated(b - b_big)
    f32 = np.float32
    return (a_small @ b_big).astype(f32) + (a_big @ b_small).astype(f32) + (a_big @ b_big)


@pytest.mark.parametrize("R", [72, 11520, 23040])
def test_three_tf32_products_meet_the_fp32_tolerance(R):
    a, b, gold = _products(R)
    out = _three_tf32(a, b)
    assert out.dtype == np.float32
    assert _passes(out, gold, R)
    # and come as close to the float64 product as plain fp32 does
    plain = np.abs((a @ b) - gold).max()
    assert np.abs(out - gold).max() <= 4 * plain + 1e-7


def test_one_tf32_product_misses_the_fp32_tolerance():
    a, b, gold = _products(72)
    one = _tf32(a) @ _tf32(b)
    assert not _passes(one, gold, 72)


# ---------------------------------------------------------------------------
# The wrapper on CPU tensors
# ---------------------------------------------------------------------------


def test_wrapper_on_cpu_tensors_returns_the_plain_version_with_stats():
    x, w, kw = _conv_case((2, 8, 8, 64, 320, 3, 1), EPILOGUES[-1], seed=3)
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    before = dict(build.launches)
    out, stats = kernel.conv2d(xt, wt, **tkw)
    gold, gold_stats = conv_ref.conv2d_ref(xt, wt, **tkw)
    assert dict(build.launches) == before  # the plain version is no launch
    assert torch.equal(out, gold) and torch.equal(stats, gold_stats)
    assert stats.shape == (2, 2, 320)
