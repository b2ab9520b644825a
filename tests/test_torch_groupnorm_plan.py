"""The GroupNorm kernel's launch plan and its arithmetic, on the CPU.

``csrc/groupnorm_silu.cu`` runs on the card only; what can be checked here
is the Python around it and the order in which it sums:

- ``groupnorm_silu.plan`` at the seven GroupNorm calls of the two ported
  paths at full width, the card tests' shapes and a ragged N: the kernel's
  thread mapping, emulated in numpy, touches every (batch, row, channel)
  exactly once; chunks are whole groups; shared memory and clusters stay
  within the card's limits; Stable Diffusion's calls fill 128 blocks;
- a numpy emulation of the kernel's fixed reduction order (fp32 partials
  per thread, then per row lane, channel, group and cluster rank; the
  one-pass variance), against float64 at full-width shapes and against the
  Pallas kernel in interpret mode at the small shapes of
  ``tests/test_torch_kernels.py``.

JAX only in the interpret-mode comparison, at tiny shapes.
"""

import numpy as np
import pytest

from repro_torch.kernels import build
from repro_torch.kernels.groupnorm_silu import groupnorm_silu as kernel
from test_torch_cuda import F32, GN_CARD_SHAPES, GN_SR_SHAPES

# (B, N, C) of every GroupNorm call on the two main paths (the
# SpatialTransformer input norms; 32 groups, no SiLU), as chip_smoke.py
# records them: Stable Diffusion, then Make-A-Video (frames in the batch)
MAIN_PATH = [(2, 4096, 320), (2, 1024, 640), (2, 256, 1280), (2, 64, 1280),
             (32, 1024, 640), (32, 256, 1280), (32, 64, 1280)]
SHAPES = [(*s, 32) for s in MAIN_PATH] + GN_CARD_SHAPES + [(2, 1001, 640, 32), (1, 3, 1280, 32)]


def _ids(c):
    return "x".join(map(str, c))


def _thread_map(p):
    """The kernel's threads: (row lane, first column vector) of each active
    thread, and the stride across column vectors."""
    wv = p.width // p.vec
    ct = min(wv, kernel.THREADS)
    t = np.arange(kernel.THREADS)
    rl, c0 = t // ct, t % ct
    active = rl < kernel.THREADS // ct
    return rl[active], c0[active], ct, wv


def _touches(N, C, G, p):
    """How often the kernel's threads read each (row, channel) of one batch
    image (grid z repeats it per batch)."""
    rl, c0, ct, wv = _thread_map(p)
    count = np.zeros((N, C), np.int64)
    for chunk in range(p.chunks):
        for rank in range(p.cluster):
            r0 = rank * p.rows_per_block
            nr = max(0, min(N, r0 + p.rows_per_block) - r0)
            rows = rl[:, None] + p.row_lanes * np.arange(-(-nr // p.row_lanes) + 1)[None]
            cvs = c0[:, None] + ct * np.arange(-(-wv // ct))[None]
            r = np.broadcast_to(rows[:, :, None, None],
                                (len(rl), rows.shape[1], cvs.shape[1], p.vec))
            c = (chunk * p.width + cvs[:, None, :, None] * p.vec
                 + np.arange(p.vec)[None, None, None, :])
            c = np.broadcast_to(c, r.shape)
            ok = (r < nr) & ((c - chunk * p.width) < p.width)
            np.add.at(count, (r0 + r[ok], c[ok]), 1)
    return count


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_plan_covers_every_element_once_within_the_card(shape):
    B, N, C, G = shape
    for elem in (4, 2):
        p = kernel.plan(B, N, C, G, elem)
        cpg = C // G
        # chunks are whole groups that tile C
        assert p.width == p.groups_per_chunk * cpg and p.chunks * p.width == C
        assert p.chunks <= kernel.MAX_CHUNKS
        assert p.vec in (1, 4) and p.width % p.vec == 0
        # clusters split N with no empty block, within the portable size;
        # the smallest of 1, 2, 4 whose grid fills the card with blocks of at
        # most ROWS_BYTES of rows, else 8
        assert 1 <= p.cluster <= kernel.MAX_CLUSTER
        fits = [c for c in (1, 2, 4) if B * p.chunks * c >= build.SMS
                and -(-N // c) * p.width * elem <= kernel.ROWS_BYTES]
        assert -(-N // p.rows_per_block) == p.cluster
        assert p.rows_per_block == -(-N // (fits[0] if fits else kernel.MAX_CLUSTER))
        assert (p.cluster - 1) * p.rows_per_block < N <= p.cluster * p.rows_per_block
        assert p.smem <= build.SMEM_LIMIT
        scratch = 4 * (2 * p.row_lanes * p.width + 4 * p.groups_per_chunk)
        cache = -(-p.rows_per_block * p.width * elem // 16) * 16
        assert p.smem == scratch + (cache if p.cached else 0)
        assert p.cached == (scratch + cache <= build.SMEM_LIMIT)
        assert p.blocks == B * p.chunks * p.cluster
    count = _touches(N, C, G, kernel.plan(B, N, C, G, 4))
    assert count.min() == 1 and count.max() == 1


@pytest.mark.parametrize("shape", MAIN_PATH, ids=_ids)
def test_main_path_calls_load_vectors_and_keep_their_rows(shape):
    B, N, C = shape
    for elem in (4, 2):
        p = kernel.plan(B, N, C, 32, elem)
        assert p.vec == 4 and p.cached and p.chunks == 8
        assert p.blocks >= 128  # SD: 128 blocks on 132 SMs, 64 before
        assert p.smem < 50_000 or B == 2  # up to 4 blocks an SM where the grid allows
    # fp32: SD's 16 clusters take 8 blocks each; Make-A-Video's 256 clusters
    # take 8, 4 and 1 blocks at N = 1024, 256 and 64 (2048, 1024, 256 blocks)
    expect = {2: 8, 1024: 8, 256: 4, 64: 1}
    assert kernel.plan(B, N, C, 32, 4).cluster == (8 if B == 2 else expect[N])


def test_unaligned_data_and_odd_groups_take_scalar_loads():
    assert kernel.plan(2, 4096, 320, 32, 4, aligned=False).vec == 1
    p = kernel.plan(2, 50, 27, 9, 4)  # 3-channel groups, no chunk 4 channels wide
    assert p.vec == 1 and p.width % 3 == 0


# (B, N, C) of every GroupNorm kernel call on the cascade paths at full width
# (32 groups): Imagen's base UNet (32/16/8 px) and SR2's 128 px mid block,
# then prod-image's UNet (96/48/24/12 px)
CASCADE_PATH = [(2, 1024, 1024), (2, 256, 2048), (2, 64, 2048), (2, 16384, 512),
                (2, 9216, 384), (2, 2304, 768), (2, 576, 1536), (2, 144, 1536)]
# SR2's own widths, 2 and 4 channels a group over its 1024 and 512 px levels
SR2_WIDTHS = [(2, 1048576, 64, 32), (2, 1048576, 128, 32), (2, 262144, 128, 32)]


@pytest.mark.parametrize("shape", [(*s, 32) for s in CASCADE_PATH] + SR2_WIDTHS + GN_SR_SHAPES,
                         ids=_ids)
def test_plan_at_the_cascade_shapes_stays_within_the_card(shape):
    """No empty block, the grid (cluster, chunks, B) within CUDA's limits,
    32-bit element and group counts, and the cached choice: rows stay in
    shared memory exactly where they fit beside the scratch."""
    B, N, C, G = shape
    assert N * C < 2 ** 31 and N * (C // G) < 2 ** 31
    for elem in (4, 2):
        p = kernel.plan(B, N, C, G, elem)
        assert (p.cluster - 1) * p.rows_per_block < N <= p.cluster * p.rows_per_block
        assert 1 <= p.cluster <= kernel.MAX_CLUSTER and p.chunks <= kernel.MAX_CHUNKS
        assert B < 2 ** 16 and p.blocks == B * p.chunks * p.cluster
        assert p.vec == 4 and p.smem <= build.SMEM_LIMIT
        scratch = 4 * (2 * p.row_lanes * p.width + 4 * p.groups_per_chunk)
        rows_bytes = -(-p.rows_per_block * p.width * elem // 16) * 16
        assert p.cached == (scratch + rows_bytes <= build.SMEM_LIMIT)
        if N >= 262144:  # SR2's widths re-read their rows
            assert not p.cached and p.width % 8 == 0
        elif (B, N, C) in CASCADE_PATH:
            # SR2's mid block: 2048 rows of 64 channels a block, 512 KB in
            # fp32, re-read; the other main-path calls keep their rows
            assert p.cached == ((B, N, C) != (2, 16384, 512)) and p.blocks >= 128


def test_large_slabs_take_the_re_read_plan():
    p = kernel.plan(1, 65536, 320, 32, 4)
    assert not p.cached and p.smem < 16_384
    assert kernel.plan(1, 8192, 320, 32, 4).cached  # 1024 rows of 40 channels a block


# ---------------------------------------------------------------------------
# The kernel's arithmetic, emulated in numpy
# ---------------------------------------------------------------------------


def emulate(x, scale, bias, *, groups, eps=1e-5, silu=True):
    """``csrc/groupnorm_silu.cu`` in numpy float32, in its summation order:
    each thread sums its channels down its rows (row lane l takes rows l,
    l + R, ...); the row lanes are folded in order, then each group's
    channels, then the cluster's ranks; mean and E[x^2] - mean^2 per group."""
    B, N, C = x.shape
    f32 = np.float32
    p = kernel.plan(B, N, C, groups, 4)
    cpg, W, R = C // groups, p.width, p.row_lanes
    xs = x.astype(f32).reshape(B, N, p.chunks, W)
    tot = np.zeros((2, B, p.chunks, p.groups_per_chunk), f32)
    for rank in range(p.cluster):
        rows = xs[:, rank * p.rows_per_block: (rank + 1) * p.rows_per_block]
        lanes = np.zeros((2, B, R, p.chunks, W), f32)
        for t in range(0, rows.shape[1], R):
            blk = rows[:, t: t + R]
            m = blk.shape[1]
            lanes[0, :, :m] += blk
            lanes[1, :, :m] += blk * blk
        chan = np.zeros((2, B, p.chunks, W), f32)
        for lane in range(R):
            chan += lanes[:, :, lane]
        chan = chan.reshape(2, B, p.chunks, p.groups_per_chunk, cpg)
        part = np.zeros((2, B, p.chunks, p.groups_per_chunk), f32)
        for c in range(cpg):
            part += chan[..., c]
        tot += part
    count = f32(N * cpg)
    mean = tot[0] / count
    var = tot[1] / count - mean * mean
    rstd = f32(1) / np.sqrt(var + f32(eps))
    mean_c = np.repeat(mean, cpg, axis=-1)[:, None]  # (B, 1, chunks, W)
    rstd_c = np.repeat(rstd, cpg, axis=-1)[:, None]
    y = (xs - mean_c) * rstd_c
    y = y * scale.astype(f32).reshape(p.chunks, W) + bias.astype(f32).reshape(p.chunks, W)
    if silu:
        y = y / (f32(1) + np.exp(-y))
    return y.reshape(B, N, C)


def _inputs(B, N, C, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, N, C), np.float32) * 3 + 1).astype(np.float32)
    s = (rng.standard_normal(C) * 0.5 + 1).astype(np.float32)
    b = (rng.standard_normal(C) * 0.1).astype(np.float32)
    return x, s, b


@pytest.mark.parametrize("shape", [(2, 4096, 320), (32, 1024, 640)], ids=_ids)
def test_emulated_reduction_order_meets_fp32_tolerance_against_float64(shape):
    x, s, b = _inputs(*shape, seed=21)
    out = emulate(x, s, b, groups=32, silu=False)
    B, N, C = shape
    for i in range(0, B, 4):  # float64 a few images at a time
        xg = x[i: i + 4].astype(np.float64).reshape(-1, N, 32, C // 32)
        mean = xg.mean(axis=(1, 3), keepdims=True)
        var = xg.var(axis=(1, 3), keepdims=True)
        gold = ((xg - mean) / np.sqrt(var + 1e-5)).reshape(-1, N, C) * s + b
        np.testing.assert_allclose(out[i: i + 4], gold, **F32)


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape", [(2, 100, 64, 8), (1, 37, 96, 32)], ids=_ids)
def test_emulated_kernel_matches_the_pallas_kernel_in_interpret_mode(shape, silu):
    import jax.numpy as jnp

    from repro.kernels.groupnorm_silu import ops as j_gn_ops

    B, N, C, G = shape
    x, s, b = _inputs(B, N, C, seed=5)
    interp = j_gn_ops.groupnorm_silu(*map(jnp.asarray, (x, s, b)), groups=G, silu=silu,
                                     impl="interpret", block_n=32)
    np.testing.assert_allclose(emulate(x, s, b, groups=G, silu=silu), np.asarray(interp), **F32)
