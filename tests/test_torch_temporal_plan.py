"""The temporal attention kernel's launch plan, on the CPU.

``csrc/temporal_attention.cu`` runs on the card only; what can be checked
here is the Python around it and the index arithmetic it relies on:

- ``flash_attention.temporal_plan`` at the three temporal attention calls
  of Make-A-Video at full width, the card tests' shapes and a ragged HW:
  the warps' walk over work items (warp w takes items w, w + all warps,
  ...), emulated in numpy, covers every (batch, position, head) exactly
  once; shared memory stays within a block's 227 KB for every F <= 32 and
  D <= 256; the main-path calls fill the card;
- the kernel's copy walk (32 rows x D/4 chunks of a stage, 32 chunks a
  step, by an incremental row/chunk update instead of a division) reaches
  every chunk once;
- the staged rows' stride keeps the lanes' q-row reads free of bank
  conflicts.

No JAX here: the file runs in a few seconds.
"""

import numpy as np
import pytest

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention as kernel
from test_torch_cuda import TATTN_CARD_CASES, TATTN_CASES

# (B, F, HW, H, D) of every temporal attention call on Make-A-Video's main
# path (the temporal stage, 2 videos of 16 frames), as chip_smoke.py records them
MAIN_PATH = [(2, 16, 1024, 10, 64), (2, 16, 256, 20, 64), (2, 16, 64, 20, 64)]
SHAPES = (MAIN_PATH + [c[0] for c in TATTN_CARD_CASES]
          + [(2, F, 40, 4, D) for F, D in TATTN_CASES] + [(3, 16, 1001, 5, 64)])


def _ids(c):
    return "x".join(map(str, c))


def _walk(B, F, HW, H, D, p):
    """(b, n, h) coverage counts of the grid's warps, and items per warp."""
    warps = p.blocks * p.warps
    items = np.arange(p.items)
    tiles = -(-HW // p.positions)
    h, rest = items % H, items // H
    tile, b = rest % tiles, rest // tiles
    n = tile[:, None] * p.positions + np.arange(p.positions)[None]
    ok = n < HW
    count = np.zeros((B, HW, H), np.int64)
    np.add.at(count, (np.broadcast_to(b[:, None], n.shape)[ok], n[ok],
                      np.broadcast_to(h[:, None], n.shape)[ok]), 1)
    per_warp = np.bincount(items % warps, minlength=warps)
    return count, per_warp


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_plan_covers_every_position_once_within_the_card(shape):
    B, F, HW, H, D = shape
    for elem in (4, 2):
        p = kernel.temporal_plan(B, F, HW, H, D, elem)
        assert p.frames >= F and p.frames in (4, 8, 16, 32)
        assert p.positions * p.frames == 32  # one item a warp, one lane a query row
        assert p.items == B * H * -(-HW // p.positions)
        assert p.smem <= build.SMEM_LIMIT and 1 <= p.warps <= kernel.TEMPORAL_WARPS
        assert p.smem == p.warps * p.stages * 3 * 32 * p.row_stride * elem
        assert p.stages >= 2  # the next item's copies fly while one computes
        count, per_warp = _walk(B, F, HW, H, D, p)
        assert count.min() == 1 and count.max() == 1
        assert per_warp.max() == p.items_per_warp
        assert per_warp.max() - per_warp.min() <= 1  # the walk balances the warps


@pytest.mark.parametrize("shape", MAIN_PATH, ids=_ids)
def test_main_path_calls_fill_the_card_with_pipelined_warps(shape):
    p = kernel.temporal_plan(*shape, 4)
    assert (p.frames, p.positions, p.row_stride, p.warps) == (16, 2, 68, 4)
    assert p.blocks == build.SMS  # one block of 4 warps on every SM
    assert p.items_per_warp >= 3  # each warp walks a stream of items
    # 26 KB of copies in flight a warp: ~100-200 KB an SM, past the ~32 KB
    # that HBM's latency asks for
    assert p.smem // p.warps // p.stages >= 26_000
    assert kernel.temporal_plan(*shape, 2).blocks == 2 * build.SMS


def test_few_items_take_few_blocks():
    p = kernel.temporal_plan(1, 16, 8, 2, 64, 4)
    assert p.items == 8 and p.blocks == 2 and p.items_per_warp == 1


@pytest.mark.parametrize("F", range(1, kernel.MAX_FRAMES + 1))
def test_every_frame_count_and_head_dim_fits_a_block(F):
    for D in range(1, kernel.MAX_HEAD_DIM + 1):
        for elem in (4, 2):
            p = kernel.temporal_plan(1, F, 64, 1, D, elem)
            assert p.smem <= build.SMEM_LIMIT
            assert p.row_stride >= -(-D // 8) * 8 and p.row_stride % 8 == 4


def _walk_chunks(D4, lane):
    """``walk_chunks`` of csrc/temporal_attention.cu for one lane."""
    r, c4 = divmod(lane, D4)
    rstep, cstep = 32 // D4, 32 % D4
    out = []
    while r < 32:
        out.append((r, c4))
        r, c4 = r + rstep, c4 + cstep
        if c4 >= D4:
            c4, r = c4 - D4, r + 1
    return out


@pytest.mark.parametrize("D4", range(1, kernel.MAX_HEAD_DIM // 4 + 1))
def test_copy_walk_reaches_every_chunk_once(D4):
    seen = [rc for lane in range(32) for rc in _walk_chunks(D4, lane)]
    assert sorted(seen) == [(r, c) for r in range(32) for c in range(D4)]


@pytest.mark.parametrize("F", [16, 32])
@pytest.mark.parametrize("elem", [4, 2])
def test_query_row_reads_are_free_of_bank_conflicts(elem, F):
    """Lane (position pp, half h, r) reads 4 elements of query rows r and
    r + F/2 over half h of the head dim, at row * row_stride + h * DH + d: a
    16-byte load (fp32, served 8 lanes a pass) or an 8-byte one (bf16, 16
    lanes a pass) whose lanes must fall on distinct 4-byte banks: at every
    head dim in fp32 (the model's dtype), and in bf16 at 32 frames or the
    path's head dim of 64 (elsewhere bf16 at 16 frames takes 2-way
    conflicts)."""
    lanes_per_pass = 8 if elem == 4 else 16
    half = F // 2
    dims = [64] if (elem, F) == (2, 16) else range(4, kernel.MAX_HEAD_DIM + 1, 4)
    for D in dims:
        rs = kernel.temporal_plan(1, F, 64, 1, D, elem).row_stride
        dh = (rs - 4) // 2
        for row0 in (0, half):
            for d in range(0, dh, 4):
                for first in range(0, 32, lanes_per_pass):
                    words = []
                    for lane in range(first, first + lanes_per_pass):
                        pp, h, r = lane // F, (lane // half) % 2, lane % half
                        at = ((pp * F + row0 + r) * rs + h * dh + d) * elem // 4
                        words += [at + w for w in range(elem)]
                    assert len({w % 32 for w in words}) == len(words), (D, d)
