"""The flash-attention kernel's tensor-core arithmetic, emulated on the CPU.

``csrc/flash_attention.cu`` runs on the card only.  What can be checked here
is the arithmetic it is built on, in numpy against a float64 oracle:

- its online softmax over key tiles, with both products (Q.K^T and P.V) as
  3xTF32 MMAs whose 32-deep chunks the tensor core accumulates with
  truncation, added to the fp32 totals with rounded adds, and the softmax in
  log2 units (``scale * log2(e)``, ``exp2``), meets the fp32 tolerance at
  the main path's head dims and key counts;
- one TF32 product for P.V misses that tolerance;
- reading P straight from the accumulator fragment of S as the A fragment of
  P.V (key 2t as k = t, key 2t+1 as k = t+4) and V's B fragment with the same
  keys computes exactly P.V.

No JAX here: the file runs in a few seconds.
"""

import numpy as np
import pytest

from test_torch_conv_plan import _tf32, _tf32_truncated

F32 = dict(rtol=2e-5, atol=2e-5)  # chip_smoke.py's fp32 attention tolerance, unwidened
LOG2E = np.float32(1.4426950408889634)
CHUNK = 32  # depth summed from zero before a rounded add (csrc/flash_attention.cu kChunk)


def _rz(x: np.ndarray) -> np.ndarray:
    """float64 -> fp32 rounded toward zero, as the tensor core's accumulator."""
    x32 = x.astype(np.float32)
    over = np.abs(x32.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(x32, np.float32(0)), x32)


def _rn(x: np.ndarray) -> np.ndarray:
    """float64 -> fp32 rounded to nearest: one fused multiply-add's rounding."""
    return x.astype(np.float32)


def _split(v: np.ndarray):
    """``mma_tf32.cuh::split_tf32``: big rounded, small = v - big, as the core reads them."""
    big = _tf32(v)
    return big, _tf32_truncated(v - big)


def _mma_chunks(a: np.ndarray, b: np.ndarray, three: bool = True) -> list:
    """The CHUNK-deep partial products of a (M, R) @ b (R, N) as the kernel
    runs them: each chunk starts from zero, and per 8-deep MMA step the
    products (exact) join the accumulator with one truncation, small terms
    first.  ``three=False``: one TF32 product."""
    a_big, a_small = _split(a)
    b_big, b_small = _split(b)
    if not three:
        a_big, b_big = _tf32(a), _tf32(b)
    parts = []
    for c0 in range(0, a.shape[1], CHUNK):
        acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
        for k0 in range(c0, min(c0 + CHUNK, a.shape[1]), 8):
            ks = slice(k0, k0 + 8)
            terms = [(a_big, b_big)]
            if three:
                terms = [(a_small, b_big), (a_big, b_small)] + terms
            for x, y in terms:
                acc = _rz(acc.astype(np.float64) + x[:, ks].astype(np.float64)
                          @ y[ks].astype(np.float64))
        parts.append(acc)
    return parts


def _attention_3xtf32(q, k, v, scale, bk, pv_three=True):
    """The kernel's online softmax over key tiles of ``bk``, on one head."""
    # the scores of every key at once (they do not depend on the softmax
    # state), the chunks added to the fp32 total with rounded adds
    s = _mma_chunks(q, k.T)
    x = s[0]
    for part in s[1:]:
        x = (x + part).astype(np.float32)
    x = (x * np.float32(scale * LOG2E)).astype(np.float32)
    m = np.full(q.shape[0], -1e30, np.float32)
    l = np.zeros(q.shape[0], np.float32)
    o = np.zeros((q.shape[0], v.shape[1]), np.float32)
    for k0 in range(0, k.shape[0], bk):
        xt = x[:, k0:k0 + bk]
        m_new = np.maximum(m, xt.max(axis=1))
        alpha = np.exp2(m - m_new).astype(np.float32)
        p = np.exp2(xt - m_new[:, None]).astype(np.float32)
        l = (l * alpha + p.sum(axis=1, dtype=np.float32)).astype(np.float32)
        m = m_new
        # O = alpha * O + P.V: the first chunk in one fused multiply-add
        first, *rest = _mma_chunks(p, v[k0:k0 + bk], three=pv_three)
        o = _rn(o.astype(np.float64) * alpha[:, None] + first)
        for part in rest:
            o = (o + part).astype(np.float32)
    return o / l[:, None]


def _oracle(q, k, v, scale):
    s = (q.astype(np.float64) @ k.T.astype(np.float64)) * scale
    p = np.exp(s - s.max(axis=1, keepdims=True))
    return (p / p.sum(axis=1, keepdims=True)) @ v.astype(np.float64)


def _inputs(rows, skv, d, seed=0):
    """Scores of unit spread after the scale, as at the model's init."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, d)).astype(np.float32),
            rng.standard_normal((skv, d)).astype(np.float32),
            rng.standard_normal((skv, d)).astype(np.float32))


def _passes(out, gold):
    """``chip_smoke.py``'s criterion: |a - b| <= atol * max(1, max|b|) + rtol * |b|."""
    scale = max(1.0, np.abs(gold).max())
    return bool(np.all(np.abs(out - gold) <= F32["atol"] * scale + F32["rtol"] * np.abs(gold)))


@pytest.mark.parametrize("skv", [77, 4096])
@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_three_tf32_attention_meets_the_fp32_tolerance(d, skv):
    q, k, v = _inputs(16, skv, d, seed=d + skv)
    bk = 64 if d <= 96 else 32  # the kernel's key tile for this head dim
    out = _attention_3xtf32(q, k, v, d ** -0.5, bk)
    gold = _oracle(q, k, v, d ** -0.5)
    assert out.dtype == np.float32
    assert _passes(out, gold), np.abs(out - gold).max()


def test_one_tf32_product_for_pv_misses_the_fp32_tolerance():
    q, k, v = _inputs(16, 77, 64, seed=1)
    gold = _oracle(q, k, v, 0.125)
    assert _passes(_attention_3xtf32(q, k, v, 0.125, 64), gold)
    assert not _passes(_attention_3xtf32(q, k, v, 0.125, 64, pv_three=False), gold)


def test_p_from_the_score_fragment_feeds_pv_in_key_order_2t_2t1():
    """Per lane 4g + t of one m16n8k8 step: the C fragment of S (c0 = S[g][2t],
    c1 = S[g][2t+1], c2 = S[g+8][2t], c3 = S[g+8][2t+1]) read as the A fragment
    a0 = c0, a1 = c2, a2 = c1, a3 = c3 (A[g][t], A[g+8][t], A[g][t+4],
    A[g+8][t+4]), and V read as b0 = V[2t][g], b1 = V[2t+1][g] (B[t][g],
    B[t+4][g]), multiply to exactly P.V.  Integer data: every sum is exact."""
    rng = np.random.default_rng(2)
    p = rng.integers(-8, 9, (16, 8)).astype(np.float64)
    v = rng.integers(-8, 9, (8, 8)).astype(np.float64)
    a = np.full((16, 8), np.nan)
    b = np.full((8, 8), np.nan)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        c = (p[g, 2 * t], p[g, 2 * t + 1], p[g + 8, 2 * t], p[g + 8, 2 * t + 1])
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = c[0], c[2], c[1], c[3]
        b[t, g], b[t + 4, g] = v[2 * t, g], v[2 * t + 1, g]
    assert not np.isnan(a).any() and not np.isnan(b).any()  # every element placed once
    assert np.array_equal(a @ b, p @ v)
    # the reordering is one permutation of the keys, the same for P and V
    perm = [0, 2, 4, 6, 1, 3, 5, 7]
    assert np.array_equal(a, p[:, perm]) and np.array_equal(b, v[perm])
