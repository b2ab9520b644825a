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
stats, 2e-2 in bf16.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.conv2d import ref as t_conv_ref
from repro_torch.kernels.flash_attention import ref as t_fa_ref
from repro_torch.kernels.groupnorm_silu import ref as t_gn_ref

F32 = dict(rtol=2e-5, atol=2e-5)
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
