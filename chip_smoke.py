"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

Usage, from the root of a checkout:  python3 chip_smoke.py

Two paths, each at full published width with random weights from a seed:
Stable Diffusion text-to-image (2 requests, 512x512, 50 DDIM steps; three
kernels) and Make-A-Video text-to-video (2 requests, 16 frames of
64x64x4, 50 DDIM steps = 25 keyframe + 25 temporal; all five kernels).
Phases 3-7 run for Stable Diffusion, then for Make-A-Video; each passes or
raises, and nothing is caught:

  1. device   -- the card's name, count and power limit; capability (9, 0)
  2. build    -- compile the hand-written CUDA kernels from csrc/ (nvcc)
  3. record   -- full-width weights from a seed; one generate pass with one
                 step per denoise stage records every distinct call each
                 kernel wrapper gets on the path, by stage
  4. kernels  -- each recorded call replayed: the CUDA kernel against its
                 plain PyTorch version on the same inputs, in fp32 and bf16,
                 timed beside the plain version, one library call and the
                 card's bound; weighted by its stage's steps
  5. unet     -- one full-width UNet (VideoUNet) step on the kernel tier
                 against the torch tier, same weights and latent
  6. main     -- the path: ``workload_for(cfg)``, 2 requests through
                 ``prepare_request`` and ``generate``, with every kernel's
                 launch count set to 0 just before and read just after; the
                 counts must equal the recorded plan
  7. small    -- the reduced config's generate on the card against the CPU
                 plain path

It prints a ``{"kernels": [...]}`` line (each kernel's launches and times
summed over both paths' main runs), the card's name and power limit, and,
last, ``{"ok": true, "device": {...}}``.  Per-call details go to
``build/chip_smoke/``.  Without a CUDA device it exits non-zero and prints
no result.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"
SEED = 0

# Published H100 SXM peaks (NVIDIA data sheet): fp32 on the CUDA cores, TF32
# on the tensor cores (dense), HBM3 bandwidth.  Each kernel's bound takes the
# peak of the math it runs: conv2d runs on the tensor cores, as 3xTF32 (three
# TF32 MMAs per fp32-accurate product) for fp32 inputs and two per product for
# bf16 (its producer output is split, its weight is exact in TF32); the other
# kernels compute in fp32 on the CUDA cores.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
F32 = dict(rtol=2e-5, atol=2e-5)  # the repo's kernel tolerance (tests/test_kernels.py)
TEMPORAL_F32 = dict(rtol=3e-5, atol=3e-5)  # the repo's temporal attention tolerance
STATS = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
SOURCES = {
    "conv2d": ("src/repro_torch/kernels/csrc/conv2d.cu",
               "src/repro/kernels/conv2d/conv2d.py:184"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/flash_attention.py:118"),
    "groupnorm_silu": ("src/repro_torch/kernels/csrc/groupnorm_silu.cu",
                       "src/repro/kernels/groupnorm_silu/groupnorm_silu.py:84"),
    "temporal_flash_attention": ("src/repro_torch/kernels/csrc/temporal_attention.cu",
                                 "src/repro/kernels/flash_attention/flash_attention.py:213"),
    "temporal_conv1d": ("src/repro_torch/kernels/csrc/temporal_conv1d.cu",
                        "src/repro/kernels/conv2d/conv2d.py:314"),
}


def log(*a):
    print(*a, flush=True)


class phase:
    """Logs the wall time of a block: ``with phase("sd", "kernels"): ...``."""

    def __init__(self, path: str, name: str):
        self.label = f"{path} {name}"

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"[phase] {self.label}: {time.perf_counter() - self.t0:.1f} s")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, min_total_ms: float = 40.0, max_reps: int = 50) -> float:
    """Mean device time of ``fn`` over a run of launches (CUDA events)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = max(3, min(max_reps, int(min_total_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def assert_close(name, a, b, tol):
    """|a - b| <= atol * max(1, max|b|) + rtol * |b|: the absolute part is
    relative to the output's scale, because summation-order error follows
    the magnitude of the summed terms, not of each (possibly cancelled) sum."""
    a, b = a.float(), b.float()
    scale = max(1.0, b.abs().max().item())
    bad = (a - b).abs() > tol["atol"] * scale + tol["rtol"] * b.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} of {b.numel()} elements off by "
                             f"more than {tol}; max abs err {max_err(a, b):.3e}")


# ---------------------------------------------------------------------------
# Phase 3: recording the kernel calls of the main path
# ---------------------------------------------------------------------------


def _sig(v):
    if isinstance(v, torch.Tensor):
        return ("T", tuple(v.shape), str(v.dtype), v.stride())
    return v


class Recorder:
    """Wraps the kernel wrappers; keeps the first call of each distinct
    signature (inputs cloned) and how often each stage made it."""

    def __init__(self):
        self.calls: dict = {}
        self.stage = None

    def wrap(self, name, fn):
        def recorded(*args, **kw):
            key = (name, tuple(map(_sig, args)), tuple((k, _sig(v)) for k, v in sorted(kw.items())))
            if key not in self.calls:
                clone = lambda v: v.clone() if isinstance(v, torch.Tensor) else v  # noqa: E731
                self.calls[key] = dict(name=name, args=[clone(a) for a in args],
                                       kw={k: clone(v) for k, v in kw.items()},
                                       counts=collections.Counter())
            self.calls[key]["counts"][self.stage] += 1
            return fn(*args, **kw)

        return recorded


def kernel_modules():
    """Each kernel wrapper's module, by the wrapper's name."""
    from repro_torch.kernels.conv2d import conv2d
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.groupnorm_silu import groupnorm_silu

    return {"conv2d": conv2d, "flash_attention": flash_attention,
            "groupnorm_silu": groupnorm_silu, "temporal_flash_attention": flash_attention,
            "temporal_conv1d": conv2d}


def record_main_path(wl, model, tokens, seed):
    rec = Recorder()
    mods = kernel_modules()
    saved = {n: getattr(m, n) for n, m in mods.items()}
    orig_run_stage = wl.run_stage

    def run_stage(params, stage, *a, **k):
        rec.stage = stage.name
        return orig_run_stage(params, stage, *a, **k)

    wl.run_stage = run_stage
    for n, m in mods.items():
        setattr(m, n, rec.wrap(n, saved[n]))
    try:
        wl.generate(model, tokens, seed, impl="auto")
        torch.cuda.synchronize()
    finally:
        for n, m in mods.items():
            setattr(m, n, saved[n])
        del wl.run_stage
    return rec


# ---------------------------------------------------------------------------
# Phase 4: each kernel against its plain version, its library call and bound
# ---------------------------------------------------------------------------


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


def conv_case(args, kw):
    from repro_torch.kernels.conv2d import conv2d as kmod
    from repro_torch.kernels.conv2d import ref

    x, w = args
    K, _, C_in, C_out = w.shape
    s = kw.get("stride", 1)
    B, H, W, _ = x.shape
    OH, OW = (H + 2 * (K // 2) - K) // s + 1, (W + 2 * (K // 2) - K) // s + 1
    flops = 2.0 * B * OH * OW * C_out * K * K * C_in
    out_bytes = B * OH * OW * C_out * x.element_size()
    nbytes = _nbytes(x, w, *kw.values()) + out_bytes + (B * 2 * C_out * 4 if kw.get(
        "emit_stats") else 0)
    w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def library():
        # cuDNN conv on the NHWC data (channels_last) + the same producer/epilogue
        xin = x
        if kw.get("gn_a") is not None:
            xin = x * kw["gn_a"][:, None, None, :] + kw["gn_b"][:, None, None, :]
            if kw.get("gn_silu", True):
                xin = torch.nn.functional.silu(xin)
        y = torch.nn.functional.conv2d(xin.permute(0, 3, 1, 2), w_cl, kw.get("bias"),
                                       stride=s, padding=K // 2).permute(0, 2, 3, 1)
        if kw.get("temb") is not None:
            y = y + kw["temb"][:, None, None, :]
        if kw.get("silu"):
            y = torch.nn.functional.silu(y)
        if kw.get("residual") is not None:
            y = y + kw["residual"]
        if kw.get("emit_stats"):
            torch.stack([y.sum((1, 2)), (y * y).sum((1, 2))], dim=1)
        return y

    R = K * K * C_in
    # summation-order error grows as sqrt(reduction length): the repo's 2e-5
    # holds for its test shapes (R <= 72); widen by sqrt(R / 64) beyond that
    widen = max(1.0, math.sqrt(R / 64))
    tol = dict(rtol=F32["rtol"] * widen, atol=F32["atol"] * widen)
    peak = PEAK_TF32_FLOPS / (3 if x.dtype == torch.float32 else 2)
    return dict(kernel=lambda: kmod.conv2d(x, w, **kw), plain=lambda: ref.conv2d_ref(x, w, **kw),
                library=library, flops=flops, bytes=nbytes, tol=tol, peak=peak,
                plan=kmod.plan(B, OH, OW, C_out, R),
                shape=f"x{tuple(x.shape)} w{tuple(w.shape)} s{s} " + " ".join(
                    k for k in ("gn_a", "temb", "silu", "residual", "emit_stats")
                    if kw.get(k) is not None and kw.get(k) is not False),
                to_bf16=lambda: conv_case([x.bfloat16(), w.bfloat16()], {
                    k: (v.bfloat16() if k == "residual" and v is not None else v)
                    for k, v in kw.items()}))


def attention_case(args, kw):
    from repro_torch.kernels.flash_attention import flash_attention as kmod
    from repro_torch.kernels.flash_attention import ref

    q, k, v = args
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    flops = 4.0 * B * H * Sq * Skv * D
    nbytes = _nbytes(q, k, v) + q.numel() * q.element_size()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return dict(
        kernel=lambda: kmod.flash_attention(q, k, v, **kw),
        plain=lambda: ref.attention_ref(q, k, v, **kw),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, scale=kw["scale"], is_causal=kw.get("causal", False)),
        flops=flops, bytes=nbytes, tol=F32,
        shape=f"q{tuple(q.shape)} kv{tuple(k.shape)}",
        to_bf16=lambda: attention_case([t.bfloat16() for t in args], kw))


def groupnorm_case(args, kw):
    from repro_torch.kernels.groupnorm_silu import groupnorm_silu as kmod
    from repro_torch.kernels.groupnorm_silu import ref

    x, scale, bias = args
    x_cf = x.transpose(1, 2).contiguous()  # channels-first copy for F.group_norm

    def library():
        y = torch.nn.functional.group_norm(x_cf, kw["groups"], scale, bias, kw.get("eps", 1e-5))
        return torch.nn.functional.silu(y) if kw.get("silu", True) else y

    return dict(
        kernel=lambda: kmod.groupnorm_silu(x, scale, bias, **kw),
        plain=lambda: ref.groupnorm_silu_ref(x, scale, bias, **kw),
        library=library, flops=8.0 * x.numel(), bytes=2 * _nbytes(x) + _nbytes(scale, bias),
        tol=F32, shape=f"x{tuple(x.shape)} groups {kw['groups']} silu {kw.get('silu', True)}",
        to_bf16=lambda: groupnorm_case([x.bfloat16(), scale, bias], kw))


def temporal_attention_case(args, kw):
    from repro_torch.kernels.flash_attention import flash_attention as kmod
    from repro_torch.kernels.flash_attention import ref

    q, k, v = args
    B, nf, HW, H, D = q.shape
    flops = 4.0 * B * HW * H * nf * nf * D
    nbytes = 4 * _nbytes(q)  # q, k, v read once, out written once

    def library():
        # the conventional path: permute to (B*HW, H, F, D), SDPA, permute back
        def perm(t):
            return t.permute(0, 2, 3, 1, 4).reshape(B * HW, H, nf, D)

        o = torch.nn.functional.scaled_dot_product_attention(perm(q), perm(k), perm(v),
                                                             scale=kw["scale"])
        return o.reshape(B, HW, H, nf, D).permute(0, 3, 1, 2, 4).contiguous()

    return dict(
        kernel=lambda: kmod.temporal_flash_attention(q, k, v, **kw),
        plain=lambda: ref.temporal_attention_ref(q, k, v, **kw),
        library=library, flops=flops, bytes=nbytes, tol=TEMPORAL_F32,
        shape=f"q{tuple(q.shape)}",
        to_bf16=lambda: temporal_attention_case([t.bfloat16() for t in args], kw))


def temporal_conv_case(args, kw):
    from repro_torch.kernels.conv2d import conv2d as kmod
    from repro_torch.kernels.conv2d import ref

    x, w, bias = args
    B, nf, N, C = x.shape
    K, _, C_out = w.shape
    pad = K // 2
    frames_read = sum(nf - abs(k - pad) for k in range(K))  # taps past the edge read zeros
    flops = 2.0 * B * N * C * C_out * frames_read
    nbytes = _nbytes(x, w, bias) + B * nf * N * C_out * x.element_size()
    w_lib, b_lib = w.permute(2, 1, 0).contiguous(), bias.to(x.dtype)  # (C_out, C, K)

    def library():
        # the conventional path: permute to (B*N, C, F), conv1d, permute back
        xl = x.permute(0, 2, 3, 1).reshape(B * N, C, nf)
        y = torch.nn.functional.conv1d(xl, w_lib, b_lib, padding=pad)
        return y.reshape(B, N, C_out, nf).permute(0, 3, 1, 2).contiguous()

    widen = max(1.0, math.sqrt(K * C / 64))  # as for conv2d: R = K * C
    return dict(
        kernel=lambda: kmod.temporal_conv1d(x, w, bias), plain=lambda: ref.temporal_conv1d_ref(
            x.reshape(B, nf, N, 1, C), w, bias).reshape(B, nf, N, C_out),
        library=library, flops=flops, bytes=nbytes,
        tol=dict(rtol=F32["rtol"] * widen, atol=F32["atol"] * widen),
        shape=f"x{tuple(x.shape)} w{tuple(w.shape)}",
        to_bf16=lambda: temporal_conv_case([x.bfloat16(), w.bfloat16(), bias], kw))


CASES = {"conv2d": conv_case, "flash_attention": attention_case,
         "groupnorm_silu": groupnorm_case, "temporal_flash_attention": temporal_attention_case,
         "temporal_conv1d": temporal_conv_case}


def _compare(name, case, out, gold, tol):
    if isinstance(gold, tuple):  # conv with stats
        assert_close(name, out[0], gold[0], tol)
        assert_close(name + " stats", out[1], gold[1], STATS)
        return max_err(out[0], gold[0])
    assert_close(name, out, gold, tol)
    return max_err(out, gold)


def check_kernels(rec, stage_steps):
    """Replay every recorded call: kernel vs plain in fp32 and bf16, and
    times weighted by the launches one main-path generate makes (each
    recorded stage ran one step; the main path runs ``stage_steps``)."""
    rows = []
    for call in rec.calls.values():
        weight = sum(n * stage_steps[st] for st, n in call["counts"].items())
        case = CASES[call["name"]](call["args"], call["kw"])
        label = f"{call['name']} {case['shape']}"
        err = _compare(label, case, case["kernel"](), case["plain"](), case["tol"])
        bf = case["to_bf16"]()
        err_bf16 = _compare(label + " bf16", bf, bf["kernel"](), bf["plain"](), BF16)
        del bf
        ms = time_ms(case["kernel"])
        plain_ms = time_ms(case["plain"])
        library_ms = time_ms(case["library"])
        ops_ms = case["flops"] / case.get("peak", PEAK_FP32_FLOPS) * 1e3
        bytes_ms = case["bytes"] / PEAK_BYTES * 1e3
        row = dict(kernel=call["name"], shape=case["shape"], stages=dict(call["counts"]),
                   launches=weight, max_abs_err=err, max_abs_err_bf16=err_bf16,
                   tol_fp32=case["tol"], ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   ops_ms=ops_ms, bytes_ms=bytes_ms, bound_ms=max(ops_ms, bytes_ms),
                   # the bound at fp32 on the CUDA cores, as every kernel had it before
                   bound_fp32_cores_ms=max(case["flops"] / PEAK_FP32_FLOPS * 1e3, bytes_ms),
                   plan=case.get("plan"))
        row["roofline_share"] = row["bound_ms"] / ms
        rows.append(row)
        log(f"  {label}: x{weight} err {err:.2e} (bf16 {err_bf16:.2e}) kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f}, library {library_ms:.4f}, bound {row['bound_ms']:.4f} "
            f"({'operations' if ops_ms >= bytes_ms else 'bytes'}), "
            f"roofline {row['roofline_share']:.3f}"
            + (f", plan (bm, bn, splits) {row['plan']}" if row["plan"] else ""))
        if row["roofline_share"] > 1:  # no card beats its bound: the bound is wrong
            raise AssertionError(f"{label}: roofline share {row['roofline_share']:.3f} > 1")
        del case
        torch.cuda.empty_cache()
    return rows


def breakdown(rows, stage_steps):
    """Kernel time over one main-path generate by kernel and stage; the same
    per step of each multi-step stage; and conv2d per step by its input's
    spatial size."""
    by_stage = collections.defaultdict(collections.Counter)
    conv_hw = collections.defaultdict(collections.Counter)
    for r in rows:
        for st, n in r["stages"].items():
            t = r["ms"] * n * stage_steps[st]
            by_stage[r["kernel"]][st] += t
            if stage_steps[st] > 1 and r["kernel"] == "conv2d":
                conv_hw[st][r["shape"].split(", ")[1]] += t / stage_steps[st]
    per_step = {st: {k: v[st] / n for k, v in by_stage.items() if st in v}
                for st, n in stage_steps.items() if n > 1}
    return dict(ms_by_kernel_and_stage={k: dict(v) for k, v in by_stage.items()},
                step_ms_by_stage_and_kernel=per_step,
                conv_step_ms_by_stage_and_input_hw={k: dict(v) for k, v in conv_hw.items()})


def summarize(paths):
    """The ``{"kernels": [...]}`` entries: launches and times summed over
    the main runs of every path."""
    out = []
    for name, (source, replaces) in SOURCES.items():
        rs = [r for p in paths.values() for r in p["rows"] if r["kernel"] == name]
        tot = lambda k: sum(r["launches"] * r[k] for r in rs)  # noqa: E731
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(p["launches"].get(name, 0) for p in paths.values()),
            max_abs_err=max(r["max_abs_err"] for r in rs),
            ms=tot("ms"), plain_ms=tot("plain_ms"), bound_ms=tot("bound_ms"),
            bound_by="operations" if tot("ops_ms") >= tot("bytes_ms") else "bytes",
            library_ms=tot("library_ms"), bound_fp32_cores_ms=tot("bound_fp32_cores_ms")))
    return out


# ---------------------------------------------------------------------------
# One path: phases 3-7
# ---------------------------------------------------------------------------


def denoiser(model, cfg):
    """The path's denoising network and the shape of its (B=2) input."""
    if hasattr(model, "vunet"):  # Make-A-Video: (B, F, H, W, C) video latents
        hw = cfg.image_size // cfg.latent_down
        return model.vunet, (2, cfg.frames, hw, hw, cfg.unet.in_channels)
    return model.unet, (2, cfg.latent_size, cfg.latent_size, cfg.unet.in_channels)


def output_shape(cfg):
    if hasattr(cfg, "frames"):
        hw = cfg.image_size // cfg.latent_down
        return (2, cfg.frames, hw, hw, cfg.unet.in_channels)
    return (2, cfg.image_size, cfg.image_size, 3)


def run_path(cfg, *, tag: str, kernels: tuple, record_steps: int, smi: str) -> dict:
    from repro_torch.kernels import build
    from repro_torch.nn import init_params
    from repro_torch.workload import reduced_workload, workload_for

    wl = workload_for(cfg)
    stage_steps = {st.name: st.steps for st in wl.cost_descriptor().stages}

    # -- 3. record ------------------------------------------------------------
    with phase(cfg.name, "init + record"):
        t0 = time.perf_counter()
        model = wl.init(SEED, "cuda")
        torch.cuda.synchronize()
        log(f"[init] full-width {cfg.name}: "
            f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params in "
            f"{time.perf_counter() - t0:.2f} s")
        rng = torch.Generator().manual_seed(SEED)
        tokens = [torch.randint(0, cfg.text.vocab, (cfg.text.max_len,), generator=rng).numpy()
                  for _ in range(2)]
        # one step per denoise stage (SD: 1; Make-A-Video: 1 keyframe + 1 temporal)
        wl_rec = workload_for(dataclasses.replace(cfg, denoise_steps=record_steps))
        rec = record_main_path(wl_rec, model, tokens, SEED)
        log(f"[record] {cfg.name}: {len(rec.calls)} distinct kernel calls in stages "
            f"{sorted({st for c in rec.calls.values() for st in c['counts']})}")

    # -- 4. kernels vs plain ----------------------------------------------------
    with phase(cfg.name, "kernels"):
        rows = check_kernels(rec, stage_steps)
        del rec
        torch.cuda.empty_cache()
        (OUT_DIR / f"kernel_calls_{cfg.name}.json").write_text(
            json.dumps(dict(device=smi, rows=rows), indent=1))

    # -- 5. one full-width UNet step, kernel tier vs torch tier --------------------
    with phase(cfg.name, "unet step"):
        net, x_shape = denoiser(model, cfg)
        g = torch.Generator(device="cuda").manual_seed(SEED)
        with torch.inference_mode():
            ctx = model.encode_text(torch.as_tensor(tokens[0], device="cuda")[None].repeat(2, 1))
            z = torch.randn(x_shape, generator=g, device="cuda")
            t = torch.tensor([999.0, 499.0], device="cuda")
            step = {}
            for impl in ("kernel", "torch"):
                step[impl] = net(z, t, ctx, impl=impl)
                step[impl + "_ms"] = time_ms(lambda: net(z, t, ctx, impl=impl),
                                             min_total_ms=0, max_reps=3)
        unet_err = max_err(step["kernel"], step["torch"])
        unet_ms = {impl: step[impl + "_ms"] for impl in ("kernel", "torch")}
        scale = step["torch"].abs().max().item()
        log(f"[unet] {cfg.name} full-width {type(net).__name__} step, input {x_shape}: kernel "
            f"tier {step['kernel_ms']:.1f} ms, torch tier {step['torch_ms']:.1f} ms; max abs "
            f"diff {unet_err:.3e} (max |out| {scale:.3e})")
        # 60+ chained layers, each agreeing to the kernel tolerances above
        if not (torch.isfinite(step["kernel"]).all() and unet_err <= 1e-3 * max(1.0, scale)):
            raise AssertionError(f"{cfg.name}: kernel tier disagrees with the torch tier: "
                                 f"{unet_err}")
        del step, ctx, z

    # -- 6. main path ---------------------------------------------------------
    with phase(cfg.name, "main"):
        reqs = [wl.prepare_request(rid, tokens[rid]) for rid in range(2)]
        stage_s = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.launches.clear()  # counts start at 0 just before the main path
        t0 = time.perf_counter()
        out = wl.generate(model, [r.tokens for r in reqs], SEED, rids=[r.rid for r in reqs],
                          on_stage=lambda name, s, b: stage_s.__setitem__(name, s))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.launches)  # read just after
        peak = torch.cuda.max_memory_allocated()
        step_ms = {st: stage_s[st] / n * 1e3 for st, n in stage_steps.items() if n > 1}
        log(f"[{tag}] {cfg.name} generate 2 x {tuple(out.shape[1:])} in {wall:.2f} s; stages "
            + ", ".join(f"{k} {v:.3f} s" for k, v in stage_s.items()) + "; "
            + ", ".join(f"{v:.1f} ms per {k} step" for k, v in step_ms.items())
            + f"; peak memory {peak / 2**30:.2f} GiB; launches {launches}")
        if tuple(out.shape) != output_shape(cfg):
            raise AssertionError(f"{cfg.name}: output shape {tuple(out.shape)}")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{cfg.name}: non-finite output")
        expected = {n: sum(r["launches"] for r in rows if r["kernel"] == n) for n in SOURCES}
        expected = {n: c for n, c in expected.items() if c}
        for name in kernels:
            if launches.get(name, 0) == 0:
                raise AssertionError(f"{name} was not launched on the {cfg.name} main path")
        if launches != expected:
            raise AssertionError(f"{cfg.name}: launches {launches} differ from the recorded "
                                 f"plan {expected}")
        split = breakdown(rows, stage_steps)
        log(f"[breakdown] {cfg.name} kernel ms per step {split['step_ms_by_stage_and_kernel']}; "
            f"conv2d by input size {split['conv_step_ms_by_stage_and_input_hw']}")
        del out

    # -- 7. small input: the card's kernel path against the CPU plain path --------
    with phase(cfg.name, "small"):
        rwl = reduced_workload(cfg)
        state = init_params(rwl.model, SEED)
        toks_small = [t[: rwl.cfg.text.max_len] % rwl.cfg.text.vocab for t in tokens]
        small = {dev: rwl.generate(rwl.load(state, dev), toks_small, SEED, device=dev)
                 for dev in ("cuda", "cpu")}
        small_err = max_err(small["cuda"].cpu(), small["cpu"])
        log(f"[small] reduced {rwl.cfg.name} generate, card vs CPU plain: max abs diff "
            f"{small_err:.3e} (max |out| {small['cpu'].abs().max().item():.3e})")
        assert_close(f"reduced {cfg.name} generate", small["cuda"].cpu(), small["cpu"],
                     dict(rtol=1e-4, atol=1e-4))

    del model
    torch.cuda.empty_cache()
    return dict(rows=rows, launches=launches, summary=dict(
        denoise_steps=cfg.denoise_steps, stage_steps=stage_steps, generate_s=wall,
        stage_s=stage_s, step_ms=step_ms, unet_tier_ms=unet_ms, peak_gib=peak / 2**30,
        unet_kernel_vs_torch_err=unet_err, small_err=small_err, launches=launches, **split))


# ---------------------------------------------------------------------------
# Main
# ---------------------------------------------------------------------------


def main() -> int:
    # -- 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    log(f"[device] {kind} x{count}, capability {cap}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    if cap != (9, 0):
        raise RuntimeError(f"needs an sm_90 (Hopper) card, got capability {cap}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.suite import MAKE_A_VIDEO, STABLE_DIFFUSION
    from repro_torch.kernels import build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    torch.backends.cudnn.allow_tf32 = False  # plain and library sides in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    log(f"[build] {len(SOURCES)} kernels in {time.perf_counter() - t0:.2f} s "
        f"({build.BUILD_ROOT / build.source_hash()})")
    (OUT_DIR / "nvcc.log").write_text(build.nvcc_log())

    # -- 3-7, per path ----------------------------------------------------------
    t_all = time.perf_counter()
    paths = {
        STABLE_DIFFUSION.name: run_path(
            STABLE_DIFFUSION, tag="main", record_steps=1, smi=smi,
            kernels=("conv2d", "flash_attention", "groupnorm_silu")),
        MAKE_A_VIDEO.name: run_path(
            MAKE_A_VIDEO, tag="main-ttv", record_steps=2, smi=smi, kernels=tuple(SOURCES)),
    }
    kernels = summarize(paths)
    summary = dict(device=smi, kind=kind, paths_s=time.perf_counter() - t_all,
                   paths={k: v["summary"] for k, v in paths.items()}, kernels=kernels)
    (OUT_DIR / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
