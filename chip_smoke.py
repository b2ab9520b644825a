"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

Usage, from the root of a checkout:  python3 chip_smoke.py

Eight paths, each at full published width with random weights from a seed,
2 requests each:

  - Stable Diffusion text-to-image (512x512, 50 DDIM steps; three kernels);
  - Make-A-Video text-to-video (16 frames of 64x64x4, 50 DDIM steps = 25
    keyframe + 25 temporal; all five kernels);
  - Imagen's pixel cascade (64 px base, 64 steps, then SR to 256 px and to
    1024 px, 20 steps each; three kernels);
  - prod-image, latent text-to-image (768x768, 50 steps; three kernels);
  - Muse, masked-transformer text-to-image (48 layers of d 2048 over 256
    image tokens, 12 unmasking steps + 1 fill pass, then a VQ-GAN decoder to
    128x128; flash attention, conv2d, GroupNorm);
  - Phenaki, masked-transformer text-to-video (20 layers of d 1536 over 11
    frames x 256 tokens, 24 unmasking steps + 1 fill pass; flash attention
    and temporal attention at F = 11);
  - LLaMA2-7B, the LM baseline in fp32 (2048-token prompts: one causal
    prefill through flash attention, then 64 greedy decode steps against a
    KV cache);
  - Parti, autoregressive text-to-image in bf16 (21.9 B parameters, 87.6 GB
    in fp32, do not fit the card): 80 causal layers of d 4096 decode 1024
    image tokens one at a time against a KV cache, then a VQ-GAN decoder to
    256x256; flash attention in the text encoder, conv2d in the decoder.

Phases 3-7 run for each path in turn, phase 8 on three of them; each passes
or raises, and nothing is caught:

  1. device   -- the card's name, count and power limit; capability (9, 0)
  2. build    -- compile the hand-written CUDA kernels from csrc/ (nvcc);
                 the SASS of the flash-attention and conv GEMM kernels
                 must hold TF32 tensor-core MMAs (cuobjdump)
  3. record   -- full-width weights from a seed; one generate pass with one
                 step per denoise stage (SR stages included), one unmasking
                 step (two backbone passes), or the first 2 steps of an
                 autoregressive decode records every distinct call each
                 kernel wrapper gets on the path, by stage; inputs over 64 MiB
                 are kept on the host
  4. kernels  -- each recorded call replayed: the CUDA kernel against its
                 plain PyTorch version on the same inputs, in fp32 and bf16,
                 timed in the recorded dtype beside the plain version, one
                 library call and the card's bound; weighted by the network
                 passes its stage makes in a generate (a parallel decode of n
                 steps makes n + 1; a decode of n tokens n).
                 A kernel has two times: ``ms``, back-to-back wrapper calls
                 (host launch cost included), and ``device_ms``, its launches
                 captured in a CUDA graph and replayed (the card's time alone)
  5. tiers    -- the kernel tier against the torch tier at full width, same
                 weights and input: one step of each denoising network
                 (UNet, VideoUNet, each SR UNet on its 6-channel [z, up]
                 input), one transformer backbone pass on two token rows
                 (all masks; half unmasked), the LM's prefill logits, or
                 Parti's text encoding, first decode step and VQ-GAN image
  6. main     -- the path: ``workload_for(cfg)``, 2 requests through
                 ``prepare_request`` and ``generate``, with every kernel's
                 launch count set to 0 just before and read just after; the
                 counts must equal the recorded plan
  6b. decode  -- the autoregressive paths: three decode steps timed, then
                 profiled (torch.profiler): the card's busy time and
                 launches per step, and the ops that take most of it
  7. small    -- the reduced config's generate, in fp32, on the card against
                 the CPU plain path; decoded tokens must be equal
  8. serve    -- the serving engine at full width, on the path's model
                 (``[serve]`` lines): Stable Diffusion through the launcher
                 ``python -m repro_torch.launch.serve`` in a subprocess (16
                 requests, cascade, poisson arrivals; its stats held to the
                 schema), then 4 prompts on the pod and cascade routes and
                 through ``generate``, held to one another; Imagen on the
                 cascade route with the SR stages on the torch tier, held to
                 ``generate`` on the same tiers; LLaMA2-7B as the paper's
                 workload (2048-token prompts, 64 new tokens): a backlog of
                 16 on the lm route, then 4 on the lm and cascade routes,
                 greedy and sampled (T = 0.8), tokens equal across routes,
                 runs and ``generate``.  Each serving run sets the launch
                 counts to 0 just before and reads them just after: each
                 stage's launches must be the recorded plan times the
                 stage's batches (none on a torch-tier stage); each request's
                 wall latency runs from the start of its arrival tick to the
                 end of the tick that returned it

Each phase logs its wall time and the peak device memory it reached.  Phase
2 logs the registers and spills of the flash-attention instances the paths
use (``[ptxas]``).  It
prints a ``{"kernels": [...]}`` line (each kernel's launches and times
summed over all paths' main runs), the card's name and power limit, and,
last, ``{"ok": true, "device": {...}}``.  Per-call details go to
``build/chip_smoke/``.  Without a CUDA device it exits non-zero and prints
no result.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"
SEED = 0

# Published H100 SXM peaks (NVIDIA data sheet): fp32 on the CUDA cores, TF32
# and bf16 on the tensor cores (dense), HBM3 bandwidth.  The GEMM-shaped
# kernels run on the tensor cores: for fp32 inputs their bound takes the rate
# of the fp32-accurate math they run, 3xTF32 (three TF32 MMAs per product:
# conv2d, the temporal conv, flash attention); for bf16 inputs the card's
# bf16 peak, though the kernels still run TF32 MMAs there (two per product
# for conv2d, 1.5 for flash attention).  GroupNorm and temporal attention
# compute in fp32 on the CUDA cores.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
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
    "temporal_conv1d": ("src/repro_torch/kernels/csrc/conv2d.cu",
                        "src/repro/kernels/conv2d/conv2d.py:314"),
}


def log(*a):
    print(*a, flush=True)


class phase:
    """Logs the wall time of a block and the peak device memory allocated in
    it: ``with phase("sd", "kernels"): ...``."""

    def __init__(self, path: str, name: str):
        self.label = f"{path} {name}"

    def __enter__(self):
        torch.cuda.reset_peak_memory_stats()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"[phase] {self.label}: {time.perf_counter() - self.t0:.1f} s, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sass_mma(lib: Path, families=("fa_kernel", "conv2d_kernel")) -> dict | None:
    """Tensor-core instructions of each kernel family in the built library:
    per family, its instances and their ``HMMA`` opcodes (e.g.
    ``HMMA.1688.F32.TF32``) in ``cuobjdump -sass``; fails if an instance has
    none.  ``conv2d_kernel`` serves both ``rt_conv2d`` and
    ``rt_temporal_conv1d``.  None where the toolkit has no cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=600).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = collections.Counter()
        elif name is not None and "HMMA" in line:
            funcs[name]["HMMA" + line.split("HMMA")[1].split()[0].rstrip(";")] += 1
    out = {}
    for fam in families:
        inst = {n: c for n, c in funcs.items() if fam in n}
        bare = [n for n, c in inst.items() if not any("TF32" in op for op in c)]
        if not inst or bare:
            raise AssertionError(f"{fam}: {len(bare)} of {len(inst)} instances without a TF32 "
                                 f"HMMA in the SASS")
        ops = collections.Counter()
        for c in inst.values():
            ops.update(c)
        out[fam] = dict(instances=len(inst), hmma_per_instance_min=min(
            sum(c.values()) for c in inst.values()), opcodes=dict(ops))
    return out


def ptxas_usage(log: str, family: str = "fa_kernel") -> dict:
    """Registers and spill-store bytes of each instance of a kernel family
    in nvcc's ``-Xptxas -v`` output, by its demangled template arguments
    (``fa_kernel<float, 128>`` -> ``"f 128"``)."""
    out, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line and family in line:
            args = line.split(family + "I", 1)[1]
            dtype = "f" if args.startswith("f") else "bf16"
            name = f"{dtype} {args.split('Li', 1)[1].split('E', 1)[0]}"
            out[name] = dict(spill_stores=0)
        elif name is not None and "spill stores" in line:
            out[name]["spill_stores"] = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif name is not None and "Used" in line and "registers" in line:
            out[name]["registers"] = int(line.split("Used")[1].split("registers")[0])
            name = None
    return out


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


def device_ms(fn, ms: float, replays: int = 3) -> float:
    """Device time of one call of ``fn`` without the host: about 5 ms of
    calls (2-50) captured in one CUDA graph, the graph replayed ``replays``
    times between CUDA events.  ``ms`` is the call's time from ``time_ms``.
    A capture that fails raises."""
    launches = max(2, min(50, int(5.0 / max(ms, 1e-3))))
    fn()  # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    out = start.elapsed_time(end) / (replays * launches)
    del graph
    return out


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| over all elements, in fp32."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


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


HOST_BYTES = 1 << 26  # recorded inputs larger than this wait on the host


def _keep(v):
    """A recorded input: a clone, on the host if it is large (Imagen's
    1024 px level records tens of GiB of inputs)."""
    if not isinstance(v, torch.Tensor):
        return v
    if v.numel() * v.element_size() > HOST_BYTES:
        return v.to("cpu", copy=True)
    return v.clone()


def _on_card(v):
    return v.to("cuda") if isinstance(v, torch.Tensor) else v


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
                self.calls[key] = dict(name=name, args=[_keep(a) for a in args],
                                       kw={k: _keep(v) for k, v in kw.items()},
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


def record_main_path(wl, model, tokens, seed, **gen_kw):
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
        wl.generate(model, tokens, seed, impl="auto", **gen_kw)
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
    bias_lib = None if kw.get("bias") is None else kw["bias"].to(x.dtype)

    def library():
        # cuDNN conv on the NHWC data (channels_last) + the same producer/epilogue
        xin = x
        if kw.get("gn_a") is not None:
            xin = x * kw["gn_a"][:, None, None, :] + kw["gn_b"][:, None, None, :]
            if kw.get("gn_silu", True):
                xin = torch.nn.functional.silu(xin)
            xin = xin.to(x.dtype)
        y = torch.nn.functional.conv2d(xin.permute(0, 3, 1, 2), w_cl, bias_lib,
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
    peak = PEAK_TF32_FLOPS / 3 if x.dtype == torch.float32 else PEAK_BF16_FLOPS
    return dict(kernel=lambda: kmod.conv2d(x, w, **kw), plain=lambda: ref.conv2d_ref(x, w, **kw),
                library=library, flops=flops, bytes=nbytes, tol=tol, peak=peak, dtype=x.dtype,
                plan=dict(zip(("bm", "bn", "splits"), kmod.plan(B, OH, OW, C_out, R))),
                shape=f"x{tuple(x.shape)} w{tuple(w.shape)} s{s} " + " ".join(
                    k for k in ("gn_a", "temb", "silu", "residual", "emit_stats")
                    if kw.get(k) is not None and kw.get(k) is not False),
                as_dtype=lambda dt: conv_case([x.to(dt), w.to(dt)], {
                    k: (v.to(dt) if k == "residual" and v is not None else v)
                    for k, v in kw.items()}))


def attention_case(args, kw):
    from repro_torch.kernels.flash_attention import flash_attention as kmod
    from repro_torch.kernels.flash_attention import ref

    q, k, v = args
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    causal, window, offset = kw.get("causal", False), kw.get("window"), kw.get("kv_offset", 0)
    # the (query, key) pairs the masks keep, the work this call's data needs:
    # row i sees keys [lo, hi) around its position i + kv_offset
    rows = torch.arange(Sq) + offset
    hi = (rows + 1).clamp(max=Skv) if causal else torch.full_like(rows, Skv)
    lo = (rows - window + 1).clamp(min=0) if window is not None else torch.zeros_like(rows)
    flops = 4.0 * B * H * D * int((hi - lo).clamp(min=0).sum())
    nbytes = _nbytes(q, k, v) + q.numel() * q.element_size()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if KVH != H:
        kt, vt = (t.repeat_interleave(H // KVH, dim=1) for t in (kt, vt))
    # SDPA's is_causal aligns the diagonal at the top left: other masks go in
    # as a boolean mask
    top_left = causal and window is None and offset == 0 and Sq == Skv
    plain_mask = (causal or window is not None) and not top_left

    def library():
        mask = None
        if plain_mask:
            cols = torch.arange(Skv, device=q.device)[None, :]
            mask = (cols >= lo.to(q.device)[:, None]) & (cols < hi.to(q.device)[:, None])
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, scale=kw["scale"], is_causal=top_left, attn_mask=mask)

    return dict(
        kernel=lambda: kmod.flash_attention(q, k, v, **kw),
        plain=lambda: ref.attention_ref(q, k, v, **kw),
        library=library,
        flops=flops, bytes=nbytes, tol=F32, dtype=q.dtype,
        peak=PEAK_TF32_FLOPS / 3 if q.dtype == torch.float32 else PEAK_BF16_FLOPS,
        shape=f"q{tuple(q.shape)} kv{tuple(k.shape)}" + (" causal" if kw.get("causal") else ""),
        as_dtype=lambda dt: attention_case([t.to(dt) for t in args], kw))


def groupnorm_case(args, kw):
    from repro_torch.kernels.groupnorm_silu import groupnorm_silu as kmod
    from repro_torch.kernels.groupnorm_silu import ref

    x, scale, bias = args
    x_cf = x.transpose(1, 2).contiguous()  # channels-first copy for F.group_norm
    plan = kmod.plan(*x.shape, kw["groups"], x.element_size())

    def library():
        y = torch.nn.functional.group_norm(x_cf, kw["groups"], scale, bias, kw.get("eps", 1e-5))
        return torch.nn.functional.silu(y) if kw.get("silu", True) else y

    return dict(
        kernel=lambda: kmod.groupnorm_silu(x, scale, bias, **kw),
        plain=lambda: ref.groupnorm_silu_ref(x, scale, bias, **kw),
        library=library, flops=8.0 * x.numel(), bytes=2 * _nbytes(x) + _nbytes(scale, bias),
        tol=F32, plan=plan._asdict(), dtype=x.dtype,
        shape=f"x{tuple(x.shape)} groups {kw['groups']} silu {kw.get('silu', True)}",
        as_dtype=lambda dt: groupnorm_case([x.to(dt), scale.to(dt), bias.to(dt)], kw))


def temporal_attention_case(args, kw):
    from repro_torch.kernels.flash_attention import flash_attention as kmod
    from repro_torch.kernels.flash_attention import ref

    q, k, v = args
    B, nf, HW, H, D = q.shape
    flops = 4.0 * B * HW * H * nf * nf * D
    plan = kmod.temporal_plan(B, nf, HW, H, D, q.element_size())
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
        library=library, flops=flops, bytes=nbytes, tol=TEMPORAL_F32, plan=plan._asdict(),
        shape=f"q{tuple(q.shape)}", dtype=q.dtype,
        as_dtype=lambda dt: temporal_attention_case([t.to(dt) for t in args], kw))


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
        peak=PEAK_TF32_FLOPS / 3 if x.dtype == torch.float32 else PEAK_BF16_FLOPS,
        plan=dict(zip(("bm", "bn", "splits"), kmod.plan(B, nf, N, C_out, K * C))),
        shape=f"x{tuple(x.shape)} w{tuple(w.shape)}", dtype=x.dtype,
        as_dtype=lambda dt: temporal_conv_case([x.to(dt), w.to(dt), bias], kw))


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


def check_kernels(rec, passes, rec_passes):
    """Replay every recorded call: kernel vs plain in fp32 and bf16, and
    times weighted by the launches one main-path generate makes: a call
    recorded n times in a stage that made ``rec_passes`` network passes
    launches n * ``passes`` / ``rec_passes`` times in the main path."""
    rows = []
    for call in rec.calls.values():
        by_stage = {}
        for st, n in call["counts"].items():
            if n * passes[st] % rec_passes[st]:
                raise AssertionError(f"{call['name']}: {n} calls in {rec_passes[st]} recorded "
                                     f"passes of {st}")
            by_stage[st] = n * passes[st] // rec_passes[st]
        weight = sum(by_stage.values())
        case = CASES[call["name"]]([_on_card(a) for a in call["args"]],
                                   {k: _on_card(v) for k, v in call["kw"].items()})
        label = f"{call['name']} {case['shape']} {str(case['dtype']).split('.')[-1]}"
        errs = {}
        for dt in (torch.float32, torch.bfloat16):  # the recorded dtype and the other
            c = case if case["dtype"] == dt else case["as_dtype"](dt)
            errs[dt] = _compare(f"{label} as {str(dt).split('.')[-1]}", c, c["kernel"](),
                                c["plain"](), case["tol"] if dt == torch.float32 else BF16)
            del c
        err, err_bf16 = errs[torch.float32], errs[torch.bfloat16]
        ms = time_ms(case["kernel"])
        dev_ms = device_ms(case["kernel"], ms)
        plain_ms = time_ms(case["plain"])
        library_ms = time_ms(case["library"])
        ops_ms = case["flops"] / case.get("peak", PEAK_FP32_FLOPS) * 1e3
        bytes_ms = case["bytes"] / PEAK_BYTES * 1e3
        row = dict(kernel=call["name"], shape=case["shape"], launches_by_stage=by_stage,
                   launches=weight, max_abs_err=err, max_abs_err_bf16=err_bf16,
                   tol_fp32=case["tol"], ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                   library_ms=library_ms,
                   ops_ms=ops_ms, bytes_ms=bytes_ms, bound_ms=max(ops_ms, bytes_ms),
                   # the bound at fp32 on the CUDA cores, as every kernel had it before
                   bound_fp32_cores_ms=max(case["flops"] / PEAK_FP32_FLOPS * 1e3, bytes_ms),
                   plan=case.get("plan"))
        row["roofline_share"] = row["bound_ms"] / ms
        row["device_roofline_share"] = row["bound_ms"] / dev_ms
        rows.append(row)
        log(f"  {label}: x{weight} err {err:.2e} (bf16 {err_bf16:.2e}) kernel {ms:.4f} ms "
            f"(device {dev_ms:.4f}), plain {plain_ms:.4f}, library {library_ms:.4f}, bound "
            f"{row['bound_ms']:.4f} ({'operations' if ops_ms >= bytes_ms else 'bytes'}), "
            f"roofline {row['roofline_share']:.3f} (device {row['device_roofline_share']:.3f})"
            + (f", plan {row['plan']}" if row["plan"] else ""))
        # no card beats its bound: a share above 1 means the bound is wrong
        for key in ("roofline_share", "device_roofline_share"):
            if row[key] > 1:
                raise AssertionError(f"{label}: {key} {row[key]:.3f} > 1")
        del case
        torch.cuda.empty_cache()
    return rows


def breakdown(rows, passes):
    """Kernel time over one main-path generate by kernel and stage; the same
    per network pass (step) of each multi-pass stage; and conv2d per step by
    its input's spatial size."""
    by_stage = collections.defaultdict(collections.Counter)
    conv_hw = collections.defaultdict(collections.Counter)
    for r in rows:
        for st, n in r["launches_by_stage"].items():
            t = r["ms"] * n
            by_stage[r["kernel"]][st] += t
            if passes[st] > 1 and r["kernel"] == "conv2d":
                conv_hw[st][r["shape"].split(", ")[1]] += t / passes[st]
    per_step = {st: {k: v[st] / n for k, v in by_stage.items() if st in v}
                for st, n in passes.items() if n > 1}
    return dict(ms_by_kernel_and_stage={k: dict(v) for k, v in by_stage.items()},
                step_ms_by_stage_and_kernel=per_step,
                conv_step_ms_by_stage_and_input_hw={k: dict(v) for k, v in conv_hw.items()})


def summarize(paths):
    """The ``{"kernels": [...]}`` entries: launches and times summed over
    the main runs of the given paths, for each kernel they launch."""
    out = []
    for name, (source, replaces) in SOURCES.items():
        rs = [r for p in paths.values() for r in p["rows"] if r["kernel"] == name]
        if not rs:
            continue
        tot = lambda k: sum(r["launches"] * r[k] for r in rs)  # noqa: E731
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(p["launches"].get(name, 0) for p in paths.values()),
            max_abs_err=max(r["max_abs_err"] for r in rs),
            ms=tot("ms"), device_ms=tot("device_ms"), plain_ms=tot("plain_ms"),
            bound_ms=tot("bound_ms"),
            bound_by="operations" if tot("ops_ms") >= tot("bytes_ms") else "bytes",
            library_ms=tot("library_ms"), bound_fp32_cores_ms=tot("bound_fp32_cores_ms")))
    return out


# ---------------------------------------------------------------------------
# One path: phases 3-7
# ---------------------------------------------------------------------------


def stage_passes(wl, gen_kw: dict) -> dict:
    """Network passes of each stage in one generate: a denoise stage's
    steps; a parallel decode's steps + 1 (the loop, then the fill pass); an
    LM decode's ``max_new_tokens`` (``gen_kw``, else the stage's steps)."""
    out = {st.name: st.steps + (st.name == "parallel_decode")
           for st in wl.cost_descriptor().stages}
    if "max_new_tokens" in gen_kw:
        out["decode"] = gen_kw["max_new_tokens"]
    return out


def _fp32(module):
    """An fp32 copy of a (bf16) module, run on the torch tier: the exact
    computation a bf16 tier is held to."""
    return copy.deepcopy(module).float()


def parti_fp32_first_step(model, prompts):
    """Parti's first decode step (BOS 0 at position 0) in fp32 from the same
    bf16 weights, as ``ar_step``: the text encoder, then each block copied to
    fp32 one at a time (the whole model in fp32 would not fit the card)."""
    ctx = _fp32(model.ctx_proj)(_fp32(model.text)(prompts, impl="torch"))
    x = (model.embed.table[0].float() + model.pos[0].float()).expand(2, 1, -1)
    for block in model.blocks():
        b = _fp32(block)
        cache = b.attn.init_cache(2, 1, dtype=torch.float32)
        x, _ = b.decode(x, {"attn": cache}, 0, cross_cache=b.cross_attn.project_kv(ctx))
        del b
    return _fp32(model.head)(_fp32(model.final_ln)(x))[:, 0]


def tier_checks(model, cfg, tokens) -> list:
    """``(name, description, f(impl), f32)`` of each full-width network call
    that phase 5 runs on both tiers: one step of every denoising network (the
    base UNet or VideoUNet, then each SR UNet on its ``[z, up]`` input), one
    transformer backbone pass over two token rows, all masks (the first
    step) and half of the positions unmasked from a seeded draw, the LM's
    prefill logits, or Parti's text encoding, first decode step and VQ-GAN
    image.  ``f32`` computes a bf16 model's output in fp32 from the same
    weights (None for an fp32 model)."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    prompts = torch.as_tensor(np.stack(tokens), device="cuda")
    if is_lm(cfg):  # the prefill's last-position logits
        return [("prefill", f"prefill logits over tokens {tuple(prompts.shape)}",
                 lambda impl: model.prefill(prompts, impl=impl)[0], None)]
    if getattr(cfg, "decode", None) == "ar":  # Parti: text, first decode step, image
        def first_step(impl):
            caches, cross = model.ar_init(model.encode_text(prompts, impl=impl))
            return model.ar_step(torch.zeros((2, 1), dtype=torch.int64, device="cuda"), 0,
                                 caches, cross)

        img = torch.randint(0, cfg.vq.codebook_size, (2, cfg.image_tokens), generator=g,
                            device="cuda")
        return [("text", f"text encoding of prompts {tuple(prompts.shape)}",
                 lambda impl: model.encode_text(prompts, impl=impl),
                 lambda: _fp32(model.ctx_proj)(_fp32(model.text)(prompts, impl="torch"))),
                ("decode_step", "first decode step's logits from each tier's text encoding",
                 first_step, lambda: parti_fp32_first_step(model, prompts)),
                ("vq", f"VQ-GAN image of tokens {tuple(img.shape)}",
                 lambda impl: model.vq(img, impl=impl),
                 lambda: _fp32(model.vq)(img, impl="torch"))]
    ctx = model.encode_text(torch.as_tensor(tokens[0], device="cuda")[None].repeat(2, 1))
    if hasattr(model, "backbone"):  # Muse, Phenaki: logits of one pass
        S, mask = model.pos.shape[0], model.mask_token
        drawn = torch.randint(0, mask, (S,), generator=g, device="cuda")
        half = torch.where(torch.rand(S, generator=g, device="cuda") < 0.5, drawn, mask)
        toks = torch.stack([torch.full_like(half, mask), half])
        return [("backbone", f"backbone pass over tokens {tuple(toks.shape)}",
                 lambda impl: model.backbone(toks, ctx, impl=impl), None)]
    if hasattr(model, "vunet"):  # Make-A-Video: (B, F, H, W, C) video latents
        hw = cfg.image_size // cfg.latent_down
        nets = [("vunet", model.vunet, (2, cfg.frames, hw, hw, cfg.unet.in_channels))]
    else:
        nets = [("unet", model.unet, (2, cfg.latent_size, cfg.latent_size,
                                      cfg.unet.in_channels))] + [
            (f"sr{i}", unet, (2, s.out_size, s.out_size, s.unet.in_channels))
            for i, (s, unet) in enumerate(zip(cfg.sr_stages, model.sr_unets))]
    t = torch.tensor([999.0, 499.0], device="cuda")
    checks = []
    for name, net, shape in nets:
        z = torch.randn(shape, generator=g, device="cuda")
        checks.append((name, f"{type(net).__name__} step, input {shape}",
                       lambda impl, net=net, z=z: net(z, t, ctx, impl=impl), None))
    return checks


def is_lm(cfg) -> bool:
    from repro_torch.configs.base import LMConfig

    return isinstance(cfg, LMConfig)


def decode_profile(model, cfg, tokens, steps: int = 3) -> dict:
    """Where a decode step's time goes, for the autoregressive paths: the
    wall time of ``steps`` steps (LLaMA at the prompt's end, Parti at image
    token 512, half its decode), then the same steps under
    ``torch.profiler``: the card's busy time per step (the sum of its kernels
    and copies), the launches per step and the ops that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    prompts = torch.as_tensor(np.stack(tokens), device="cuda")
    if is_lm(cfg):
        S = prompts.shape[1]
        _, caches = model.prefill(prompts, max_len=S + steps + 1)
        tok = prompts[:, -1:]

        def step(i):
            return model.decode_step(tok, caches, S + i)
    else:
        caches, cross = model.ar_init(model.encode_text(prompts))
        prev = torch.zeros((2, 1), dtype=torch.int64, device="cuda")

        def step(i):
            return model.ar_step(prev, cfg.image_tokens // 2 + i, caches, cross)

    step(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        step(i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
    on_card = [e for e in prof.events() if e.device_type.name == "CUDA"]
    us = [getattr(e, "device_time_total", None) or e.cuda_time_total for e in on_card]
    busy_ms = sum(us) / steps / 1e3
    by_name = collections.Counter()
    for e, t in zip(on_card, us):
        by_name[e.name[:60]] += t / steps / 1e3
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
                launches_per_step=len(on_card) / steps,
                top_ms={k: v for k, v in by_name.most_common(6)})


def output_shape(cfg):
    if is_lm(cfg):  # the new tokens
        from repro_torch.workload.lm import TRACE_DECODE

        return (2, TRACE_DECODE)
    if hasattr(cfg, "vq"):  # Muse, Parti: the VQ-GAN decoder's image
        hw = cfg.vq.token_hw * 2 ** (len(cfg.vq.decoder.channel_mult) - 1)
        return (2, hw, hw, 3)
    if hasattr(cfg, "tokens_per_frame"):  # Phenaki: the video tokens
        return (2, cfg.frames * cfg.tokens_per_frame)
    if hasattr(cfg, "frames"):
        hw = cfg.image_size // cfg.latent_down
        return (2, cfg.frames, hw, hw, cfg.unet.in_channels)
    size = cfg.sr_stages[-1].out_size if cfg.sr_stages else cfg.image_size
    return (2, size, size, 3)


def record_config(cfg, record_steps: int):
    """(config, generate kwargs) of the recording run: ``record_steps``
    denoise steps and one step per SR stage (one step of every stage's
    network), one unmasking step, or the first 2 tokens of an
    autoregressive decode (the rest of Parti's image tokens stay 0)."""
    if is_lm(cfg):
        return cfg, {"max_new_tokens": 2}
    if getattr(cfg, "decode", None) == "ar":
        return dataclasses.replace(cfg, image_tokens=2), {}
    if hasattr(cfg, "parallel_steps"):
        return dataclasses.replace(cfg, parallel_steps=1), {}
    cfg = dataclasses.replace(cfg, denoise_steps=record_steps)
    if getattr(cfg, "sr_stages", ()):
        cfg = dataclasses.replace(cfg, sr_stages=tuple(
            dataclasses.replace(s, steps=1) for s in cfg.sr_stages))
    return cfg, {}


def generate_states(wl, model, tokens, device):
    """``wl.generate`` on ``device``, with each stage's output state kept."""
    states, run = {}, wl.run_stage

    def run_stage(params, stage, *a, **k):
        states[stage.name] = run(params, stage, *a, **k)
        return states[stage.name]

    wl.run_stage = run_stage
    try:
        out = wl.generate(model, tokens, SEED, device=device)
    finally:
        del wl.run_stage
    return out, states


# ---------------------------------------------------------------------------
# Phase 8: serving through the engine (Stable Diffusion, Imagen, LLaMA2-7B)
# ---------------------------------------------------------------------------

# Routes compute one function, in batches of other sizes: on the card
# conv2d's split-K plan follows the grid, so a pod of 4 and a stage batch of
# 2 sum in other orders, through 50 DDIM steps and the VAE.
SERVE_TOL = dict(rtol=1e-3, atol=1e-3)
SERVE_WIDTH = 32  # the engine's first bucket: every prompt is padded to it
SD_LAUNCHER_REQUESTS = 16
# LLaMA served as the paper's workload: 2048-token prompts (one bucket) and
# 64 new tokens; a backlog of 16 for the rate and the latency percentiles,
# 4 of them (one batch) for the route, sampling and generate checks
LM_PROMPT, LM_NEW, LM_REQUESTS, LM_CHECKED = 2048, 64, 16, 4


class StageLaunches:
    """Each kernel's launches by stage while installed on ``wl.run_stage``
    (the counts are the wrappers', read before and after each stage)."""

    def __init__(self, wl):
        self.wl = wl
        self.by_stage = collections.defaultdict(collections.Counter)

    def __enter__(self):
        from repro_torch.kernels import build

        run = self.wl.run_stage

        def counted(params, stage, *a, **k):
            before = collections.Counter(build.launches)
            out = run(params, stage, *a, **k)
            after = collections.Counter(build.launches)
            after.subtract(before)
            self.by_stage[stage.name].update(+after)
            return out

        self.wl.run_stage = counted
        return self

    def __exit__(self, *exc):
        del self.wl.run_stage


def stage_plan(rows) -> dict:
    """Each stage's launches of each kernel in one main-path generate (the
    recorded plan; a stage's launches do not depend on its batch)."""
    plan = collections.defaultdict(collections.Counter)
    for r in rows:
        for st, n in r["launches_by_stage"].items():
            plan[st][r["kernel"]] += n
    return plan


def serve(tag, wl, model, prompts, rows, *, arrivals=None, max_new=0, **cfg_kw) -> dict:
    """``prompts`` through a ``ServeEngine`` on the card: every count set to
    0 just before, read just after; the stats checked against the schema;
    each stage's launches equal to the plan times the stage's batches (none
    on a stage of the torch tier), and each kernel of the kernel tier
    launched.  Returns the results and the numbers of the ``[serve]``
    line."""
    from repro_torch.kernels import build
    from repro_torch.kernels.tiers import resolve_model_impl
    from repro_torch.serving import ServeConfig, ServeEngine
    from repro_torch.telemetry import validate_engine_stats
    from repro_torch.workload.base import resolve_stage_impls

    eng = ServeEngine(wl, model, ServeConfig(**cfg_kw))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with StageLaunches(wl) as counted:
        build.launches.clear()  # counts start at 0 just before the serving run
        t0 = time.perf_counter()
        arrive = [0 if arrivals is None else arrivals[rid] for rid in range(len(prompts))]
        for rid, prompt in enumerate(prompts):
            eng.submit(rid, prompt, max_new, arrival_tick=arrive[rid])
        # eng.run(), one tick a step, with each request's wall latency: from
        # the start of its arrival tick to the end of the tick that returned
        # it (outputs come back on the host, so the card is done)
        results, tick_t0, lat_wall = {}, [], {}
        while eng.pending():
            tick_t0.append(time.perf_counter())
            for rid, res in eng.step():
                results[rid] = res
                lat_wall[rid] = time.perf_counter() - tick_t0[arrive[rid]]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.launches)  # read just after
    peak = torch.cuda.max_memory_allocated()
    s = eng.stats
    validate_engine_stats(s, eng.route)
    if sorted(results) != list(range(len(prompts))):
        raise AssertionError(f"{tag}: served {sorted(results)}")
    if eng.route == "cascade":
        batches = {ex.name: ex.batches for ex in eng.pipeline.executors}
        tiers = {ex.name: ex.effective_impl for ex in eng.pipeline.executors}
    else:
        batches = {n: st["dispatches"] for n, st in s["stages"].items()}
        tiers = {st.name: resolve_model_impl(im) for st, im in zip(eng.cost.stages, (
            resolve_stage_impls(eng.cost.stages, eng.serve_cfg.impl, eng.serve_cfg.stage_impl)))}
    plan = stage_plan(rows)
    for st, n in batches.items():
        want = ({k: c * n for k, c in plan[st].items()} if tiers[st] == "kernel" else {})
        if dict(counted.by_stage.get(st, {})) != want:
            raise AssertionError(f"{tag} stage {st} ({tiers[st]}, {n} batches): launches "
                                 f"{dict(counted.by_stage.get(st, {}))}, plan x batches {want}")
    for name in {k for st, t in tiers.items() if t == "kernel" for k in plan[st]}:
        if not launches.get(name):
            raise AssertionError(f"{tag}: {name} was not launched")
    lat = s["request_latency_s"]
    lw = np.array(list(lat_wall.values()))
    out = dict(route=eng.route, requests=len(results), wall_s=wall, rps=len(results) / wall,
               engine_rps=s["requests_per_s"], tick_s=s["clock"]["tick_seconds"],
               ticks=s["clock"]["ticks"], e2e_p50_s=lat["p50"], e2e_p95_s=lat["p95"],
               wall_e2e_p50_s=float(np.percentile(lw, 50)),
               wall_e2e_p95_s=float(np.percentile(lw, 95)), wall_e2e_max_s=float(lw.max()),
               peak_gib=peak / 2**30, launches=launches, batches=batches,
               stage_s={n: st["exec_s"] for n, st in s["stages"].items()})
    if eng.route == "lm":
        new_tokens = sum(len(v) for v in results.values())
        out.update(new_tokens=new_tokens, tokens_per_s=new_tokens / wall,
                   decode_ms_per_token=1e3 * s["decode_s"] / (max_new * batches["decode"]),
                   prefill_s_per_batch=s["prefill_s"] / batches["prefill"])
    if eng.route == "cascade":
        c = s["cascade"]
        out.update(stage_batches={n: st["mean_batch"] for n, st in c["stages"].items()},
                   stage_tiers=tiers,
                   queue_wait_ticks={n: (st["queue_wait_ticks"]["p50"],
                                         st["queue_wait_ticks"]["p95"])
                                     for n, st in c["stages"].items()},
                   stage_s={n: st["exec_s"] for n, st in c["stages"].items()},
                   modeled_throughput_gain=c["hbm"]["throughput_gain"])
    log(f"[serve] {tag} ({eng.route}): {len(results)} requests in {wall:.2f} s, "
        f"{out['rps']:.3f} req/s (engine clock {out['engine_rps']:.3f}); tick "
        f"{out['tick_s']:.3f} s calibrated over {out['ticks']} ticks; e2e over "
        f"{len(results)} requests, wall p50 {out['wall_e2e_p50_s']:.3f} s p95 "
        f"{out['wall_e2e_p95_s']:.3f} s max {out['wall_e2e_max_s']:.3f} s (engine clock p50 "
        f"{out['e2e_p50_s']:.3f} s p95 {out['e2e_p95_s']:.3f} s); peak {out['peak_gib']:.2f} GiB; "
        f"batches {batches}; stage s " + ", ".join(f"{n} {v:.3f}" for n, v in out["stage_s"].items())
        + f"; launches {launches}")
    if eng.route == "lm":
        log(f"[serve] {tag}: {out['new_tokens']} new tokens, {out['tokens_per_s']:.1f} tokens/s; "
            f"prefill {out['prefill_s_per_batch']:.3f} s a batch, decode "
            f"{out['decode_ms_per_token']:.2f} ms a token")
    if eng.route == "cascade":
        log(f"[serve] {tag} stages: " + "; ".join(
            f"{n} [{tiers[n]}] {batches[n]} batches, mean {out['stage_batches'][n]:.2f}, "
            f"queue wait p50/p95 {w[0]:.0f}/{w[1]:.0f} ticks, {out['stage_s'][n]:.3f} s"
            for n, w in out["queue_wait_ticks"].items())
            + f"; modeled stage-batched vs lockstep throughput {out['modeled_throughput_gain']:.3f}x")
    return dict(results=results, report=out)


def eng_device(model) -> torch.device:
    return next(model.parameters()).device


def padded(wl, prompts) -> list:
    """Prompts zero-padded as the cascade route pads them in the first
    bucket (at most the workload's prompt length): every route then encodes
    the same tokens."""
    width = min(SERVE_WIDTH, wl.max_prompt_len)
    return [np.pad(p, (0, width - len(p))) for p in prompts]


def serve_stable_diffusion(wl, model, rows) -> dict:
    """The launcher in a subprocess (16 requests, cascade, poisson arrivals),
    then 4 of its prompts on the pod and cascade routes and through
    ``generate`` with the same rids, held to one another."""
    from repro_torch.launch.serve import draw_prompts
    from repro_torch.serving import ArrivalTrace
    from repro_torch.telemetry import validate_engine_stats

    stats_rel = "build/chip_smoke/serve_stable-diffusion.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "stable-diffusion",
           "--requests", str(SD_LAUNCHER_REQUESTS), "--route", "cascade", "--arrivals", "poisson",
           "--arrival-rate", "0.5", "--stats-json", stats_rel]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    launcher_s = time.perf_counter() - t0
    (OUT_DIR / "serve_stable-diffusion.log").write_text(proc.stdout + proc.stderr)
    for line in proc.stdout.splitlines():
        log(f"[serve] launcher | {line}")
    if proc.returncode != 0:
        raise AssertionError(f"the launcher exited {proc.returncode}: {proc.stderr[-3000:]}")
    launched = json.loads((ROOT / stats_rel).read_text())
    validate_engine_stats(launched, "cascade")
    log(f"[serve] launcher: rc 0 in {launcher_s:.1f} s (process, init, build load, "
        f"{SD_LAUNCHER_REQUESTS} requests); stats valid; {launched['requests_per_s']:.3f} req/s "
        f"on its clock")

    prompts = padded(wl, draw_prompts(wl, 4, SEED))
    ticks = ArrivalTrace("poisson", rate=0.5, seed=SEED).ticks(4)
    pod = serve("stable-diffusion pod", wl, model, prompts, rows)
    cas = serve("stable-diffusion cascade", wl, model, prompts, rows, arrivals=ticks,
                route="cascade", pod_size=2)
    gen = wl.generate(model, np.stack(prompts), SEED, device=eng_device(model),
                      rids=[0, 1, 2, 3]).cpu()
    errs = {}
    for name, run in (("pod", pod), ("cascade", cas)):
        out = torch.stack([run["results"][r] for r in range(4)])
        errs[name] = max_err(out, gen)
        assert_close(f"stable-diffusion {name} route vs generate", out, gen, SERVE_TOL)
    log(f"[serve] stable-diffusion routes vs generate (2 x 4 images {tuple(gen.shape[1:])}): "
        f"max abs diff pod {errs['pod']:.3e}, cascade {errs['cascade']:.3e} (max |out| "
        f"{gen.abs().max().item():.3e}; tolerance {SERVE_TOL})")
    return dict(launcher_s=launcher_s, launcher_rps=launched["requests_per_s"],
                pod=pod["report"], cascade=cas["report"], route_max_abs_err=errs)


def serve_imagen(wl, model, rows) -> dict:
    """2 requests on the cascade route, the SR stages on the torch tier and
    the base on the kernels; pods of 1, so each stage batches its own way.
    The served images are held to ``generate`` of the same rids on the same
    tiers."""
    from repro_torch.launch.serve import draw_prompts

    prompts = padded(wl, draw_prompts(wl, 2, SEED))
    run = serve("imagen cascade sr=torch", wl, model, prompts, rows,
                route="cascade", pod_size=1, stage_impl={"sr": "torch"})
    out = torch.stack([run["results"][r] for r in range(2)])
    if tuple(out.shape[1:]) != output_shape(wl.cfg)[1:] or not torch.isfinite(out).all():
        raise AssertionError(f"imagen served {tuple(out.shape)}, finite "
                             f"{bool(torch.isfinite(out).all())}")
    gen = wl.generate(model, np.stack(prompts), SEED, device=eng_device(model), rids=[0, 1],
                      stage_impl={"sr": "torch"}).cpu()
    err = max_err(out, gen)
    log(f"[serve] imagen cascade vs generate (2 images {tuple(gen.shape[1:])}, sr=torch): max "
        f"abs diff {err:.3e} (max |out| {gen.abs().max().item():.3e}; tolerance {SERVE_TOL})")
    assert_close("imagen cascade route vs generate", out, gen, SERVE_TOL)
    return dict(cascade=run["report"], route_max_abs_err=err)


def serve_llama(wl, model, rows) -> dict:
    """The paper's LM workload served: 16 prompts of 2048 tokens, 64 new
    tokens each, on the lm route (one bucket of 2048, batches of 4), all
    queued at tick 0.  Then the first 4 (the first batch) on the cascade
    route, and at temperature 0.8 on both routes and again on the lm route:
    greedy tokens equal across routes and to ``generate``'s, sampled tokens
    equal across routes and runs and not the greedy ones."""
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, wl.prompt_vocab, size=LM_PROMPT) for _ in range(LM_REQUESTS)]
    checked = prompts[:LM_CHECKED]
    kw = dict(max_new=LM_NEW, buckets=(LM_PROMPT,))
    backlog = serve(f"llama2-7b lm T=0 backlog of {LM_REQUESTS}", wl, model, prompts, rows, **kw)
    runs = {(0.0, "cascade"): serve("llama2-7b cascade T=0", wl, model, checked, rows,
                                    route="cascade", **kw)}
    for route in ("auto", "cascade"):
        runs[0.8, route] = serve(f"llama2-7b {route} T=0.8", wl, model, checked, rows,
                                 route=route, temperature=0.8, **kw)
    again = serve("llama2-7b auto T=0.8, again", wl, model, checked, rows, temperature=0.8, **kw)

    def toks(run):
        return {r: [int(t) for t in v] for r, v in run["results"].items()}

    lm_greedy = {r: v for r, v in toks(backlog).items() if r < LM_CHECKED}
    gen = wl.generate(model, np.stack(checked), SEED, device=eng_device(model),
                      rids=list(range(LM_CHECKED)), max_new_tokens=LM_NEW).cpu()
    greedy = {r: gen[r].tolist() for r in range(LM_CHECKED)}
    sampled = toks(runs[0.8, "auto"])
    checks = {"greedy lm == generate": lm_greedy == greedy,
              "greedy cascade == generate": toks(runs[0.0, "cascade"]) == greedy,
              "T=0.8 lm == cascade": sampled == toks(runs[0.8, "cascade"]),
              "T=0.8 lm == lm again": sampled == toks(again),
              "T=0.8 != greedy": sampled != greedy,
              f"{LM_NEW} tokens each": all(len(v) == LM_NEW for v in toks(backlog).values())}
    log(f"[serve] llama2-7b tokens: " + "; ".join(f"{k}: {v}" for k, v in checks.items())
        + f"; greedy rid 0 {greedy[0][:16]}...; T=0.8 rid 0 {sampled[0][:16]}...")
    if not all(checks.values()):
        raise AssertionError(f"llama2-7b serving: {checks}")
    out = {f"lm T=0 backlog of {LM_REQUESTS}": backlog["report"]}
    out.update({f"{route} T={temp}": run["report"] for (temp, route), run in runs.items()})
    out["auto T=0.8, again"] = again["report"]
    return out


def run_path(cfg, *, tag: str, kernels: tuple, record_steps: int, smi: str,
             serve_fn=None) -> dict:
    from repro_torch.configs.suite import with_dtype
    from repro_torch.kernels import build
    from repro_torch.nn import init_params
    from repro_torch.workload import reduced_workload, workload_for

    wl = workload_for(cfg)
    passes = stage_passes(wl, {})

    # -- 3. record ------------------------------------------------------------
    with phase(cfg.name, "init + record"):
        t0 = time.perf_counter()
        model = wl.init(SEED, "cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        dtype = str(next(model.parameters()).dtype).split(".")[-1]
        log(f"[init] full-width {cfg.name}: {n_params / 1e6:.1f} M params ({dtype}) in "
            f"{init_s:.2f} s")
        rng = torch.Generator().manual_seed(SEED)
        tokens = [torch.randint(0, wl.prompt_vocab, (wl.max_prompt_len,), generator=rng).numpy()
                  for _ in range(2)]
        # one step per denoise stage (SD: 1; Make-A-Video: 1 keyframe + 1
        # temporal; Imagen: 1 base + 1 per SR stage), one unmasking step, or
        # the first 2 tokens of a decode
        rec_cfg, rec_kw = record_config(cfg, record_steps)
        wl_rec = workload_for(rec_cfg)
        rec = record_main_path(wl_rec, model, tokens, SEED, **rec_kw)
        log(f"[record] {cfg.name}: {len(rec.calls)} distinct kernel calls in stages "
            f"{sorted({st for c in rec.calls.values() for st in c['counts']})}")

    # -- 4. kernels vs plain ----------------------------------------------------
    with phase(cfg.name, "kernels"):
        rows = check_kernels(rec, passes, stage_passes(wl_rec, rec_kw))
        del rec
        torch.cuda.empty_cache()
        (OUT_DIR / f"kernel_calls_{cfg.name}.json").write_text(
            json.dumps(dict(device=smi, rows=rows), indent=1))

    # -- 5. the kernel tier against the torch tier at full width ------------------
    with phase(cfg.name, "tiers"):
        tier_ms, tier_err, tier_f32_err = {}, {}, {}
        with torch.inference_mode():
            for name, what, fn, f32 in tier_checks(model, cfg, tokens):
                out = {impl: fn(impl) for impl in ("kernel", "torch")}
                tier_ms[name] = {impl: time_ms(lambda: fn(impl), min_total_ms=0, max_reps=3)
                                 for impl in ("kernel", "torch")}
                err = tier_err[name] = max_err(out["kernel"], out["torch"])
                scale = out["torch"].abs().max().item()
                log(f"[tier] {cfg.name} full-width {name} ({what}): kernel tier "
                    f"{tier_ms[name]['kernel']:.1f} ms, torch tier {tier_ms[name]['torch']:.1f} "
                    f"ms; max abs diff {err:.3e} (max |out| {scale:.3e}), relative L2 "
                    f"{rel_l2(out['kernel'], out['torch']):.3e}")
                if f32 is None:
                    # tens of chained fp32 layers, each agreeing to the kernel
                    # tolerances above: within 1e-3 of the output's scale
                    ok = err <= 1e-3 * max(1.0, scale)
                else:
                    # a bf16 model rounds every layer's output to 8 bits, and
                    # the two tiers' roundings part ways over 100 layers: each
                    # tier is held to the fp32 computation of the same weights,
                    # and the kernel tier must be as close to it as the plain
                    # one (1.5x, or within bf16's unit 2^-8 in norm)
                    gold = f32()
                    e = {impl: rel_l2(out[impl], gold) for impl in out}
                    tier_f32_err[name] = e
                    ok = e["kernel"] <= max(1.5 * e["torch"], 2.0 ** -8)
                    log(f"[tier] {cfg.name} {name} against fp32 of the same weights, relative "
                        f"L2: kernel tier {e['kernel']:.3e}, torch tier {e['torch']:.3e}")
                    del gold
                if not (torch.isfinite(out["kernel"]).all() and ok):
                    raise AssertionError(f"{cfg.name} {name}: kernel tier disagrees with the "
                                         f"torch tier: {err}")
                del out
                torch.cuda.empty_cache()

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
        step_ms = {st: stage_s[st] / n * 1e3 for st, n in passes.items() if n > 1}
        log(f"[{tag}] {cfg.name} generate 2 x {tuple(out.shape[1:])} in {wall:.2f} s; stages "
            + ", ".join(f"{k} {v:.3f} s" for k, v in stage_s.items()) + "; "
            + ", ".join(f"{v:.1f} ms per {k} pass" for k, v in step_ms.items())
            + f"; peak memory {peak / 2**30:.2f} GiB; launches {launches}")
        if tuple(out.shape) != output_shape(cfg):
            raise AssertionError(f"{cfg.name}: output shape {tuple(out.shape)}")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{cfg.name}: non-finite output")
        limit = cfg.vocab if is_lm(cfg) else getattr(model, "mask_token", None)
        if not out.is_floating_point() and not ((out >= 0) & (out < limit)).all():
            raise AssertionError(f"{cfg.name}: tokens outside [0, {limit})")
        expected = {n: sum(r["launches"] for r in rows if r["kernel"] == n) for n in SOURCES}
        expected = {n: c for n, c in expected.items() if c}
        for name in kernels:
            if launches.get(name, 0) == 0:
                raise AssertionError(f"{name} was not launched on the {cfg.name} main path")
        if launches != expected:
            raise AssertionError(f"{cfg.name}: launches {launches} differ from the recorded "
                                 f"plan {expected}")
        split = breakdown(rows, passes)
        log(f"[breakdown] {cfg.name} kernel ms per pass {split['step_ms_by_stage_and_kernel']}; "
            f"conv2d by input size {split['conv_step_ms_by_stage_and_input_hw']}")
        per_kernel = summarize({cfg.name: dict(rows=rows, launches=launches)})
        log(f"[kernels] {cfg.name} over one generate (ms): " + "; ".join(
            f"{k['name']} x{k['launches']}: wall {k['ms']:.2f}, device {k['device_ms']:.2f}, "
            f"bound {k['bound_ms']:.2f}, library {k['library_ms']:.2f}, plain {k['plain_ms']:.2f}"
            for k in per_kernel))
        del out

    # -- 6b. one decode step, profiled (the autoregressive paths) ---------------
    prof = None
    if any(st in passes for st in ("decode", "ar_decode")):
        with phase(cfg.name, "decode profile"), torch.inference_mode():
            prof = decode_profile(model, cfg, tokens)
            log(f"[decode] {cfg.name} one decode step: wall {prof['wall_ms']:.2f} ms, card busy "
                f"{prof['device_busy_ms']:.2f} ms (idle share {prof['idle_share']:.3f}), "
                f"{prof['launches_per_step']:.0f} launches; most device time (ms): "
                + "; ".join(f"{k} {v:.2f}" for k, v in prof["top_ms"].items()))

    # -- 7. small input: the card's kernel path against the CPU plain path --------
    with phase(cfg.name, "small"):
        rwl = reduced_workload(with_dtype(cfg, torch.float32))
        state = init_params(rwl.model, SEED)
        toks_small = [t[: min(rwl.max_prompt_len, 64)] % rwl.prompt_vocab for t in tokens]
        small = {dev: generate_states(rwl, rwl.load(state, dev), toks_small, dev)
                 for dev in ("cuda", "cpu")}
        (out_cuda, st_cuda), (out_cpu, st_cpu) = small["cuda"], small["cpu"]
        decoded = next((st for st in ("parallel_decode", "ar_decode", "decode") if st in st_cpu),
                       None)
        if decoded is not None:  # the decoded tokens, before any decoder
            # the LM's decode state holds its tokens under "out"; a token
            # decode stage holds only its tokens
            tok = {dev: (st[decoded]["out"] if decoded == "decode"
                         else next(iter(st[decoded].values()))).cpu()
                   for dev, st in (("cuda", st_cuda), ("cpu", st_cpu))}
            log(f"[small] reduced {rwl.cfg.name} {decoded}, card vs CPU plain: "
                f"{int((tok['cuda'] != tok['cpu']).sum())} of {tok['cpu'].numel()} tokens differ")
            if not torch.equal(tok["cuda"], tok["cpu"]):
                raise AssertionError(f"reduced {cfg.name}: tokens differ, card vs CPU")
        small_err = max_err(out_cuda.cpu(), out_cpu)
        log(f"[small] reduced {rwl.cfg.name} generate, card vs CPU plain: max abs diff "
            f"{small_err:.3e} (max |out| {out_cpu.abs().max().item():.3e})")
        assert_close(f"reduced {cfg.name} generate", out_cuda.cpu(), out_cpu,
                     dict(rtol=1e-4, atol=1e-4))

    # -- 8. serving through the engine (SD, Imagen, LLaMA) ------------------------
    served = None
    if serve_fn is not None:
        with phase(cfg.name, "serve"):
            served = serve_fn(wl, model, rows)

    del model
    torch.cuda.empty_cache()
    return dict(rows=rows, launches=launches, summary=dict(serve=served,
        params_m=n_params / 1e6, dtype=dtype, init_s=init_s,
        passes=passes, generate_s=wall, stage_s=stage_s, step_ms=step_ms, tier_ms=tier_ms,
        peak_gib=peak / 2**30, kernel_vs_torch_tier_err=tier_err,
        tier_vs_fp32_rel_l2=tier_f32_err, decode_profile=prof, small_err=small_err,
        launches=launches, kernels=per_kernel, **split))


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
    from repro_torch.configs.suite import (
        IMAGEN,
        LLAMA2_7B,
        MAKE_A_VIDEO,
        MUSE,
        PARTI,
        PHENAKI,
        PROD_IMAGE,
        STABLE_DIFFUSION,
        with_dtype,
    )
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
    usage = ptxas_usage(build.nvcc_log())
    log("[ptxas] flash attention (registers, spill-store bytes): " + "; ".join(
        f"D {d} {t}: {usage[f'{t} {d}']['registers']}, {usage[f'{t} {d}']['spill_stores']}"
        for d in (40, 64, 128, 160, 192) for t in ("f", "bf16")))
    mma = sass_mma(build.BUILD_ROOT / build.source_hash() / build.LIB_NAME)
    log("[sass] " + ("cuobjdump not found: not checked" if mma is None else "; ".join(
        f"{fam}: {v['instances']} instances, each with >= {v['hmma_per_instance_min']} HMMA, "
        f"opcodes {v['opcodes']}" for fam, v in mma.items())))

    # -- 3-7, per path ----------------------------------------------------------
    t_all = time.perf_counter()
    spatial = ("conv2d", "flash_attention", "groupnorm_silu")
    paths = {
        STABLE_DIFFUSION.name: run_path(
            STABLE_DIFFUSION, tag="main", record_steps=1, smi=smi, kernels=spatial,
            serve_fn=serve_stable_diffusion),
        MAKE_A_VIDEO.name: run_path(
            MAKE_A_VIDEO, tag="main-ttv", record_steps=2, smi=smi, kernels=tuple(SOURCES)),
        IMAGEN.name: run_path(IMAGEN, tag="main-sr", record_steps=1, smi=smi, kernels=spatial,
                              serve_fn=serve_imagen),
        PROD_IMAGE.name: run_path(
            PROD_IMAGE, tag="main-prod", record_steps=1, smi=smi, kernels=spatial),
        MUSE.name: run_path(MUSE, tag="main-muse", record_steps=1, smi=smi,
                            kernels=("conv2d", "flash_attention")),
        PHENAKI.name: run_path(PHENAKI, tag="main-phenaki", record_steps=1, smi=smi,
                               kernels=("flash_attention", "temporal_flash_attention")),
        LLAMA2_7B.name: run_path(LLAMA2_7B, tag="main-lm", record_steps=1, smi=smi,
                                 kernels=("flash_attention",), serve_fn=serve_llama),
        # bf16: 87.6 GB of fp32 weights do not fit the card's 80 GB
        PARTI.name: run_path(with_dtype(PARTI, torch.bfloat16), tag="main-parti",
                             record_steps=1, smi=smi, kernels=("conv2d", "flash_attention")),
    }
    kernels = summarize(paths)
    paths_s = time.perf_counter() - t_all
    log(f"[total] {len(paths)} paths in {paths_s:.1f} s")
    summary = dict(device=smi, kind=kind, paths_s=paths_s, sass_mma=mma,
                   paths={k: v["summary"] for k, v in paths.items()}, kernels=kernels)
    (OUT_DIR / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
