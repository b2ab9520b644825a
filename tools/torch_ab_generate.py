"""One turn of a parent-vs-change comparison of the PyTorch/CUDA port's
main-path ``generate`` on one card.

    python tools/torch_ab_generate.py ROOT LABEL MODEL [--reps N]

imports ``repro_torch`` from ``ROOT/src`` (a checkout of either commit),
builds MODEL (``llama2-7b``, ``stable-diffusion`` or ``parti``, at full
width, seeded weights) on the card, and times N ``generate`` calls of 2
requests, as ``chip_smoke.py``'s main path drives them (Parti decodes its
first 128 image tokens only).  It prints one line, ``AB {json}``, with each
call's wall seconds, its stage seconds (``on_stage``), the CPU seconds of
the thread that launches the work (``thread_cpu_s``: a host-bound decode
that is slower for its code spends more of them; one that waits for a
shared host core does not) and the host's 1-minute load average.

A comparison runs the turns in one session on one card, each in a fresh
process: parent, change, change, parent.  Unpack the parent with ``git
archive`` into a git-ignored directory and point its
``src/repro_torch/kernels/build`` at this checkout's (the kernel sources
hash alike), so both load one build.
"""

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("label")
    ap.add_argument("model", choices=("llama2-7b", "stable-diffusion", "parti"))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch

    import repro_torch
    from repro_torch.configs.suite import LLAMA2_7B, PARTI, STABLE_DIFFUSION, with_dtype
    from repro_torch.workload import workload_for

    if not Path(repro_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {repro_torch.__file__}, not the checkout at {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = {"llama2-7b": LLAMA2_7B, "stable-diffusion": STABLE_DIFFUSION,
           "parti": with_dtype(PARTI, torch.bfloat16)}[args.model]
    wl = workload_for(cfg)
    model = wl.init(0, "cuda")
    rng = torch.Generator().manual_seed(0)
    tokens = [torch.randint(0, wl.prompt_vocab, (wl.max_prompt_len,), generator=rng).numpy()
              for _ in range(2)]
    run_wl = workload_for(dataclasses.replace(cfg, image_tokens=128)) if args.model == "parti" else wl
    runs = []
    for rep in range(args.reps):
        stage_s = {}
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.thread_time()
        run_wl.generate(model, tokens, 0, on_stage=lambda n, s, b: stage_s.__setitem__(n, s))
        torch.cuda.synchronize()
        runs.append(dict(rep=rep, total_s=time.perf_counter() - t0,
                         thread_cpu_s=time.thread_time() - c0, stage_s=stage_s,
                         loadavg_1m=os.getloadavg()[0]))
    print("AB", json.dumps(dict(label=args.label, model=args.model,
                                device=torch.cuda.get_device_name(0), runs=runs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
