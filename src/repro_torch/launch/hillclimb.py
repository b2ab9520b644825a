"""Perf hill-climbing, the port of ``repro.launch.hillclimb``: run the
named optimization variants of the selected cells on the fake world
(``launch.dryrun``) and record their roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell olmo_train
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --all

Each variant is one hypothesis->change->measure iteration; the records go
to ``results/torch_hillclimb.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import traceback

from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import ensure_host_device_count, fake_world

OUT = "results/torch_hillclimb.json"

# cell -> list of (iteration_name, kwargs for lower_cell / overrides)
PLAYBOOK = {
    # most collective-bound cell; also the paper-representative prefill regime
    "glm4_prefill": {
        "arch": "glm4-9b",
        "shape": "prefill_32k",
        "variants": [
            ("baseline_2d", dict(profile="2d", remat="full")),
            ("fsdp_profile", dict(profile="fsdp", remat="full")),
            ("attn_head_sharded", dict(profile="2d", remat="full")),
            ("proj_constrained", dict(profile="2d", remat="full")),
            ("kv_replicated", dict(profile="2d", remat="full")),
        ],
    },
    # worst roofline fraction + over-budget memory
    "qwen2_decode": {
        "arch": "qwen2-72b",
        "shape": "decode_32k",
        "variants": [
            ("baseline_2d", dict(profile="2d", remat="full")),
            ("fsdp_profile", dict(profile="fsdp", remat="full")),
        ],
    },
    # collective-bound small-model train: sharding-profile crossover
    "olmo_train": {
        "arch": "olmo-1b",
        "shape": "train_4k",
        "variants": [
            ("baseline_2d_mb16", dict(profile="2d", remat="full")),
            ("fsdp_mb16", dict(profile="fsdp", remat="full")),
            ("fsdp_mb16_dots", dict(profile="fsdp", remat="dots")),
            ("2d_dots", dict(profile="2d", remat="dots")),
            ("fsdp_mb4_dots", dict(profile="fsdp", remat="dots",
                                   microbatches=4)),
        ],
    },
    # the most collective-bound cell in the whole table (EP dispatch)
    "qwen3_train": {
        "arch": "qwen3-moe-30b-a3b",
        "shape": "train_4k",
        "variants": [
            ("baseline_2d", dict(profile="2d", remat="full")),
            ("fsdp_profile", dict(profile="fsdp", remat="full")),
        ],
    },
}


def _variant(cell: str, name: str, kw: dict) -> dict:
    spec = PLAYBOOK[cell]
    try:
        rec = dr.lower_cell(spec["arch"], spec["shape"], multi_pod=False,
                            impl="blocked_jax", correct=True, **kw)
        rec["iteration"] = name
        rec["cell"] = cell
    except Exception as e:  # noqa: BLE001 — record and continue
        rec = {"cell": cell, "iteration": name, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-1500:]}
        print(f"  [{cell}/{name}] ERROR {rec['error']}", flush=True)
    return rec


def run_cell(cell: str) -> list:
    """Every variant of ``cell`` (inside a fake world: ``launch.mesh.fake_world``)."""
    return [_variant(cell, name, kw) for name, kw in PLAYBOOK[cell]["variants"]]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None, choices=list(PLAYBOOK))
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    cells = [args.cell] if args.cell else list(PLAYBOOK)

    existing = []
    if os.path.exists(OUT):
        with open(OUT) as f:
            existing = json.load(f)
    done = {(r.get("cell"), r.get("iteration")) for r in existing
            if r.get("status") == "ok"}
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with fake_world(ensure_host_device_count(512)):
        for cell in cells:
            for name, kw in PLAYBOOK[cell]["variants"]:
                if (cell, name) in done:
                    print(f"  [{cell}/{name}] cached", flush=True)
                    continue
                rec = _variant(cell, name, kw)
                existing = [r for r in existing
                            if not (r.get("cell") == cell
                                    and r.get("iteration") == name)]
                existing.append(rec)
                with open(OUT, "w") as f:
                    json.dump(existing, f, indent=1, default=float)


if __name__ == "__main__":
    main()
