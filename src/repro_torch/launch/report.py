"""Render the dry-run's records (``results/torch_dryrun.json``) as the
dry-run and roofline markdown tables, the port of ``repro.launch.report``:
the same records give the same text.

    PYTHONPATH=src python -m repro_torch.launch.report [--json results/torch_dryrun.json]

The port's records name the card their terms are modeled on (``hw``); the
tables' seconds are that card's (``H100_SXM`` by default), and "HLO FLOPs"
is the port's count of one rank's dispatched step (``core.hlo_analysis``).
"""

from __future__ import annotations

import argparse
import json


def fmt_bytes(b: float) -> str:
    return f"{b / 2**30:.2f}"


def fmt_s(s: float) -> str:
    if s >= 1:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.1f}ms"
    return f"{s * 1e6:.0f}us"


def one_line(r: dict) -> str:
    rf = r["roofline"]
    mem_gib = r["memory"].get("total_bytes", 0) / 2**30
    return (
        f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.3f} | "
        f"{rf['memory_s']:.3f} | {rf['collective_s']:.3f} | "
        f"**{rf['dominant']}** | {rf['model_flops']:.2e} | "
        f"{rf['useful_ratio']:.2f} | {rf['roofline_fraction']:.3f} | "
        f"{mem_gib:.1f} |"
    )


def dryrun_line(r: dict) -> str:
    mem_gib = r["memory"].get("total_bytes", 0) / 2**30
    colls = ",".join(f"{k.split('-')[1] if '-' in k else k}:{v}"
                     for k, v in sorted(r.get("collectives", {}).items()))
    return (
        f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
        f"{mem_gib:.2f} | {r['flops']:.2e} | "
        f"{r.get('collective_wire_bytes', 0) / 2**30:.2f} | {colls} | "
        f"{r.get('compile_s', 0):.0f}s |"
    )


def render(records: list, *, profile="2d", remat="full") -> str:
    ok = [r for r in records if r["status"] == "ok"
          and r.get("profile", "2d") == profile and r.get("remat") == remat]
    skipped = [r for r in records if r["status"] == "skipped"]
    errors = [r for r in records if r["status"] == "error"]

    out = []
    out.append("### Dry-run matrix (both meshes)\n")
    out.append(f"{len(ok)} cells compiled OK, {len(set((r['arch'], r['shape']) for r in skipped))} "
               "skipped by rule (long_500k on full-attention archs), "
               f"{len(errors)} errors.\n")
    out.append("| arch | shape | mesh | status | GiB/device | HLO FLOPs/dev | "
               "coll GiB/dev | collective ops | compile |")
    out.append("|---|---|---|---|---|---|---|---|---|")
    for r in sorted(ok, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        out.append(dryrun_line(r))
    for r in skipped:
        out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | skipped | "
                   f"- | - | - | {r.get('reason', '')} | - |")

    out.append("\n### Roofline table (single-pod 16x16, per-device terms, "
               "depth-corrected)\n")
    out.append("| arch | shape | compute s | memory s | collective s | "
               "dominant | MODEL_FLOPS | useful | roofline frac | GiB/dev |")
    out.append("|---|---|---|---|---|---|---|---|---|---|")
    single = [r for r in ok if r["mesh"] == "pod16x16"
              and "depth_correction" in r]
    for r in sorted(single, key=lambda r: (r["arch"], r["shape"])):
        out.append(one_line(r))
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="results/torch_dryrun.json")
    ap.add_argument("--profile", default="2d")
    # the dry-run CLI's default remat (the reference's report keeps "full",
    # which leaves its own CLI's records out of the tables)
    ap.add_argument("--remat", default="dots")
    args = ap.parse_args(argv)
    with open(args.json) as f:
        records = json.load(f)
    print(render(records, profile=args.profile, remat=args.remat))


if __name__ == "__main__":
    main()
