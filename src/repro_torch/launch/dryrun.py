"""Multi-pod dry-run of the port: dispatch every (arch x shape x mesh) cell
once on a fake world, the port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell's jitted step for 256 / 512
fake host devices and reads XLA's analyses.  The port has no compiler: for
each cell the dry-run

  1. joins a fake world of ``ensure_host_device_count(512)`` ranks (the
     ``XLA_FLAGS`` count in effect) and builds the production mesh on it,
     (16, 16) single-pod / (2, 16, 16) multi-pod (``launch.mesh``),
  2. places the bf16 model's leaves, the optimizer state, the batch and the
     decode caches as DTensors whose local tensors are on ``meta``, with the
     reference's shardings (``launch.steps``: the active profile's rules,
     batch over ``(pod, data)``, the caches' decode / prefill layouts),
  3. dispatches the step once (``make_train_step`` / ``make_prefill_step``
     / ``make_serve_step``) under ``core.hlo_analysis.record_step``, the
     outputs redistributed to the reference's ``out_shardings`` inside it,
     proving the distribution config coherent (every DTensor rule and
     redistribution exists at these shapes), and
  4. records one rank's memory, flops, bytes and collectives and their
     roofline (``core.roofline``, on ``H100_SXM``) in the reference's record
     schema, to ``results/torch_dryrun.json``.

In place (``alias``): a decode writes its cache, a train step its
parameters and moments; its step counter is a new scalar, where the
reference donates it too.  ``compile_s`` is the wall time of that dispatch.  The port runs every
layer and every microbatch eagerly, so its counts have no scan-once
artifact and the reference's ``unroll`` has no counterpart.  The depth
correction is kept as a check: fitted over two shallow depths (with the
cell's microbatches, each run in full), it must reproduce the direct
full-depth count (``depth_correction["matches_direct"]``, exact for a
homogeneous stack); the record's terms are the direct count's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --single-pod-only
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.configs.suite import with_dtype
from repro_torch.core import hlo_analysis, roofline
from repro_torch.core.perf_model import H100_SXM
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import (
    ensure_host_device_count,
    fake_world,
    make_production_mesh,
    mesh_chips,
)
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn import param_defs
from repro_torch.parallel import sharding as shlib
from repro_torch.training.optimizer import adamw_init
from repro_torch.workload.base import tree_map

RESULTS_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "results", "torch_dryrun.json")


def _res_path(path=None):
    p = path or os.path.abspath(RESULTS_PATH)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    return p


def _shallow_pair(cfg) -> tuple[int, int]:
    """Two shallow depths of whole block-pattern cycles (after an MoE's
    leading dense layers)."""
    pat = max(1, len(cfg.block_pattern))
    fk = cfg.moe.first_k_dense if cfg.moe is not None else 0
    n_a = fk + pat
    return n_a, n_a + pat


def _shallow_cfg(cfg, n: int):
    changes = {"n_layers": n, "name": f"{cfg.name}-depth{n}"}
    if cfg.encoder is not None:
        enc_n = max(1, round(cfg.encoder.n_layers * n / cfg.n_layers))
        changes["encoder"] = dataclasses.replace(cfg.encoder, n_layers=enc_n)
    return dataclasses.replace(cfg, **changes)


def default_microbatches(shape, mesh, *, target_tokens: int = 4096) -> int:
    """Gradient-accumulation factor keeping <= target tokens/device/microbatch
    (the production memory knob; B/mb must stay divisible by the DP width)."""
    if shape.kind != "train":
        return 1
    sizes = shlib.mesh_shape(mesh)
    shards = 1
    for a in shlib.batch_axes(mesh):
        shards *= sizes[a]
    local_tokens = shape.global_batch * shape.seq_len // max(shards, 1)
    mb = 1
    while (local_tokens // mb > target_tokens
           and shape.global_batch % (mb * 2) == 0
           and (shape.global_batch // (mb * 2)) % shards == 0):
        mb *= 2
    return mb


def _placed(x: torch.Tensor, sharding) -> torch.Tensor:
    """``x`` (a global ``meta`` tensor) as a DTensor with ``sharding``: each
    rank's local tensor on ``meta``, nothing moved."""
    return shlib.distribute(x, sharding.mesh, sharding.spec)


def _to(x, sharding):
    """A step's result leaf redistributed to ``sharding`` (the reference's
    ``out_shardings``): counted inside the step, as XLA's program has it."""
    if not shlib.is_dtensor(x):
        return x
    return x.redistribute(sharding.mesh, sharding.placements)


def _placed_model(cfg, mesh, *, train: bool) -> TransformerLM:
    """The model with every declared leaf a ``meta`` DTensor placed by the
    active profile's rules (the reference's ``param_shardings``); trainable
    leaves for a train step."""
    model = TransformerLM(cfg)
    p_sh = steps_lib.param_shardings(model, mesh)
    model = shlib._set_params(model, {k: _placed(model.get_parameter(k), s)
                                      for k, s in p_sh.items()})
    if train:
        for p in _leaves(model).values():
            p.requires_grad_(True)
    return model


def _leaves(model) -> dict:
    return {k: model.get_parameter(k) for k in param_defs(model)}


def _batch_shardings(cfg, shape, mesh, batch: dict) -> dict:
    """The reference's input shardings of ``input_specs``' leaves: batch
    over the batch axes (axis 1 of the (3, B, S) M-RoPE streams)."""
    B = shape.global_batch
    out = {}
    for k, x in batch.items():
        if k == "mrope_positions":
            spec = shlib.batch_sharding_for(mesh, B, 2).spec
            out[k] = shlib.NamedSharding(mesh, (None, *spec))
        else:
            out[k] = shlib.batch_sharding_for(mesh, B, x.ndim)
    return out


def _lower_for(cfg, shape, mesh, *, impl, remat, microbatches=None) -> hlo_analysis.StepRecord:
    """Dispatch one step of ``cfg`` at ``shape`` on ``mesh`` (all on
    ``meta``) under a step counter; returns its record (the port's compiled
    program)."""
    B, S = shape.global_batch, shape.seq_len
    model = _placed_model(cfg, mesh, train=shape.kind == "train")
    batch = steps_lib.input_specs(cfg, shape)
    batch_sh = _batch_shardings(cfg, shape, mesh, batch)
    batch = {k: _placed(x, batch_sh[k]) for k, x in batch.items()}
    if microbatches is None:
        microbatches = default_microbatches(shape, mesh)
    logits_sh = shlib.batch_sharding_for(mesh, B, 3)
    if shape.kind == "train":
        step = steps_lib.make_train_step(model, cfg, mesh, remat=remat, impl=impl,
                                         microbatches=microbatches)
        params = _leaves(model)
        _, rec = hlo_analysis.record_step(step, params, adamw_init(params), batch)
        return rec
    if shape.kind == "prefill":
        prefill = steps_lib.make_prefill_step(model, cfg, mesh, impl=impl)

        def step(params, batch):  # the model reads ``params``: its own leaves
            logits, caches, _ = prefill(batch)
            c_sh = steps_lib.cache_shardings(caches, mesh, B, layout="prefill")
            return _to(logits, logits_sh), tree_map(_to, caches, c_sh)

        with torch.no_grad():
            _, rec = hlo_analysis.record_step(step, _leaves(model), batch)
        return rec
    serve = steps_lib.make_serve_step(model, cfg, mesh, impl=impl)
    caches = steps_lib.abstract_cache(TransformerLM(cfg), B, S)
    c_sh = steps_lib.cache_shardings(caches, mesh, B)
    caches = tree_map(_placed, caches, c_sh)

    # the cache's last position: every row attended, as the reference's
    # static-shape decode attention over the whole cache
    def step(params, token, caches, cur_len, context=None):
        logits, caches = serve(token, caches, cur_len, context=context)
        return _to(logits, logits_sh), tree_map(_to, caches, c_sh)

    with torch.no_grad():
        _, rec = hlo_analysis.record_step(step, _leaves(model), batch["token"], caches, S - 1,
                                          batch.get("context"))
    return rec


def _terms(record: hlo_analysis.StepRecord) -> dict:
    cost = hlo_analysis.cost_summary(record)
    coll = hlo_analysis.collective_stats(record)
    return {
        "flops": float(cost.get("flops", 0.0)),
        "bytes": float(cost.get("bytes accessed", 0.0)),
        "coll": float(coll.wire_bytes),
    }


def depth_correction(arch: str, shape_name: str, *, impl: str, remat: str,
                     multi_pod: bool = False, microbatches=None) -> dict:
    """Per-layer terms from two shallow dispatches -> totals at full depth.

    The reference fits them because XLA counts a scanned layer stack (and
    its microbatch loop) once; the port runs each layer and microbatch, so
    the shallow variants run the cell's microbatches in full and the fit
    is not scaled by them.  Exact for homogeneous stacks, whole-cycle
    linear for hybrids."""
    cfg = with_dtype(get_config(arch), torch.bfloat16)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    mb = (microbatches if microbatches is not None
          else default_microbatches(shape, mesh))
    return fit_depth(cfg, shape, mesh, impl=impl, remat=remat, microbatches=mb)


def fit_depth(cfg, shape, mesh, *, impl: str, remat: str, microbatches: int) -> dict:
    """:func:`depth_correction` of any config on any mesh."""
    n_a, n_b = _shallow_pair(cfg)
    t = {}
    for n in (n_a, n_b):
        t[n] = _terms(_lower_for(_shallow_cfg(cfg, n), shape, mesh, impl=impl, remat=remat,
                                 microbatches=microbatches))
    n_full = cfg.n_layers
    out = {"n_a": n_a, "n_b": n_b, "n_full": n_full, "mb": microbatches}
    for k in ("flops", "bytes", "coll"):
        per_layer = (t[n_b][k] - t[n_a][k]) / (n_b - n_a)
        fixed = t[n_a][k] - n_a * per_layer
        out[k] = max(fixed + n_full * per_layer, t[n_b][k])
        out[f"{k}_per_layer"] = per_layer
    return out


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               impl: str = "blocked_jax", remat: str = "dots",
               profile: str = "2d", correct: bool = True,
               microbatches: int | None = None,
               verbose: bool = True) -> dict:
    """Dispatch one cell on the fake world; returns the result record."""
    shlib.set_profile(profile)
    cfg = with_dtype(get_config(arch), torch.bfloat16)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "impl": impl, "remat": remat, "profile": profile, "status": "pending",
    }
    if not cfg.supports_shape(shape):
        rec["status"] = "skipped"
        rec["reason"] = "full-attention arch at 500k (sub-quadratic required)"
        return rec

    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec["microbatches"] = (microbatches if microbatches is not None
                           else default_microbatches(shape, mesh))
    record = _lower_for(cfg, shape, mesh, impl=impl, remat=remat,
                        microbatches=microbatches)
    t_compile = time.time() - t0

    mem = hlo_analysis.memory_summary(record)
    coll = hlo_analysis.collective_stats(record)
    mf = roofline.model_flops_for(cfg, shape)
    rep = roofline.analyze(
        arch=arch, shape=shape_name, mesh_name=mesh_name,
        n_chips=mesh_chips(mesh), record=record, model_flops=mf, hw=H100_SXM,
    )

    # the reference's depth correction, here a check of the direct count
    if correct:
        corr = depth_correction(arch, shape_name, impl=impl, remat=remat,
                                multi_pod=multi_pod,  # profile already set
                                microbatches=microbatches)
        direct = {"flops": rep.hlo_flops, "bytes": rep.hlo_bytes,
                  "coll": rep.collective_bytes}
        corr["direct"] = direct
        corr["matches_direct"] = all(corr[k] == direct[k] for k in direct)
        rec["depth_correction"] = corr

    rec.update(
        status="ok",
        hw=H100_SXM.name,
        compile_s=round(t_compile, 1),
        memory=mem,
        flops=rep.hlo_flops,
        bytes_accessed=rep.hlo_bytes,
        collective_bytes=coll.total_bytes,
        collective_wire_bytes=rep.collective_bytes,
        collectives=coll.count_by_type,
        roofline=rep.to_dict(),
    )
    if verbose:
        hbm_gb = mem.get("total_bytes", 0) / 2**30
        print(
            f"  [{arch} x {shape_name} x {mesh_name}] OK "
            f"compile {t_compile:.0f}s | "
            f"mem/device {hbm_gb:.2f} GiB | flops {rec['flops']:.3e} | "
            f"coll {rep.collective_bytes/2**30:.2f} GiB | dominant {rep.dominant} | "
            f"roofline {rep.roofline_fraction:.3f}",
            flush=True,
        )
    return rec


def load_results(path) -> list:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return []


def save_result(rec: dict, path) -> None:
    results = load_results(path)
    results = [
        r for r in results
        if not (r["arch"] == rec["arch"] and r["shape"] == rec["shape"]
                and r["mesh"] == rec["mesh"] and r.get("impl") == rec.get("impl")
                and r.get("remat") == rec.get("remat")
                and r.get("profile", "2d") == rec.get("profile", "2d"))
    ]
    results.append(rec)
    with open(path, "w") as f:
        json.dump(results, f, indent=1, default=float)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="single arch id")
    ap.add_argument("--shape", default=None, help="single shape id")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--impl", default="blocked_jax")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--no-correct", action="store_true",
                    help="skip the depth-extrapolation check")
    ap.add_argument("--profile", default="2d",
                    help="sharding profile: 2d (FSDP+TP) | fsdp (ZeRO-only)")
    args = ap.parse_args(argv)

    out_path = _res_path(args.out)
    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = []
    if not args.multi_pod_only:
        meshes.append(False)
    if not args.single_pod_only:
        meshes.append(True)

    done = {
        (r["arch"], r["shape"], r["mesh"])
        for r in load_results(out_path)
        if r.get("status") in ("ok", "skipped")
    } if args.skip_done else set()

    with fake_world(ensure_host_device_count(512)):
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    mesh_name = "pod2x16x16" if mp else "pod16x16"
                    if (arch, shape, mesh_name) in done:
                        print(f"  [{arch} x {shape} x {mesh_name}] cached, skip",
                              flush=True)
                        continue
                    try:
                        rec = lower_cell(arch, shape, multi_pod=mp,
                                         impl=args.impl, remat=args.remat,
                                         profile=args.profile,
                                         correct=not args.no_correct and not mp)
                    except Exception as e:  # noqa: BLE001 — record and continue
                        rec = {
                            "arch": arch, "shape": shape, "mesh": mesh_name,
                            "impl": args.impl, "remat": args.remat,
                            "status": "error", "error": f"{type(e).__name__}: {e}",
                            "trace": traceback.format_exc()[-2000:],
                        }
                        print(f"  [{arch} x {shape} x {mesh_name}] "
                              f"ERROR {type(e).__name__}: {e}", flush=True)
                    save_result(rec, out_path)


if __name__ == "__main__":
    main()
