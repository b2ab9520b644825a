"""The two sides of ``tests/test_torch_dryrun.py``, each run as a script in
a process of its own (a JAX host-device count and a fake process group are
both fixed for the life of a process):

    python tests/torch_dryrun_worlds.py jax OUT.json    # the reference, 8 host devices
    python tests/torch_dryrun_worlds.py torch OUT.json  # the port, an 8-rank fake world
    python tests/torch_dryrun_worlds.py torch_ssm OUT.json  # the port's SSM train steps

Both count a tiny olmo-1b (2 layers, d 64, 4 heads, d_ff 128, vocab 256,
fp32) at a 64-token, 8-sequence prefill, decode and train step on a (4, 2)
(data, model) mesh.  The reference lowers its dry-run's ``_lower_for`` on
an Auto-axes mesh (jax 0.9's default Explicit axes refuse the reference's
``with_sharding_constraint``) with every layer unrolled, as the port runs
them; it also gives its pure helpers (microbatches, shallow depths, the
hill-climb playbook, the long-context skip record).  The port also counts a
mesh-free prefill, a column- then row-parallel MLP, and the depth fit
against the direct count; ``torch_ssm`` counts the reduced sub-quadratic
LMs' train steps under both profiles (softplus's backward on DTensor).
Each writes one JSON object to ``OUT``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, head_dim=0)
KINDS = ("prefill", "decode", "train")
SEQ, BATCH = 64, 8
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
PROFILES = ("2d", "fsdp")
SKIP_ARCH = "olmo-1b"  # a full-attention arch
# the port's extra cases
FREE = dict(batch=2, seq=16)  # the mesh-free prefill of the hand count
MLP = dict(batch=8, seq=16, d=64, f=128)  # the column- then row-parallel MLP
DEPTH = 4  # layers of the depth-fit check
SSM_ARCHS = ("mamba2-780m", "recurrentgemma-9b")  # their reduced configs' train steps


def reference() -> dict:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from jax.sharding import AbstractMesh, AxisType

    from repro.configs import ASSIGNED_ARCHS, SHAPES, get_config
    from repro.configs.base import ShapeSpec
    from repro.core import hlo_analysis
    from repro.launch import dryrun
    from repro.launch.hillclimb import PLAYBOOK
    from repro.parallel import sharding as shlib

    mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    cfg = dataclasses.replace(get_config("olmo-1b"), **TINY)
    steps = {}
    for kind in KINDS:
        lowered, compiled = dryrun._lower_for(cfg, ShapeSpec(kind, kind, SEQ, BATCH), mesh,
                                              impl="blocked_jax", remat="dots", unroll=True,
                                              microbatches=1)
        steps[kind] = dict(memory=hlo_analysis.memory_summary(compiled),
                           flops=float(hlo_analysis.cost_summary(compiled)["flops"]),
                           output_leaves=len(jax.tree.leaves(lowered.out_info)))
    microbatches = {}
    for name, (sizes, names) in MESHES.items():
        for profile in PROFILES:
            shlib.set_profile(profile)
            am = AbstractMesh(sizes, names)
            microbatches[f"{name}/{profile}"] = {
                s: dryrun.default_microbatches(SHAPES[s], am) for s in SHAPES}
    shlib.set_profile("2d")
    shallow = {}
    for arch in ASSIGNED_ARCHS:
        c = get_config(arch)
        n_a, n_b = dryrun._shallow_pair(c)
        shallow[arch] = [n_a, n_b] + [
            [s.n_layers, s.encoder.n_layers if s.encoder else None, s.name]
            for s in (dryrun._shallow_cfg(c, n) for n in (n_a, n_b))]
    skips = [dryrun.lower_cell(SKIP_ARCH, "long_500k", multi_pod=mp) for mp in (False, True)]
    return dict(steps=steps, microbatches=microbatches, shallow=shallow, playbook=PLAYBOOK,
                skips=skips)


def port() -> dict:
    import torch

    from repro_torch.configs import ASSIGNED_ARCHS, get_config
    from repro_torch.configs.base import SHAPES, ShapeSpec
    from repro_torch.core import hlo_analysis
    from repro_torch.launch import dryrun, steps as steps_lib
    from repro_torch.launch.mesh import fake_world, make_debug_mesh
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.nn import param_defs
    from repro_torch.parallel import sharding as shlib
    from repro_torch.parallel.mesh_exec import mesh_scope

    torch.set_num_threads(1)
    cfg = dataclasses.replace(get_config("olmo-1b"), **TINY)
    out: dict = {"steps": {}, "depth": {}}

    # mesh-free: a prefill on meta
    model = TransformerLM(cfg)
    prefill = steps_lib.make_prefill_step(model, cfg, impl="blocked_jax")
    tokens = torch.empty((FREE["batch"], FREE["seq"]), dtype=torch.int32, device="meta")
    with torch.no_grad():
        _, rec = hlo_analysis.record_step(
            lambda params, batch: prefill(batch),
            {k: model.get_parameter(k) for k in param_defs(model)}, {"tokens": tokens})
    out["free_prefill"] = dict(flops=rec.flops, ops=dict(rec.ops),
                               collectives=rec.collective_counts)

    microbatches = {}
    for name, (sizes, names) in MESHES.items():
        for profile in PROFILES:
            shlib.set_profile(profile)
            am = shlib.AbstractMesh(sizes, names)
            microbatches[f"{name}/{profile}"] = {
                s: dryrun.default_microbatches(SHAPES[s], am) for s in SHAPES}
    shlib.set_profile("2d")
    out["microbatches"] = microbatches
    out["shallow"] = {}
    for arch in ASSIGNED_ARCHS:
        c = get_config(arch)
        n_a, n_b = dryrun._shallow_pair(c)
        out["shallow"][arch] = [n_a, n_b] + [
            [s.n_layers, s.encoder.n_layers if s.encoder else None, s.name]
            for s in (dryrun._shallow_cfg(c, n) for n in (n_a, n_b))]

    with fake_world(8):
        mesh = make_debug_mesh(4, 2, device="cuda")
        for kind in KINDS:
            rec = dryrun._lower_for(cfg, ShapeSpec(kind, kind, SEQ, BATCH), mesh,
                                    impl="blocked_jax", remat="dots", microbatches=1)
            out["steps"][kind] = dict(memory=hlo_analysis.memory_summary(rec), flops=rec.flops,
                                      bytes=rec.bytes_accessed,
                                      collectives=rec.collective_counts)
        deep = dataclasses.replace(cfg, n_layers=DEPTH)
        for kind, mb in (("prefill", 1), ("decode", 1), ("train", 2)):
            shape = ShapeSpec(kind, kind, SEQ, BATCH)
            fit = dryrun.fit_depth(deep, shape, mesh, impl="blocked_jax", remat="dots",
                                   microbatches=mb)
            direct = dryrun._terms(dryrun._lower_for(deep, shape, mesh, impl="blocked_jax",
                                                     remat="dots", microbatches=mb))
            out["depth"][kind] = dict(fit=fit, direct=direct)


        # one column- then row-parallel MLP: x batch-sharded, W1 (d, f) with f
        # on model, W2 (f, d) with f on model; the output pinned replicated
        B, S, d, f = MLP["batch"], MLP["seq"], MLP["d"], MLP["f"]
        x = shlib.distribute(torch.empty((B, S, d), device="meta"), mesh, ("data", None, None))
        w1 = shlib.distribute(torch.empty((d, f), device="meta"), mesh, (None, "model"))
        w2 = shlib.distribute(torch.empty((f, d), device="meta"), mesh, ("model", None))

        def mlp(x, w1, w2):
            with mesh_scope(mesh):
                return shlib.constrain((x @ w1) @ w2, ("batch", None, None))

        with torch.no_grad():
            y, rec = hlo_analysis.record_step(mlp, x, w1, w2)
        out["mlp"] = dict(flops=rec.flops, collective_bytes=rec.collective_bytes,
                          collective_counts=rec.collective_counts,
                          wire=hlo_analysis.collective_stats(rec).wire_bytes,
                          placements=[str(p) for p in y.placements])
    return out


def port_ssm() -> dict:
    """The port's reduced sub-quadratic LMs' train steps on the same fake
    world and mesh, each profile: their counts, or the error."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_debug_mesh
    from repro_torch.parallel import sharding as shlib

    torch.set_num_threads(1)
    out: dict = {}
    with fake_world(8):
        mesh = make_debug_mesh(4, 2, device="cuda")
        for arch in SSM_ARCHS:
            for profile in PROFILES:
                shlib.set_profile(profile)
                try:
                    rec = dryrun._lower_for(reduced(get_config(arch)),
                                            ShapeSpec("train", "train", SEQ, BATCH), mesh,
                                            impl="blocked_jax", remat="dots", microbatches=1)
                    cell = dict(flops=rec.flops, collectives=rec.collective_counts)
                except Exception as e:  # noqa: BLE001 -- reported by the test
                    cell = dict(error=repr(e))
                out[f"{arch}/{profile}"] = cell
        shlib.set_profile("2d")
    return out


if __name__ == "__main__":
    side, path = sys.argv[1], sys.argv[2]
    result = {"jax": reference, "torch": port, "torch_ssm": port_ssm}[side]()
    with open(path, "w") as fh:
        json.dump(result, fh, default=float)
