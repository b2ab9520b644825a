"""The rank bodies of ``tests/test_torch_mesh.py``: every rank of a CPU gloo
world runs :func:`main` (SPMD), imports no JAX, and writes its results to
``out<world>_<rank>.pt`` in the test's directory.

The parent test writes the inputs (``inputs.pt``: seeded parameters, the
prompts, the reference's diffusion noise) and holds the results against
the JAX reference.  Each check catches its own exception and records it,
so one failing check reports instead of hanging the other ranks; a rank
that hangs in a collective fails at the process group's timeout.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import os
import sys
import time
import traceback

import numpy as np
import torch

PG_TIMEOUT_S = 60.0


def _checked(out: dict, name: str, fn, *args):
    t0 = time.perf_counter()
    try:
        out[name] = fn(*args)
    except Exception:  # noqa: BLE001 -- reported to the parent test
        out[name] = {"error": traceback.format_exc()}
    out.setdefault("seconds", {})[name] = time.perf_counter() - t0


def _whole(x):
    from repro_torch.parallel.sharding import whole

    return whole(x).detach().clone()


# ---------------------------------------------------------------------------
# The five dispatchers on shards
# ---------------------------------------------------------------------------


def _placed(x, mesh, placements):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def dispatchers(mesh) -> dict:
    """Each dispatcher on DTensor operands laid out as the model hands them
    over (batch on ``data``, heads / C_out on ``model``) against its plain
    version on the whole operands; a gradient case for attention and conv."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels.conv2d import ops as conv_ops
    from repro_torch.kernels.conv2d import ref as conv_ref
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention import ref as attn_ref
    from repro_torch.kernels.groupnorm_silu import ops as gn_ops
    from repro_torch.kernels.groupnorm_silu import ref as gn_ref
    from repro_torch.parallel.mesh_exec import mesh_scope

    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    R, S0, S1, S2, S3 = Replicate(), Shard(0), Shard(1), Shard(2), Shard(3)
    res = {}

    def err(got, want):
        return float((_whole(got) - want).abs().max())

    with mesh_scope(mesh):
        for name, (B, S, H, KVH, D, causal) in {
                "attention_mha": (4, 16, 4, 4, 8, True),
                "attention_gqa": (4, 16, 8, 2, 8, False)}.items():
            q, k, v = rand(B, S, H, D), rand(B, S, KVH, D), rand(B, S, KVH, D)
            want = attn_ref.attention_ref(q, k, v, causal=causal, scale=D ** -0.5)
            got = attn_ops.attention(_placed(q, mesh, [S0, S2]), _placed(k, mesh, [S0, R]),
                                     _placed(v, mesh, [S0, R]), causal=causal, impl="auto")
            res[name] = {"err": err(got, want), "scale": float(want.abs().max())}
        # GQA gradients through the kernel tier's Function on the shards
        B, S, H, KVH, D = 4, 16, 8, 2, 8
        q, k, v, g = rand(B, S, H, D), rand(B, S, KVH, D), rand(B, S, KVH, D), rand(B, S, H, D)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad((attn_ref.attention_ref(*leaves, scale=D ** -0.5) * g).sum(),
                                   leaves)
        dts = [_placed(t, mesh, pl).requires_grad_(True) for t, pl in
               zip((q, k, v), ([S0, S2], [S0, R], [S0, R]))]
        out = attn_ops.attention(*dts, impl="auto")
        got = torch.autograd.grad((out * _placed(g, mesh, [S0, S2])).sum(), dts)
        res["attention_gqa_grad"] = {"err": max(err(a, b) for a, b in zip(got, want)),
                                     "scale": max(float(b.abs().max()) for b in want)}
        # what a flat head split would compute: local heads h of a rank's
        # block mapped by h // (local heads / KVH), the wrong KV head
        ql, kl = q[:, :, :H // 2], k
        flat = attn_ref.attention_ref(ql, kl, v, scale=D ** -0.5)
        res["attention_gqa_flat_split_err"] = float(
            (flat - attn_ref.attention_ref(q, k, v, scale=D ** -0.5)[:, :, :H // 2]).abs().max())

        B, F, N, Hh, D = 4, 5, 6, 4, 8
        q, k, v = rand(B, F, N, Hh, D), rand(B, F, N, Hh, D), rand(B, F, N, Hh, D)
        want = attn_ref.temporal_attention_ref(q, k, v, scale=D ** -0.5)
        got = attn_ops.temporal_attention(*(_placed(t, mesh, [S0, Shard(3)]) for t in (q, k, v)),
                                          impl="auto")
        res["temporal_attention"] = {"err": err(got, want), "scale": float(want.abs().max())}

        # channel-parallel conv with the fused producer, temb, residual, stats
        B, Hs, Ci, Co = 4, 8, 8, 8
        x, w, bias = rand(B, Hs, Hs, Ci), rand(3, 3, Ci, Co) * 0.2, rand(Co)
        a, b, temb, resid = rand(B, Ci), rand(B, Ci), rand(B, Co), rand(B, Hs, Hs, Co)
        want_y, want_s = conv_ref.conv2d_ref(x, w, gn_a=a, gn_b=b, bias=bias, temb=temb,
                                             residual=resid, emit_stats=True)
        got_y, got_s = conv_ops.conv2d(
            _placed(x, mesh, [S0, R]), _placed(w, mesh, [R, S3]),
            bias=_placed(bias, mesh, [R, S0]),
            gn_affine=(_placed(a, mesh, [S0, R]), _placed(b, mesh, [S0, R])),
            temb=_placed(temb, mesh, [S0, S1]), residual=_placed(resid, mesh, [S0, S3]),
            emit_stats=True, impl="auto")
        res["conv2d_channel_tp"] = {"err": err(got_y, want_y), "scale": float(want_y.abs().max()),
                                    "stats_err": err(got_s, want_s),
                                    "stats_scale": float(want_s.abs().max()),
                                    "out_placements": [str(p) for p in got_y.placements]}
        want = conv_ref.conv2d_ref(x, w, stride=2)
        got = conv_ops.conv2d(_placed(x, mesh, [S0, R]), _placed(w, mesh, [R, S3]), stride=2,
                              impl="auto")
        res["conv2d_stride2"] = {"err": err(got, want), "scale": float(want.abs().max())}
        # its gradients, the input's a partial sum over the C_out shards
        gy = rand(B, Hs, Hs, Co)
        leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
        want = torch.autograd.grad(
            (conv_ref.conv2d_ref(leaves[0], leaves[1], bias=leaves[2]) * gy).sum(), leaves)
        dts = [_placed(t, mesh, pl).requires_grad_(True)
               for t, pl in zip((x, w, bias), ([S0, R], [R, S3], [R, S0]))]
        y = conv_ops.conv2d(dts[0], dts[1], bias=dts[2], impl="auto")
        got = torch.autograd.grad((y * _placed(gy, mesh, [S0, S3])).sum(), dts)
        res["conv2d_grad"] = {"err": max(err(a, b) for a, b in zip(got, want)),
                              "scale": max(float(b.abs().max()) for b in want)}

        x5, wt, bt = rand(B, 5, 4, 4, 8), rand(3, 8, 8) * 0.3, rand(8)
        want = conv_ref.temporal_conv1d_ref(x5, wt, bt)
        got = conv_ops.temporal_conv1d(_placed(x5, mesh, [S0, R]), _placed(wt, mesh, [R, S2]),
                                       _placed(bt, mesh, [R, S0]), impl="auto")
        res["temporal_conv1d"] = {"err": err(got, want), "scale": float(want.abs().max())}

        x3, sc, bi = rand(B, 16, 8), rand(8), rand(8)
        for groups in (4, 1):  # whole groups on each channel shard; one group: gathered
            want = gn_ref.groupnorm_silu_onepass_ref(x3, sc, bi, groups=groups, silu=True)
            got = gn_ops.groupnorm_silu(_placed(x3, mesh, [S0, S2]), _placed(sc, mesh, [R, S0]),
                                        _placed(bi, mesh, [R, S0]), groups=groups,
                                        impl="auto")
            res[f"groupnorm_silu_g{groups}"] = {"err": err(got, want),
                                                "scale": float(want.abs().max()),
                                                "out_placements": [str(p) for p in got.placements]}
    return res


# ---------------------------------------------------------------------------
# Serving: the lm, pod and cascade routes, the launcher
# ---------------------------------------------------------------------------


class _StageKey:
    """The stage generator's stand-in: it names (seed, rid, stage) so the
    reference's noise for them can be looked up."""

    def __init__(self, seed, rid, stage_index):
        self.key = (int(seed), int(rid), int(stage_index))


def _reference_noise(table):
    def stage_noise(gens, shape, dtype, device):
        return torch.stack([torch.as_tensor(table[g.key]) for g in gens]).to(device, dtype)

    return stage_noise


def _serve(wl, params, mesh, prompts, max_new: int, **cfg) -> tuple[dict, dict]:
    from repro_torch.serving.engine import ServeConfig, ServeEngine
    from repro_torch.telemetry import validate_engine_stats

    eng = ServeEngine(wl, params, ServeConfig(mesh=mesh, seed=0, **cfg))
    for rid, p in enumerate(prompts):
        eng.submit(rid, p, max_new)
    results = eng.run()
    validate_engine_stats(eng.stats, eng.route)
    return {r: torch.as_tensor(results[r]).detach().clone() for r in sorted(results)}, eng.stats


def serve_lm(mesh, inputs) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.workload.base import reduced_workload

    wl = reduced_workload(get_config("olmo-1b"))
    params = wl.load(inputs["olmo_state"], "cpu")
    prompts = inputs["olmo_tokens"]
    out, stats = _serve(wl, params, mesh, prompts, inputs["olmo_new"],
                        max_batch=len(prompts), buckets=(prompts.shape[1],))
    free, _ = _serve(wl, params, None, prompts, inputs["olmo_new"],
                     max_batch=len(prompts), buckets=(prompts.shape[1],))
    return {"tokens": out, "mesh_free": free, "mesh": stats["mesh"]}


def serve_sd(mesh, inputs) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.pipeline import stage as t_stage
    from repro_torch.workload import base as t_base
    from repro_torch.workload import diffusion as t_diffusion
    from repro_torch.workload import workload_for
    from repro_torch.workload.base import reduced_workload

    wl = reduced_workload(get_config("stable-diffusion"))
    wl = workload_for(dataclasses.replace(wl.cfg, denoise_steps=inputs["sd_steps"]))
    params = wl.load(inputs["sd_state"], "cpu")
    prompts = inputs["sd_tokens"]
    saved = t_base.stage_generator, t_diffusion.stage_noise
    t_base.stage_generator = t_stage.stage_generator = _StageKey
    t_diffusion.stage_noise = _reference_noise(inputs["sd_noise"])
    try:
        pod, pod_stats = _serve(wl, params, mesh, prompts, 0, pod_size=len(prompts))
        cascade, c_stats = _serve(wl, params, mesh, prompts, 0, pod_size=len(prompts),
                                  route="cascade")
        free, _ = _serve(wl, params, None, prompts, 0, pod_size=len(prompts))
    finally:
        t_base.stage_generator = t_stage.stage_generator = saved[0]
        t_diffusion.stage_noise = saved[1]
    st = c_stats["cascade"]["stages"]
    return {"pod": pod, "cascade": cascade, "mesh_free": free, "pod_mesh": pod_stats["mesh"],
            "cascade_mesh": c_stats["cascade"]["mesh"],
            "stage_batches": {n: s["batches"] for n, s in st.items()},
            "stage_order": list(st)}


def launchers(mesh) -> dict:
    """``launch/serve.py --mesh 2x2`` and ``launch/train.py --mesh debug
    --profile fsdp`` on this world; rank 0's report."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    from repro_torch.parallel import sharding as shlib

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_launcher.main(["--arch", "stable-diffusion", "--reduced", "--device", "cpu",
                             "--requests", "1", "--mesh", "2x2", "--route", "cascade"])
    logs: list = []
    ckpt = os.path.join(os.environ["REPRO_TORCH_MESH_TEST_DIR"], "train_launcher_ckpt")
    _, _, history = train_launcher.main(
        ["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--steps", "2", "--batch", "4",
         "--seq", "16", "--mesh", "debug", "--profile", "fsdp", "--ckpt-dir", ckpt],
        log=logs.append)
    shlib.set_profile("2d")
    return {"serve_stdout": buf.getvalue(), "train_history": history, "train_logs": logs}


# ---------------------------------------------------------------------------
# Training, checkpoints, compression
# ---------------------------------------------------------------------------


def _olmo(inputs):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.nn import materialize

    model = TransformerLM(reduced(get_config("olmo-1b")))
    # a copy: a train step updates the leaves in place
    return materialize(model, {k: v.clone() for k, v in inputs["olmo_state"].items()}, "cpu")


def train_step(mesh, inputs, profile: str) -> dict:
    """The loss and every leaf's gradient of one step on the mesh (the
    profile's rules) against the mesh-free step; then a whole
    ``make_train_step`` (AdamW) on both."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.nn import specs_of, trainable
    from repro_torch.parallel import sharding as shlib
    from repro_torch.parallel.mesh_exec import mesh_scope, shard_batch
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.trainer import accumulate_grads

    shlib.set_profile(profile)
    try:
        batch = {k: torch.as_tensor(v) for k, v in inputs["train_batch"].items()}
        free = _olmo(inputs)
        fp = trainable(free)
        f_loss, f_grads = accumulate_grads(lambda i, mb: free.loss(mb), fp, [batch])
        model = shlib.shard_params_tree(_olmo(inputs), specs_of(free), mesh)
        mp = trainable(model)
        with mesh_scope(mesh):
            m_loss, m_grads = accumulate_grads(lambda i, mb: model.loss(mb), mp,
                                               [shard_batch(batch, mesh)])
        grads = {k: (float((_whole(m_grads[k]) - g).abs().max()), float(g.abs().max()))
                 for k, g in f_grads.items()}
        placements = {k: [str(p) for p in v.placements] for k, v in mp.items()}
        # a whole step with AdamW, two microbatches
        f_step = make_train_step(free, free.cfg, microbatches=2, impl="auto")
        m_step = make_train_step(model, model.cfg, mesh, microbatches=2, impl="auto")
        _, _, f_met = f_step(fp, adamw_init(fp), batch)
        _, _, m_met = m_step(mp, adamw_init(mp), batch)
        params_err = max(float((_whole(mp[k]) - fp[k].detach()).abs().max()) for k in fp)
        return {"loss": (float(m_loss), float(f_loss)), "grads": grads,
                "placements": placements,
                "step_loss": (float(m_met["loss"]), float(f_met["loss"])),
                "grad_norm": (float(m_met["grad_norm"]), float(f_met["grad_norm"])),
                "params_err_after_step": params_err}
    finally:
        shlib.set_profile("2d")


def save_checkpoint(mesh, inputs, workdir) -> dict:
    """The FSDP-sharded leaves of reduced olmo-1b checkpointed from every
    rank (rank 0 writes)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.nn import specs_of, trainable
    from repro_torch.parallel import sharding as shlib

    model = _olmo(inputs)
    sharded = shlib.shard_params_tree(model, specs_of(model), mesh, shlib.FSDP_RULES)
    leaves = trainable(sharded)
    ck = Checkpointer(os.path.join(workdir, "ckpt"), async_save=True)
    ck.save(3, {"params": leaves})
    ck.wait()
    return {"placements": {k: [str(p) for p in v.placements] for k, v in leaves.items()},
            "local_numel": sum(v.to_local().numel() for v in leaves.values())}


def restore_checkpoint(mesh, inputs, workdir) -> dict:
    """The checkpoint written by the 4-rank world restored onto this one's
    mesh (``elastic_resume`` with its own FSDP shardings)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.steps import param_shardings
    from repro_torch.nn import trainable
    from repro_torch.parallel import sharding as shlib
    from repro_torch.runtime.fault_tolerance import elastic_resume

    shlib.set_profile("fsdp")
    try:
        model = _olmo(inputs)
        like = {"params": trainable(copy.deepcopy(model))}
        sh = {"params": param_shardings(model, mesh)}
        ck = Checkpointer(os.path.join(workdir, "ckpt"))
        state = elastic_resume(ck, like, sh)
        leaves = state["params"]
        return {"values": {k: _whole(v) for k, v in leaves.items()},
                "placements": {k: [str(p) for p in v.placements] for k, v in leaves.items()},
                "step": ck.latest_step()}
    finally:
        shlib.set_profile("2d")


def compression(rank: int) -> dict:
    """``cross_pod_allreduce_compressed`` over a (pod=2, data=1, model=1)
    mesh: each rank's own gradients and residuals, seeded by its rank."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.training.compression import cross_pod_allreduce_compressed

    mesh = init_device_mesh("cpu", (2, 1, 1), mesh_dim_names=("pod", "data", "model"))
    grads, error = _compression_inputs(rank)
    mean, new_error = cross_pod_allreduce_compressed(grads, error, mesh)
    return {"mean": mean, "residual": new_error}


def _compression_inputs(rank: int):
    rng = np.random.default_rng(100 + rank)
    grads = {"w": torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)),
             "b": torch.from_numpy((rng.standard_normal(16) * 1e-3).astype(np.float32))}
    error = {k: torch.from_numpy((rng.standard_normal(tuple(v.shape)) * 1e-2).astype(np.float32))
             for k, v in grads.items()}
    return grads, error


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def main(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    os.environ["REPRO_TORCH_MESH_TEST_DIR"] = workdir
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world, make_debug_mesh

    init_world("cpu", rank=rank, world_size=world, store_path=os.path.join(workdir, f"pg{world}"),
               timeout_s=PG_TIMEOUT_S)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out: dict = {}
    if world == 4:
        mesh = make_debug_mesh(2, 2, device="cpu")
        _checked(out, "dispatchers", dispatchers, mesh)
        _checked(out, "lm", serve_lm, mesh, inputs)
        _checked(out, "sd", serve_sd, mesh, inputs)
        for profile in ("2d", "fsdp"):
            _checked(out, f"train_{profile}", train_step, mesh, inputs, profile)
        _checked(out, "ckpt", save_checkpoint, mesh, inputs, workdir)
        _checked(out, "launchers", launchers, mesh)
    else:
        mesh = make_debug_mesh(1, 2, device="cpu")
        _checked(out, "restore", restore_checkpoint, mesh, inputs, workdir)
        _checked(out, "compression", compression, rank)
    torch.save(out, os.path.join(workdir, f"out{world}_{rank}.pt"))
    dist.barrier()
    # the results are on disk: leave without the interpreter's teardown, where
    # a process group's C++ threads sometimes end the process by abort
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
