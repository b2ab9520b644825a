"""The rank bodies of ``tests/test_torch_mesh.py``: every rank of a CPU gloo
world runs :func:`main` (SPMD), imports no JAX, and writes its results to
``out<world>_<rank>.pt`` in the test's directory; :func:`spawn` starts a
world and reads them.

The parent test writes the inputs (``inputs.pt``: seeded parameters, the
prompts, the reference's diffusion noise) and holds the results against
the JAX reference.  ``tests/test_torch_cuda.py`` runs the coverage alone on
seeded models under the torch installed beside the card.  Each check
catches its own exception and records it, so one failing check reports
instead of hanging the other ranks; a rank that hangs in a collective fails
at the process group's timeout.
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

        # a batch of 3 over the data axis of 2: unevenly sharded (DTensor's
        # own propagation hands one over) and replicated
        B = 3
        q, k, v = rand(B, 16, 4, 8), rand(B, 16, 4, 8), rand(B, 16, 4, 8)
        q5, k5, v5 = rand(B, 5, 6, 4, 8), rand(B, 5, 6, 4, 8), rand(B, 5, 6, 4, 8)
        x, w = rand(B, 8, 8, 8), rand(3, 3, 8, 8) * 0.2
        xt, wt, bt = rand(B, 5, 4, 4, 8), rand(3, 8, 8) * 0.3, rand(8)
        x3, sc, bi = rand(B, 16, 8), rand(8), rand(8)
        for lay, d0 in (("uneven", S0), ("replicated", R)):
            cases = {
                "attention": (attn_ref.attention_ref(q, k, v, causal=True, scale=8 ** -0.5),
                              lambda: attn_ops.attention(
                                  *(_placed(t, mesh, [d0, S2]) for t in (q, k, v)),
                                  causal=True, impl="auto")),
                "temporal_attention": (attn_ref.temporal_attention_ref(q5, k5, v5,
                                                                       scale=8 ** -0.5),
                                       lambda: attn_ops.temporal_attention(
                                           *(_placed(t, mesh, [d0, S3]) for t in (q5, k5, v5)),
                                           impl="auto")),
                "conv2d": (conv_ref.conv2d_ref(x, w),
                           lambda: conv_ops.conv2d(_placed(x, mesh, [d0, R]),
                                                   _placed(w, mesh, [R, S3]), impl="auto")),
                "temporal_conv1d": (conv_ref.temporal_conv1d_ref(xt, wt, bt),
                                    lambda: conv_ops.temporal_conv1d(
                                        _placed(xt, mesh, [d0, R]), _placed(wt, mesh, [R, S2]),
                                        _placed(bt, mesh, [R, S0]), impl="auto")),
                "groupnorm_silu": (gn_ref.groupnorm_silu_onepass_ref(x3, sc, bi, groups=4,
                                                                     silu=True),
                                   lambda: gn_ops.groupnorm_silu(
                                       _placed(x3, mesh, [d0, S2]), _placed(sc, mesh, [R, S0]),
                                       _placed(bi, mesh, [R, S0]), groups=4, impl="auto")),
            }
            for name, (want, call) in cases.items():
                res[f"{name}_b3_{lay}"] = {"err": err(call(), want),
                                           "scale": float(want.abs().max())}
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


@contextlib.contextmanager
def _reference_draws(inputs):
    """Stable Diffusion's latent noise from the reference's draws
    (``inputs["sd_noise"]``) for the duration of the block."""
    from repro_torch.pipeline import stage as t_stage
    from repro_torch.workload import base as t_base
    from repro_torch.workload import diffusion as t_diffusion

    saved = t_base.stage_generator, t_diffusion.stage_noise
    t_base.stage_generator = t_stage.stage_generator = _StageKey
    t_diffusion.stage_noise = _reference_noise(inputs["sd_noise"])
    try:
        yield
    finally:
        t_base.stage_generator = t_stage.stage_generator = saved[0]
        t_diffusion.stage_noise = saved[1]


def _sd(inputs):
    from repro_torch.configs import get_config
    from repro_torch.workload import workload_for
    from repro_torch.workload.base import reduced_workload

    wl = reduced_workload(get_config("stable-diffusion"))
    wl = workload_for(dataclasses.replace(wl.cfg, denoise_steps=inputs["sd_steps"]))
    return wl, wl.load(inputs["sd_state"], "cpu")


def serve_sd(mesh, inputs) -> dict:
    wl, params = _sd(inputs)
    prompts = inputs["sd_tokens"]
    with _reference_draws(inputs):
        pod, pod_stats = _serve(wl, params, mesh, prompts, 0, pod_size=len(prompts))
        cascade, c_stats = _serve(wl, params, mesh, prompts, 0, pod_size=len(prompts),
                                  route="cascade")
        free, _ = _serve(wl, params, None, prompts, 0, pod_size=len(prompts))
    st = c_stats["cascade"]["stages"]
    return {"pod": pod, "cascade": cascade, "mesh_free": free, "pod_mesh": pod_stats["mesh"],
            "cascade_mesh": c_stats["cascade"]["mesh"],
            "stage_batches": {n: s["batches"] for n, s in st.items()},
            "stage_order": list(st)}


# The eight suite models on the pod or lm route (Stable Diffusion and Imagen
# also on the cascade route, where each stage runs on its own slice of the
# ranks) and every assigned LM the LM workload serves (whisper-base's stages
# carry no frame embeddings, as the reference's), each served at stage
# batches the 2 x 2 mesh's data axis does not divide.
COVER_SUITE = ("stable-diffusion", "imagen", "muse", "parti", "prod-image", "make-a-video",
               "phenaki", "llama2-7b")
COVER_LMS = ("olmo-1b", "stablelm-3b", "glm4-9b", "qwen2-72b", "deepseek-moe-16b",
             "qwen3-moe-30b-a3b", "mamba2-780m", "recurrentgemma-9b", "qwen2-vl-2b")
COVER_CASCADE = ("stable-diffusion", "imagen")
COVER_BATCHES = (1, 3)
COVER_NEW = 2  # decode tokens a request
COVER_STEPS = 2  # denoise steps
# every prompt exactly one bucket wide, so every route and batch pads it
# alike (the reference's routes agree only then, as its route-parity tests)
COVER_LEN = 16
COVER_FP32 = 2e-5  # an image's error, of its scale


def cover_routes(arch: str) -> tuple:
    return ("auto", "cascade") if arch in COVER_CASCADE else ("auto",)


def cover_cases() -> list:
    """Every (model, route, requests) the coverage serves."""
    return [(arch, route, n) for arch in COVER_SUITE + COVER_LMS for route in cover_routes(arch)
            for n in COVER_BATCHES]


def _cover_case(inputs, arch: str):
    """One coverage model: its workload (``COVER_STEPS`` denoise steps),
    parameters and 3 prompts of ``COVER_LEN`` tokens.  Where ``inputs`` holds
    them, Stable Diffusion and olmo-1b take the parameters and prompts the
    reference's outputs were computed from; everything else is seeded
    here."""
    from repro_torch.configs import get_config
    from repro_torch.workload import workload_for
    from repro_torch.workload.base import reduced_workload

    if arch == "stable-diffusion" and "sd_state" in inputs:
        wl, params = _sd(inputs)
        return wl, params, list(inputs["sd_tokens"][:3])
    wl = reduced_workload(get_config(arch))
    if arch == "olmo-1b" and "olmo_state" in inputs:
        return wl, wl.load(inputs["olmo_state"], "cpu"), list(inputs["olmo_tokens"][:3])
    if hasattr(wl.cfg, "denoise_steps"):
        wl = workload_for(dataclasses.replace(wl.cfg, denoise_steps=COVER_STEPS))
    rng = np.random.default_rng(0)
    return wl, wl.init(0, "cpu"), [rng.integers(0, wl.prompt_vocab, COVER_LEN) for _ in range(3)]


def _cover(mesh, inputs, arch: str) -> dict:
    """``arch`` served on the mesh at each of ``COVER_BATCHES`` requests on
    each of its routes, and on rank 0 once mesh-free at 3 requests (the
    oracle :func:`check_coverage` holds rank 0's runs to; every rank's runs
    are held to rank 0's)."""
    import torch.distributed as dist

    wl, params, prompts = _cover_case(inputs, arch)
    assert all(len(p) == COVER_LEN for p in prompts)
    draws = (_reference_draws(inputs) if arch == "stable-diffusion" and "sd_noise" in inputs
             else contextlib.nullcontext())
    runs, free = {}, None
    with draws:
        if dist.get_rank() == 0:
            free, _ = _serve(wl, params, None, prompts, COVER_NEW, buckets=(COVER_LEN,))
        for route in cover_routes(arch):
            for n in COVER_BATCHES:
                runs[f"{route}/{n}"], _ = _serve(wl, params, mesh, prompts[:n], COVER_NEW,
                                                 route=route, buckets=(COVER_LEN,))
    return {"free": free, "runs": runs}


def coverage(mesh, inputs) -> dict:
    out: dict = {}
    for arch in COVER_SUITE + COVER_LMS:
        _checked(out, arch, _cover, mesh, inputs, arch)
    return out


def check_coverage(results: dict, arch: str, route: str, n: int) -> list:
    """Rank 0's outputs of ``arch`` served on the mesh at ``n`` requests on
    ``route``, by request, each held to rank 0's mesh-free run (tokens
    equal, images within ``COVER_FP32`` of their scale) and to every other
    rank's; ``results`` is every rank's :func:`main` output."""
    runs = []
    for rank in sorted(results):
        res = results[rank]["coverage"][arch]
        assert "error" not in res, res.get("error")
        runs.append(res["runs"][f"{route}/{n}"])
    free = results[0]["coverage"][arch]["free"]
    assert sorted(runs[0]) == list(range(n))
    for rid in range(n):
        got, want = runs[0][rid], free[rid]
        if want.is_floating_point():
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            assert err <= COVER_FP32 * max(1.0, scale), f"rid {rid}: {err:.3g} of {scale:.3g}"
        else:
            assert torch.equal(got, want), rid
        assert all(torch.equal(r[rid], got) for r in runs[1:]), rid
    return [runs[0][rid] for rid in range(n)]


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


def _olmo(inputs, arch: str = "olmo-1b"):
    """Reduced olmo-1b on the reference's seeded values, or another reduced
    LM seeded here."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.nn import init_params, materialize

    model = TransformerLM(reduced(get_config(arch)))
    state = inputs["olmo_state"] if arch == "olmo-1b" else init_params(model, 0)
    # a copy: a train step updates the leaves in place
    return materialize(model, {k: v.clone() for k, v in state.items()}, "cpu")


def train_step(mesh, inputs, profile: str, arch: str = "olmo-1b") -> dict:
    """The loss and every leaf's gradient of one step on the mesh (the
    profile's rules) against the mesh-free step; then, for olmo-1b, a whole
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
        free = _olmo(inputs, arch)
        fp = trainable(free)
        f_loss, f_grads = accumulate_grads(lambda i, mb: free.loss(mb), fp, [batch])
        model = shlib.shard_params_tree(_olmo(inputs, arch), specs_of(free), mesh)
        mp = trainable(model)
        with mesh_scope(mesh):
            m_loss, m_grads = accumulate_grads(lambda i, mb: model.loss(mb), mp,
                                               [shard_batch(batch, mesh)])
        grads = {k: (float((_whole(m_grads[k]) - g).abs().max()), float(g.abs().max()))
                 for k, g in f_grads.items()}
        placements = {k: [str(p) for p in v.placements] for k, v in mp.items()}
        if arch != "olmo-1b":
            return {"loss": (float(m_loss), float(f_loss)), "grads": grads,
                    "placements": placements}
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


def main(rank: int, world: int, workdir: str, only: tuple | None = None) -> None:
    """Rank ``rank`` of a world of ``world``: every check of that world, or
    those named in ``only``.  The coverage alone needs no reference inputs
    (``inputs.pt`` may be an empty dict): it seeds every model."""
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    os.environ["REPRO_TORCH_MESH_TEST_DIR"] = workdir
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world, make_debug_mesh

    init_world("cpu", rank=rank, world_size=world, store_path=os.path.join(workdir, f"pg{world}"),
               timeout_s=PG_TIMEOUT_S)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    if world == 4:
        mesh = make_debug_mesh(2, 2, device="cpu")
        checks = [("dispatchers", dispatchers, mesh), ("lm", serve_lm, mesh, inputs),
                  ("sd", serve_sd, mesh, inputs), ("coverage", coverage, mesh, inputs)]
        checks += [(f"train_{profile}", train_step, mesh, inputs, profile)
                   for profile in ("2d", "fsdp")]
        # softplus's backward on DTensor (the SSM's dt gate)
        checks += [("train_mamba2", train_step, mesh, inputs, "2d", "mamba2-780m"),
                   ("ckpt", save_checkpoint, mesh, inputs, workdir),
                   ("launchers", launchers, mesh)]
    else:
        mesh = make_debug_mesh(1, 2, device="cpu")
        checks = [("restore", restore_checkpoint, mesh, inputs, workdir),
                  ("compression", compression, rank)]
    out: dict = {}
    for name, fn, *args in checks:
        if only is None or name in only:
            _checked(out, name, fn, *args)
    torch.save(out, os.path.join(workdir, f"out{world}_{rank}.pt"))
    dist.barrier()
    # the results are on disk: leave without the interpreter's teardown, where
    # a process group's C++ threads sometimes end the process by abort
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def spawn(world: int, workdir: str, join_timeout_s: float, only: tuple | None = None) -> dict:
    """Run ``world`` ranks of :func:`main` over ``workdir`` (which holds
    ``inputs.pt``); their results by rank.  A rank still alive at the join
    timeout is killed and fails."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=main, args=(r, world, workdir, only)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(join_timeout_s)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} of a world of {world} hung"
    assert [p.exitcode for p in procs] == [0] * world, [p.exitcode for p in procs]
    return {r: torch.load(os.path.join(workdir, f"out{world}_{r}.pt"), weights_only=False)
            for r in range(world)}
