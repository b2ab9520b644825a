"""The port's multi-GPU layer end to end on CPU gloo worlds, held against the
JAX reference's mesh-free outputs (the reference's own contract: its
outputs do not depend on the mesh).

Two worlds are spawned once each (``spawn``, a ``FileStore`` under the
module's temporary directory, one intra-op thread a rank, a 60 s process
group timeout): four ranks on a 2 x 2 (data, model) mesh, then two ranks
on a 1 x 2 mesh and a (pod = 2) mesh.  The ranks run
``tests/torch_mesh_ranks.py`` (no JAX) and write their results; each test
here reads one check.  The reference runs here, once: reduced olmo-1b's
greedy tokens and reduced Stable Diffusion's images on the seeded
parameters the ranks load, with the reference's own diffusion noise handed
to the port.  The four ranks also serve the eight suite models (Stable
Diffusion and Imagen on the pod and the cascade route) and every assigned
LM the LM workload serves at 1 and 3 requests, batches the data axis does
not divide, each held to one mesh-free run of 3 requests in the
same rank (a request's output does not depend on its batch), olmo-1b and
Stable Diffusion also to the reference's rows above.

Tolerances: greedy tokens equal; images within fp32 2e-5 of their scale;
losses and gradients within 1e-4 of their scale; restored checkpoints
bitwise; the compressed all-reduce to 1e-6 of the numpy oracle built from
the reference's ``_quantize_int8`` / ``_dequantize_int8``.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.suite  # noqa: F401  (registers the suite configs)
import torch_mesh_ranks
from jax.sharding import AbstractMesh as JAbstractMesh
from repro.configs import get_config as j_get_config
from repro.parallel import sharding as jsh
from repro.pipeline.stage import state_nbytes as j_state_nbytes
from repro.training import compression as j_compression
from repro.workload import workload_for as j_workload_for
from repro.workload.base import reduced_workload as j_reduced_workload
from repro.workload.base import stage_key as j_stage_key
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.suite import SUITE
from repro_torch.nn import init_params, trainable
from repro_torch.parallel.mesh_exec import stage_slice_plan
from repro_torch.pipeline.stage import mean_demand
from repro_torch.telemetry import schema
from repro_torch.workload import workload_for
from repro_torch.workload.base import reduced_workload

SD_STEPS = 2
OLMO_NEW = 4
JOIN_TIMEOUT_S = 600.0  # the 4-rank world runs ~140 s alone, longer beside other workers
FP32 = 2e-5
GRAD = 1e-4


def _jax_tree(abstract: dict, state: dict, path: str = "") -> dict:
    """The port's seeded values in the reference's tree (an empty subtree
    where a layer has no leaves: OLMo's norms)."""
    out = {}
    for k, v in abstract.items():
        key = f"{path}.{k}" if path else k
        out[k] = (_jax_tree(v, state, key) if isinstance(v, dict)
                  else jnp.asarray(state[key].numpy()))
    return out


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The inputs every rank loads, and the reference's mesh-free outputs."""
    workdir = str(tmp_path_factory.mktemp("mesh"))
    rng = np.random.default_rng(0)
    # reduced olmo-1b on the lm route: prompts exactly the bucket's width
    jo = j_reduced_workload(j_get_config("olmo-1b"))
    to = reduced_workload(get_config("olmo-1b"))
    olmo_state = init_params(to.model, 0)
    olmo_tokens = rng.integers(0, jo.cfg.vocab, (4, 16)).astype(np.int32)
    jparams = _jax_tree(jo.model.defs(), olmo_state)
    olmo_want = np.asarray(jo.generate(jparams, jnp.asarray(olmo_tokens), jax.random.PRNGKey(0),
                                       max_new_tokens=OLMO_NEW))
    report = jsh.shard_report(jparams, jo.model.specs(), JAbstractMesh((2, 2), ("data", "model")),
                              jsh.SERVE_TP_RULES)
    # reduced Stable Diffusion on its plain tier, the stages' output bytes
    js = j_reduced_workload(j_get_config("stable-diffusion"))
    js = j_workload_for(dataclasses.replace(js.cfg, denoise_steps=SD_STEPS))
    ts = reduced_workload(get_config("stable-diffusion"))
    ts = workload_for(dataclasses.replace(ts.cfg, denoise_steps=SD_STEPS))
    sd_state = init_params(ts.model, 0)
    sd_tokens = rng.integers(0, js.cfg.text.vocab, (4, js.cfg.text.max_len)).astype(np.int32)
    sparams = _jax_tree(js.model.defs(), sd_state)
    stage_bytes = []
    run_stage = js.run_stage

    def recording(*a, **kw):
        out = run_stage(*a, **kw)
        stage_bytes.append(j_state_nbytes(out))
        return out

    js.run_stage = recording
    sd_want = np.asarray(js.generate(sparams, jnp.asarray(sd_tokens), jax.random.PRNGKey(0),
                                     impl="naive"))
    hw, ch = js.cfg.latent_size, js.cfg.unet.in_channels
    sd_noise = {(0, r, 1): np.array(jax.random.normal(
        j_stage_key(jax.random.PRNGKey(0), r, 1), (hw, hw, ch), jnp.float32)) for r in range(4)}
    batch = {"tokens": rng.integers(0, jo.cfg.vocab, (4, 16)).astype(np.int32),
             "labels": rng.integers(0, jo.cfg.vocab, (4, 16)).astype(np.int32)}
    torch.save({"olmo_state": olmo_state, "olmo_tokens": olmo_tokens, "olmo_new": OLMO_NEW,
                "sd_state": sd_state, "sd_tokens": sd_tokens, "sd_noise": sd_noise,
                "sd_steps": SD_STEPS, "train_batch": batch},
               os.path.join(workdir, "inputs.pt"))
    return {"workdir": workdir, "olmo_want": olmo_want, "report": report, "sd_want": sd_want,
            "stage_bytes": stage_bytes, "stages": ts.cost_descriptor().stages,
            "olmo_state": olmo_state}


@pytest.fixture(scope="module")
def four(oracle):
    return torch_mesh_ranks.spawn(4, oracle["workdir"], JOIN_TIMEOUT_S)


@pytest.fixture(scope="module")
def two(oracle, four):
    del four  # restores the checkpoint the four ranks wrote
    return torch_mesh_ranks.spawn(2, oracle["workdir"], JOIN_TIMEOUT_S)


def _check(results: dict, name: str, rank: int = 0):
    got = results[rank][name]
    assert "error" not in got, got.get("error")
    return got


def _close(err: float, scale: float, tol: float, what: str):
    assert err <= tol * max(1.0, scale), f"{what}: {err:.3g} > {tol} x {scale:.3g}"


@pytest.mark.parametrize("case", [
    "attention_mha", "attention_gqa", "attention_gqa_grad", "temporal_attention",
    "conv2d_channel_tp", "conv2d_stride2", "conv2d_grad", "temporal_conv1d",
    "groupnorm_silu_g4", "groupnorm_silu_g1"])
def test_dispatchers_on_shards_match_their_plain_version(four, case):
    res = _check(four, "dispatchers")[case]
    _close(res["err"], res["scale"], GRAD if case.endswith("grad") else FP32, case)
    if case == "conv2d_channel_tp":
        _close(res["stats_err"], res["stats_scale"], FP32, "stats")
        assert res["out_placements"] == ["S(0)", "S(3)"]
    if case == "groupnorm_silu_g4":  # whole groups a shard: the channels stay sharded
        assert res["out_placements"] == ["S(0)", "S(2)"]
    if case == "groupnorm_silu_g1":  # one group: gathered over the channels
        assert res["out_placements"] == ["S(0)", "R"]


@pytest.mark.parametrize("case", [
    f"{name}_b3_{lay}" for lay in ("uneven", "replicated")
    for name in ("attention", "temporal_attention", "conv2d", "temporal_conv1d", "groupnorm_silu")])
def test_dispatchers_take_a_batch_the_data_axis_does_not_divide(four, case):
    res = _check(four, "dispatchers")[case]
    _close(res["err"], res["scale"], FP32, case)


def test_gqa_group_axis_split_is_needed(four):
    """A flat head split would send local heads to the wrong KV head: the
    GQA case above is one where it changes the output."""
    assert _check(four, "dispatchers")["attention_gqa_flat_split_err"] > 0.1


def test_lm_route_tokens_equal_the_reference(four, oracle):
    res = _check(four, "lm")
    got = torch.stack([res["tokens"][r] for r in range(4)]).numpy()
    np.testing.assert_array_equal(got, oracle["olmo_want"])
    np.testing.assert_array_equal(
        torch.stack([res["mesh_free"][r] for r in range(4)]).numpy(), oracle["olmo_want"])


def test_lm_route_mesh_stats_are_the_references_report(four, oracle):
    mesh = _check(four, "lm")["mesh"]
    assert mesh["axes"] == {"data": 2, "model": 2} and mesh["devices"] == 4
    params = dict(mesh["params"])
    assert params.pop("replication_fallbacks") >= 0
    assert params == oracle["report"]
    c = schema._Ctx()  # the schema's mesh block (the ranks validated the whole stats)
    schema._validate_mesh(c, mesh, "stats.mesh")
    assert not c.errors


@pytest.mark.parametrize("route", ["pod", "cascade"])
def test_sd_routes_match_the_reference(four, oracle, route):
    res = _check(four, "sd")
    want = oracle["sd_want"]
    for outs, what in ((res[route], route), (res["mesh_free"], "mesh-free")):
        got = torch.stack([outs[r] for r in range(4)]).numpy()
        _close(float(np.abs(got - want).max()), float(np.abs(want).max()), FP32, what)


def test_cascade_reshards_are_counted_as_the_reference(four, oracle):
    """One event a handoff between different rank slices, the states'
    bytes (the reference's ``state_nbytes``) as payload."""
    res = _check(four, "sd")
    stages = oracle["stages"]
    plan = stage_slice_plan([mean_demand(s) for s in stages], 4)
    assert res["stage_order"] == [s.name for s in stages]
    events = nbytes = 0
    for i in range(len(stages) - 1):
        if plan[i][:2] != plan[i + 1][:2]:
            events += res["stage_batches"][stages[i].name]
            nbytes += oracle["stage_bytes"][i]
    cm = res["cascade_mesh"]
    assert (cm["reshard_events"], cm["reshard_bytes"]) == (events, nbytes)
    assert events > 0
    assert cm["stage_devices"] == {s.name: e[1] for s, e in zip(stages, plan)}


@pytest.mark.parametrize("profile", ["2d", "fsdp"])
def test_train_step_matches_the_mesh_free_step(four, profile):
    res = _check(four, f"train_{profile}")
    m, f = res["loss"]
    _close(abs(m - f), abs(f), GRAD, "loss")
    for key, (err, scale) in res["grads"].items():
        _close(err, scale, GRAD, key)
    _close(abs(res["step_loss"][0] - res["step_loss"][1]), abs(res["step_loss"][1]), GRAD, "step")
    _close(abs(res["grad_norm"][0] - res["grad_norm"][1]), res["grad_norm"][1], GRAD, "norm")
    assert res["params_err_after_step"] <= GRAD
    sharded = [k for k, p in res["placements"].items() if any("S(" in s for s in p)]
    assert sharded, "no leaf is sharded"


def test_ssm_train_step_matches_the_mesh_free_step(four):
    """Reduced mamba2-780m: softplus's backward runs on DTensor."""
    res = _check(four, "train_mamba2")
    m, f = res["loss"]
    _close(abs(m - f), abs(f), GRAD, "loss")
    for key, (err, scale) in res["grads"].items():
        _close(err, scale, GRAD, key)
    assert any("S(" in s for p in res["placements"].values() for s in p), "no leaf is sharded"


def test_coverage_is_the_suite_and_every_servable_assigned_lm():
    assert sorted(torch_mesh_ranks.COVER_SUITE) == sorted(SUITE)
    assert sorted(torch_mesh_ranks.COVER_LMS) == sorted(set(ASSIGNED_ARCHS) - {"whisper-base"})
    assert all(n % 2 for n in torch_mesh_ranks.COVER_BATCHES)  # the data axis is 2
    assert torch_mesh_ranks.COVER_FP32 == FP32 and torch_mesh_ranks.COVER_STEPS == SD_STEPS


COVER = torch_mesh_ranks.cover_cases()


@pytest.mark.parametrize("arch,route,n", COVER, ids=[f"{a}-{r}-{n}" for a, r, n in COVER])
def test_every_model_serves_batches_the_data_axis_does_not_divide(four, oracle, arch, route, n):
    """A stage batch of 1 or 3 on the 2 x 2 mesh gives each request the
    output the mesh-free engine gives it in a batch of 3 (tokens equal,
    images within fp32), on every rank; olmo-1b and Stable Diffusion also
    the reference's."""
    got = torch.stack(torch_mesh_ranks.check_coverage(four, arch, route, n)).numpy()
    if arch == "olmo-1b":
        np.testing.assert_array_equal(got, oracle["olmo_want"][:n, :torch_mesh_ranks.COVER_NEW])
    if arch == "stable-diffusion":
        want = oracle["sd_want"][:n]
        _close(float(np.abs(got - want).max()), float(np.abs(want).max()), FP32, "reference")


def test_launchers_serve_and_train_on_the_mesh(four):
    res = _check(four, "launchers")
    out = res["serve_stdout"]
    assert "mesh {'data': 2, 'model': 2} (4 devices) | TP coverage" in out
    assert "stage meshes:" in out and "reshards" in out
    assert len(res["train_history"]) == 2 and np.all(np.isfinite(res["train_history"]))
    assert res["train_logs"][-1].startswith("final loss")


def test_every_rank_holds_the_same_outputs(four):
    for r in (1, 2, 3):
        for route in ("pod", "cascade"):
            for rid in range(4):
                assert torch.equal(four[r]["sd"][route][rid], four[0]["sd"][route][rid])
        for rid in range(4):
            assert torch.equal(four[r]["lm"]["tokens"][rid], four[0]["lm"]["tokens"][rid])
    assert four[1]["launchers"]["serve_stdout"] == ""  # rank 0 alone reports


def test_checkpoint_from_four_ranks_restores_on_two_bitwise(four, two, oracle):
    saved = _check(four, "ckpt")
    assert any("S(" in s for p in saved["placements"].values() for s in p)
    res = _check(two, "restore")
    assert res["step"] == 3
    ck = Checkpointer(os.path.join(oracle["workdir"], "ckpt"))
    like = {"params": {k: torch.zeros(v.shape, dtype=v.dtype)
                       for k, v in oracle["olmo_state"].items()}}
    written = ck.restore(like)["params"]
    assert set(res["values"]) == set(written)
    for k, v in written.items():
        assert torch.equal(res["values"][k], v), k
        assert torch.equal(v, oracle["olmo_state"][k]), k
    assert any("S(" in s for p in res["placements"].values() for s in p)
    for r in (0, 1):
        assert all(torch.equal(two[r]["restore"]["values"][k], written[k]) for k in written)


def test_cross_pod_allreduce_compressed_matches_the_reference(two):
    """Summed int8 codes, the largest scale, divided by the pod count, and
    each pod's own residual, as the reference's shard_map body."""
    ins = [torch_mesh_ranks._compression_inputs(r) for r in (0, 1)]
    for key in ins[0][0]:
        targets = [np.asarray(g[key].numpy() + e[key].numpy(), np.float32) for g, e in ins]
        qs = [j_compression._quantize_int8(jnp.asarray(t)) for t in targets]
        total = sum(np.asarray(q, np.int32) for q, _ in qs)
        scale_max = max(float(s) for _, s in qs)
        mean = total.astype(np.float32) * np.float32(scale_max) / 2
        for r in (0, 1):
            got = _check(two, "compression", r)
            np.testing.assert_allclose(got["mean"][key].numpy(), mean, rtol=1e-6, atol=1e-7)
            resid = targets[r] - np.asarray(j_compression._dequantize_int8(*qs[r]))
            np.testing.assert_allclose(got["residual"][key].numpy(), resid, rtol=1e-6, atol=1e-7)


def test_trainable_leaves_of_a_mesh_free_model_stay_plain(oracle):
    """Mesh-free, nothing changes: the leaves are plain tensors."""
    model = reduced_workload(get_config("olmo-1b")).load(oracle["olmo_state"], "cpu")
    assert all(type(p) is torch.nn.Parameter and not hasattr(p, "placements")
               for p in trainable(model).values())
