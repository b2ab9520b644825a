"""The port's compiled-program analyses (``repro_torch.core.{hlo_analysis,
roofline}``, ``repro_torch.launch.{dryrun,hillclimb,report}``) against the
reference's (``repro.core``, ``repro.launch``).

Four processes run side by side from one module fixture (a JAX host-device
count and a process group are fixed for the life of a process):
``tests/torch_dryrun_worlds.py jax`` (the reference's dry-run lowering a
tiny olmo-1b on an 8-device Auto-axes (4, 2) mesh), ``... torch`` (the port
counting the same steps on an 8-rank fake world), ``... torch_ssm`` (the
port's reduced sub-quadratic LMs' train steps on the same world) and the
port's dry-run CLI on a production cell (a 256-rank fake world).

Tolerances: every comparison is exact but one, the per-rank flops, which
the port counts for matmul-class ops only while XLA's ``cost_analysis``
counts every op; on the tiny steps the port's count is 0.735 (prefill),
0.935 (decode) and 0.790 (train) of XLA's, held to the band [0.7, 1.0].
The reference's output bytes include XLA's result-tuple index table, 8
bytes a result leaf, which the port has no counterpart of; the port counts
a host scalar (the decode position, the learning rate) as the 4-byte
scalar the reference's jitted step passes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.core import roofline as j_roofline
from repro.core.perf_model import TPU_V5E as J_TPU_V5E
from repro.launch import mesh as j_mesh
from repro.launch import report as j_report
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core import roofline
from repro_torch.core.perf_model import TPU_V5E
from repro_torch.launch import dryrun, report
from repro_torch.launch import mesh as t_mesh

ROOT = Path(__file__).resolve().parents[1]
WORLDS = ROOT / "tests" / "torch_dryrun_worlds.py"
KINDS = ("prefill", "decode", "train")
FLOPS_BAND = (0.7, 1.0)  # the port's matmul flops over XLA's flops of every op
CLI_CELL = ("olmo-1b", "decode_32k")  # a production cell the CLI dispatches in ~10 s
TUPLE_ENTRY = 8  # bytes of XLA's result-tuple index table a leaf


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's tiny counts and the CLI's record, from
    four processes run side by side."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = {k: tmp / f"{k}.json" for k in ("jax", "torch", "torch_ssm", "cli")}
    cmds = {
        **{k: [sys.executable, str(WORLDS), k, str(out[k])] for k in ("jax", "torch", "torch_ssm")},
        "cli": [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", CLI_CELL[0],
                "--shape", CLI_CELL[1], "--single-pod-only", "--out", str(out["cli"])],
    }
    # the reference's 8 host devices; the CLI's world takes the default 512
    # ranks (an operator-set count would size it, as the reference's)
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                   os.environ.get("XLA_FLAGS", "")).strip()
    envs = {"jax": dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8"),
            "torch": env, "torch_ssm": env, "cli": dict(env, XLA_FLAGS=flags)}
    procs = {k: subprocess.Popen(c, cwd=ROOT, env=envs[k], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for k, c in cmds.items()}
    logs = {}
    try:
        for k, p in procs.items():
            logs[k] = p.communicate(timeout=300)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for k, p in procs.items():
        assert p.returncode == 0, f"{k}: {logs[k][-3000:]}"
    res = {k: json.loads(v.read_text()) for k, v in out.items()}
    res["cli_path"] = out["cli"]
    res["cli_log"] = logs["cli"]
    return res


# ---------------------------------------------------------------------------
# Pure helpers: configs, the fake-device count, microbatches, the playbook
# ---------------------------------------------------------------------------

COUNT_CASES = ("existing_count_wins", "other_flags_kept", "no_flags", "override")


@pytest.mark.parametrize("case", COUNT_CASES)
@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_ensure_host_device_count_keeps_the_reference_contract(monkeypatch, pkg, case):
    """The reference's cases (``tests/test_sharding.py``), run on both
    packages' copies: an operator-set count wins; absent one, the flag is
    appended; ``respect_env=False`` overrides."""
    ensure = (j_mesh if pkg == "repro" else t_mesh).ensure_host_device_count
    flag = "--xla_force_host_platform_device_count"
    if case == "existing_count_wins":
        monkeypatch.setenv("XLA_FLAGS", f"{flag}=16")
        assert ensure(512) == 16
        assert "=16" in os.environ["XLA_FLAGS"]
    elif case == "other_flags_kept":
        monkeypatch.setenv("XLA_FLAGS", "--some_other_flag")
        assert ensure(512) == 512
        assert "--some_other_flag" in os.environ["XLA_FLAGS"]
        assert f"{flag}=512" in os.environ["XLA_FLAGS"]
    elif case == "no_flags":
        monkeypatch.delenv("XLA_FLAGS", raising=False)
        assert ensure(8) == 8
        assert os.environ["XLA_FLAGS"] == f"{flag}=8"
    else:
        monkeypatch.setenv("XLA_FLAGS", f"{flag}=16")
        assert ensure(512, respect_env=False) == 512
        assert "=512" in os.environ["XLA_FLAGS"]


def test_assigned_archs_are_the_references():
    assert ASSIGNED_ARCHS == J_ARCHS
    assert list(SHAPES) == list(J_SHAPES)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_lm_config_members_match_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert cfg.homogeneous == jcfg.homogeneous
    assert cfg.sub_quadratic == jcfg.sub_quadratic
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.param_count() == jcfg.param_count()
    for name in SHAPES:
        assert cfg.supports_shape(SHAPES[name]) == jcfg.supports_shape(J_SHAPES[name]), name


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_for_matches_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name in SHAPES:
        assert roofline.model_flops_for(cfg, SHAPES[name]) == j_roofline.model_flops_for(
            jcfg, J_SHAPES[name]), name


def test_default_microbatches_match_the_reference(runs):
    """On (16, 16) and (2, 16, 16) abstract meshes, under both profiles."""
    assert runs["torch"]["microbatches"] == runs["jax"]["microbatches"]
    assert runs["torch"]["microbatches"]["pod16x16/2d"]["train_4k"] == 16


def test_shallow_pairs_and_configs_match_the_reference(runs):
    assert runs["torch"]["shallow"] == runs["jax"]["shallow"]


def test_playbook_matches_the_reference(runs):
    from repro_torch.launch.hillclimb import OUT, PLAYBOOK

    assert json.loads(json.dumps(PLAYBOOK)) == runs["jax"]["playbook"]
    assert OUT == "results/torch_hillclimb.json"


def test_long_500k_skip_record_matches_the_reference(runs):
    """A full-attention arch at a 524288-position decode is skipped, on
    both meshes, with the reference's record (no mesh is built)."""
    recs = [dryrun.lower_cell("olmo-1b", "long_500k", multi_pod=mp, verbose=False)
            for mp in (False, True)]
    assert recs == runs["jax"]["skips"]
    assert all(r["status"] == "skipped" for r in recs)


# ---------------------------------------------------------------------------
# The roofline report and its rendering
# ---------------------------------------------------------------------------

REPORT = dict(arch="olmo-1b", shape="train_4k", mesh="pod16x16", n_chips=256,
              hlo_flops=1.5e14, hlo_bytes=8.5e12, collective_bytes=1.8e11,
              peak_memory_bytes=3.4e10, compute_s=0.76, memory_s=10.4, collective_s=3.6,
              model_flops=7.4e15, useful_ratio=0.19,
              collectives={"bytes_by_type": {"all-gather": 4e10}, "count_by_type": {
                  "all-gather": 5474}})


def test_roofline_report_to_dict_matches_the_reference_on_tpu_v5e():
    mine = roofline.RooflineReport(**REPORT, hw=TPU_V5E)
    ref = j_roofline.RooflineReport(**REPORT)
    assert TPU_V5E.peak_flops == J_TPU_V5E.peak_flops
    assert mine.to_dict() == ref.to_dict()
    assert mine.dominant == "memory" and mine.step_time_s == 10.4


def test_roofline_report_rates_the_card_it_carries():
    """The default card is the H100 (bf16); set_terms derives every term."""
    rep = roofline.RooflineReport(**REPORT)
    assert rep.hw.name == "h100-sxm-bf16"
    rep.set_terms(989e12, 3.35e12, 450e9)
    assert (rep.compute_s, rep.memory_s, rep.collective_s) == (1.0, 1.0, 1.0)
    assert rep.roofline_fraction == pytest.approx(7.4e15 / 256 / 989e12, rel=1e-12)
    assert "hw" not in rep.to_dict()


def _record(arch, shape, mesh, **kw):
    rep = roofline.RooflineReport(**dict(REPORT, arch=arch, shape=shape, mesh=mesh))
    rec = dict(arch=arch, shape=shape, mesh=mesh, impl="blocked_jax", remat="full",
               profile="2d", status="ok", microbatches=16, compile_s=58.0,
               memory={"total_bytes": 3.4e10}, flops=1.5e14, collective_wire_bytes=1.8e11,
               collectives={"all-gather": 5474, "all-reduce": 2880}, roofline=rep.to_dict())
    rec.update(kw)
    return rec


def test_report_renders_the_same_text_as_the_reference():
    records = [
        _record("olmo-1b", "train_4k", "pod16x16", depth_correction={"flops": 1.5e14}),
        _record("olmo-1b", "train_4k", "pod2x16x16"),
        _record("glm4-9b", "prefill_32k", "pod16x16", remat="dots"),
        dict(arch="olmo-1b", shape="long_500k", mesh="pod16x16", status="skipped",
             reason="full-attention arch at 500k (sub-quadratic required)"),
        dict(arch="whisper-base", shape="decode_32k", mesh="pod16x16", status="error",
             error="RuntimeError: x"),
    ]
    for kw in ({}, dict(remat="dots"), dict(profile="fsdp")):
        assert report.render(records, **kw) == j_report.render(records, **kw)
    assert report.fmt_bytes(3 * 2**30) == j_report.fmt_bytes(3 * 2**30)
    for s in (2.5, 0.0123, 4e-5):
        assert report.fmt_s(s) == j_report.fmt_s(s)


# ---------------------------------------------------------------------------
# The tiny steps on a (4, 2) mesh against the reference's compiled programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_tiny_step_argument_and_output_bytes_match_the_reference(runs, kind):
    """Per-rank local bytes of the step's arguments and results, exact; the
    reference's results less its tuple table.  Alias: the decode writes the
    cache in place in both; the train step writes parameters and moments in
    place, its step counter a new scalar (the reference donates it too)."""
    mine, ref = runs["torch"]["steps"][kind]["memory"], runs["jax"]["steps"][kind]
    assert mine["argument_size_in_bytes"] == ref["memory"]["argument_size_in_bytes"]
    assert mine["output_size_in_bytes"] == (ref["memory"]["output_size_in_bytes"]
                                            - TUPLE_ENTRY * ref["output_leaves"])
    alias = ref["memory"]["alias_size_in_bytes"] - (4 if kind == "train" else 0)
    assert mine["alias_size_in_bytes"] == alias
    assert mine["generated_code_size_in_bytes"] == 0
    assert mine["total_bytes"] == (mine["argument_size_in_bytes"] + mine["output_size_in_bytes"]
                                   + mine["temp_size_in_bytes"] - mine["alias_size_in_bytes"])


@pytest.mark.parametrize("kind", KINDS)
def test_tiny_step_flops_are_within_the_band_of_xlas(runs, kind):
    ratio = runs["torch"]["steps"][kind]["flops"] / runs["jax"]["steps"][kind]["flops"]
    assert FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1], ratio


def test_mesh_free_prefill_flops_equal_a_hand_count_of_the_matmuls(runs):
    """Tiny olmo-1b (2 layers, d 64, 4 heads of 16, d_ff 128, vocab 256,
    tied head), prefill of 2 x 16 tokens on ``meta``: the four projections
    and the gated MLP's three products over every token, the plain
    attention's full QK^T and PV over every (query, key) pair, the head on
    the last position."""
    L, d, H, D, f, V = 2, 64, 4, 16, 128, 256
    B, S = 2, 16
    T = B * S
    per_layer = 4 * 2 * T * d * (H * D) + 3 * 2 * T * d * f + 2 * (2 * B * H * S * S * D)
    assert runs["torch"]["free_prefill"]["flops"] == L * per_layer + 2 * B * d * V
    assert not runs["torch"]["free_prefill"]["collectives"]


def test_column_then_row_parallel_mlp_collectives_equal_a_hand_count(runs):
    """x (8, 16, 64) over data (4), W1 (64, 128) and W2 (128, 64) split on
    the 128 over model (2): each rank multiplies its (2, 16, 64) rows by its
    halves, then one all-reduce over model of its (2, 16, 64) fp32 partial
    sums makes the output replicated there (wire: twice the bytes)."""
    mlp = runs["torch"]["mlp"]
    rows, d, f = 2 * 16, 64, 128
    assert mlp["flops"] == 2 * (2 * rows * d * (f // 2))
    assert mlp["collective_counts"] == {"all-reduce": 1}
    assert mlp["collective_bytes"] == {"all-reduce": rows * d * 4}
    assert mlp["wire"] == 2 * rows * d * 4
    assert mlp["placements"] == ["S(0)", "R"]


@pytest.mark.parametrize("kind", KINDS)
def test_depth_fit_equals_the_direct_full_depth_count(runs, kind):
    """A 4-layer tiny olmo-1b: the fit over 1 and 2 layers (the train step
    with 2 microbatches, each run in full) reproduces the direct count of
    all 4 layers exactly."""
    d = runs["torch"]["depth"][kind]
    for k in ("flops", "bytes", "coll"):
        assert d["fit"][k] == d["direct"][k], k
    assert (d["fit"]["n_a"], d["fit"]["n_b"], d["fit"]["n_full"]) == (1, 2, 4)


@pytest.mark.parametrize("cell", [f"{arch}/{profile}" for arch in ("mamba2-780m",
                                                                    "recurrentgemma-9b")
                                  for profile in ("2d", "fsdp")])
def test_sub_quadratic_train_steps_count_on_the_fake_world(runs, cell):
    """The reduced SSM and RG-LRU train steps dispatch on the (4, 2) mesh:
    softplus's backward has a sharding rule."""
    rec = runs["torch_ssm"][cell]
    assert "error" not in rec, rec.get("error")
    assert rec["flops"] > 0 and sum(rec["collectives"].values()) > 0


# ---------------------------------------------------------------------------
# The CLI on a production cell, rendered by the report
# ---------------------------------------------------------------------------


def test_cli_writes_a_record_that_the_report_renders(runs):
    (rec,) = runs["cli"]
    assert rec["status"] == "ok", rec.get("error")
    assert (rec["arch"], rec["shape"], rec["mesh"]) == (*CLI_CELL, "pod16x16")
    assert rec["roofline"]["n_chips"] == 256 and rec["hw"] == "h100-sxm-bf16"
    assert rec["depth_correction"]["matches_direct"]
    assert rec["memory"]["total_bytes"] > 0 and rec["flops"] > 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report.main(["--json", str(runs["cli_path"])])  # the CLI's remat by default
    text = buf.getvalue()
    assert text == j_report.render([rec], remat="dots") + "\n"
    assert f"| {CLI_CELL[0]} | {CLI_CELL[1]} | pod16x16 | ok |" in text
    assert "1 cells compiled OK" in text


def test_lower_cell_needs_a_production_world():
    """Outside a fake world of 256 ranks the production mesh cannot be built."""
    with pytest.raises(ValueError, match="needs a world of 256"):
        dryrun.lower_cell("olmo-1b", "decode_32k", multi_pod=False, verbose=False)


def test_shallow_cfg_keeps_every_other_field():
    cfg = get_config("whisper-base")
    s = dryrun._shallow_cfg(cfg, 2)
    assert (s.n_layers, s.encoder.n_layers, s.name) == (2, 2, "whisper-base-depth2")
    assert dataclasses.replace(s, n_layers=cfg.n_layers, encoder=cfg.encoder,
                               name=cfg.name) == cfg
    assert torch.float32 == cfg.dtype


# ---------------------------------------------------------------------------
# The step counter off the mesh
# ---------------------------------------------------------------------------


def test_a_counted_launch_counts_as_its_plain_version(monkeypatch):
    """``build.counted``: where a wrapper launches (here a CPU tensor taken
    as the card's), the ops inside the launch are not counted and the
    wrapper's call on ``meta`` copies (its plain version) is, so the step
    counts the same on ``meta`` and on the device."""
    from repro_torch.core import hlo_analysis
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "takes_plain", lambda t: t.device.type == "meta")

    @build.counted
    def kernel(x, w, *, scale):
        if x.device.type == "meta":  # the plain version
            return torch.relu(x @ w) * scale
        out = torch.empty((x.shape[0], w.shape[1]))  # "the launch"
        torch.mm(x, w, out=out)
        return out.relu_().mul_(scale)

    def step(x, w):
        return kernel(torch.tanh(x), w, scale=2.0).sum(dim=0)

    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(8, 4, generator=g), torch.randn(4, 6, generator=g)
    y, on_cpu = hlo_analysis.record_step(step, x, w)
    _, on_meta = hlo_analysis.record_step(step, x.to("meta"), w.to("meta"))
    torch.testing.assert_close(y, (torch.relu(torch.tanh(x) @ w) * 2.0).sum(dim=0))
    assert on_cpu.flops == on_meta.flops == 2 * 8 * 4 * 6
    assert on_cpu.bytes_accessed == on_meta.bytes_accessed
    assert on_cpu.ops == on_meta.ops
    assert "aten.empty" not in " ".join(on_cpu.ops) and on_cpu.ops["aten.relu"] == 1


def test_a_cpu_prefill_counts_as_its_meta_twin():
    """Mesh-free, reduced olmo-1b on the kernel tier: the CPU takes the plain
    versions the ``meta`` run takes, so every count is equal.  (A CPU step's
    first run also computes the host constants its caches keep, the RoPE
    frequencies, which a card's or ``meta`` step leaves on the host, and a
    model's first run splits its stacked leaves into layer views: second
    runs are compared.)"""
    from repro_torch.configs import reduced
    from repro_torch.core import hlo_analysis
    from repro_torch.launch import steps
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.nn import init_params, materialize, param_defs

    cfg = reduced(get_config("olmo-1b"))
    tokens = torch.randint(0, cfg.vocab, (2, 24), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(0))

    def count(model, toks):
        prefill = steps.make_prefill_step(model, cfg, impl="kernel")
        leaves = {k: model.get_parameter(k) for k in param_defs(model)}
        with torch.inference_mode():
            return hlo_analysis.record_step(lambda p, b: prefill(b), leaves,
                                            {"tokens": toks})[1]

    cpu = materialize(TransformerLM(cfg), init_params(TransformerLM(cfg), 0), "cpu")
    on_meta = TransformerLM(cfg)
    count(cpu, tokens), count(on_meta, tokens.to("meta"))  # the layer views cached
    on_cpu, meta = count(cpu, tokens), count(on_meta, tokens.to("meta"))
    assert (meta.flops, meta.bytes_accessed, meta.ops) == (
        on_cpu.flops, on_cpu.bytes_accessed, on_cpu.ops)
    assert hlo_analysis.memory_summary(meta) == hlo_analysis.memory_summary(on_cpu)
    assert on_cpu.flops > 0 and hlo_analysis.op_histogram(on_cpu)["aten.bmm"] > 0
    assert hlo_analysis.collective_stats(on_cpu).total_bytes == 0


def test_hillclimb_records_every_variant_and_skips_the_done(monkeypatch, tmp_path):
    """``hillclimb.main`` on one cell (``lower_cell`` stubbed: the fake world
    is the CLI's): one record a variant, tagged with its cell and iteration,
    and a second run re-dispatches none that is ``ok``."""
    from repro_torch.launch import hillclimb

    calls = []

    def lower_cell(arch, shape, **kw):
        calls.append((arch, shape, kw))
        return {"arch": arch, "shape": shape, "status": "ok", **kw}

    monkeypatch.setattr(hillclimb.dr, "lower_cell", lower_cell)
    monkeypatch.setattr(hillclimb, "fake_world", lambda n: contextlib.nullcontext(n))
    monkeypatch.setattr(hillclimb, "OUT", str(tmp_path / "hc.json"))
    hillclimb.main(["--cell", "olmo_train"])
    recs = json.loads((tmp_path / "hc.json").read_text())
    names = [v[0] for v in hillclimb.PLAYBOOK["olmo_train"]["variants"]]
    assert [r["iteration"] for r in recs] == names
    assert {r["cell"] for r in recs} == {"olmo_train"}
    assert calls[-1] == ("olmo-1b", "train_4k", dict(
        multi_pod=False, impl="blocked_jax", correct=True, profile="fsdp", remat="dots",
        microbatches=4))
    hillclimb.main(["--cell", "olmo_train"])
    assert len(calls) == len(names)
