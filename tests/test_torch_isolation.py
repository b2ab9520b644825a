"""The PyTorch/CUDA port stands alone: no module of ``src/repro_torch``, no
line of ``chip_smoke.py``, no line of the card tests
(``tests/test_torch_cuda.py``) and none of the gloo tests' rank bodies
(``tests/torch_mesh_ranks.py``) imports ``jax`` or the JAX package ``repro``."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# the port, its chip run, and its card tests (which run where JAX is absent)
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
    ROOT / "tests" / "torch_mesh_ranks.py"]
BANNED = ("jax", "jaxlib", "repro")


def _banned(name: str | None) -> bool:
    return name is not None and any(name == b or name.startswith(b + ".") for b in BANNED)


def _imports(path: Path) -> list[str]:
    out = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module)
            if node.module is None:
                out += [a.name for a in node.names]
    return out


def test_port_has_files():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(PORT_FILES) > 20


def test_checked_files_include_the_ttv_slice():
    port = ROOT / "src" / "repro_torch"
    for rel in ("models/ttv.py", "workload/ttv.py", "kernels/flash_attention/flash_attention.py",
                "kernels/conv2d/conv2d.py", "models/layers/conv.py", "models/transformer.py",
                "models/ar_image.py", "workload/ar_image.py", "configs/base.py",
                "models/layers/rope.py", "workload/lm.py", "telemetry/metrics.py",
                "telemetry/spans.py", "telemetry/chrome_trace.py", "telemetry/schema.py",
                "serving/arrivals.py", "serving/scheduler.py", "serving/engine.py",
                "pipeline/stage.py", "pipeline/cascade.py", "launch/serve.py",
                "core/tracer.py", "core/characterize.py", "core/perf_model.py",
                "core/amdahl.py", "core/prefill_decode.py", "core/seq_profile.py",
                "core/analytical.py", "core/profiler_analysis.py", "models/layers/moe.py",
                "configs/deepseek_moe_16b.py", "configs/qwen3_moe_30b_a3b.py",
                "models/layers/ssm.py", "models/layers/rglru.py", "configs/mamba2_780m.py",
                "configs/recurrentgemma_9b.py", "configs/whisper_base.py",
                "configs/qwen2_vl_2b.py", "launch/steps.py", "launch/train.py",
                "training/optimizer.py", "training/trainer.py", "checkpoint/checkpointer.py",
                "runtime/fault_tolerance.py", "data/pipeline.py", "kernels/vjp.py",
                "runtime/straggler.py", "training/compression.py", "parallel/__init__.py",
                "parallel/sharding.py", "parallel/mesh_exec.py", "launch/mesh.py",
                "kernels/shards.py"):
        assert port / rel in PORT_FILES


WORKLOADS = [
    ("muse", "parallel_decode"), ("phenaki", "parallel_decode"), ("llama2-7b", "decode"),
    ("parti", "ar_decode"), ("deepseek-moe-16b", "decode"), ("mamba2-780m", "decode"),
    ("recurrentgemma-9b", "decode"), ("whisper-base", "decode"), ("qwen2-vl-2b", "decode")]

# Each scenario below runs in a process of its own that never imported
# ``jax`` or ``repro``, then lists the modules of theirs it finds loaded.  A
# parent that imported ``torch`` and ``numpy`` and nothing else of the
# port's forks one child a scenario, up to four at a time, so no scenario
# sees another's imports or settings, and no child pays for a fresh
# ``import torch``.  A child past ``SCENARIO_TIMEOUT_S`` is killed and
# records so.
SCENARIO_TIMEOUT_S = 300
HARNESS = """
import json, os, sys, time, traceback
import numpy, torch

def banned():
    return sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))

assert not banned() and 'repro_torch' not in sys.modules, banned()
scenarios, out_dir, timeout = json.load(open(sys.argv[1])), sys.argv[2], float(sys.argv[3])

def record(key, res):
    with open(os.path.join(out_dir, key.replace('/', '_') + '.json'), 'w') as fh:
        json.dump(res, fh)

todo, running = list(scenarios), {}
while todo or running:
    while todo and len(running) < 4:
        key = todo.pop(0)
        pid = os.fork()
        if pid == 0:
            try:
                exec(scenarios[key], {})
                error = None
            except BaseException:
                error = traceback.format_exc()
            record(key, {'error': error, 'bad': banned()})
            sys.stdout.flush()
            os._exit(0)
        running[pid] = (key, time.monotonic())
    pid, _ = os.waitpid(-1, os.WNOHANG)
    if pid:
        running.pop(pid)
        continue
    for pid, (key, t0) in list(running.items()):
        if time.monotonic() - t0 > timeout:
            os.kill(pid, 9)
            os.waitpid(pid, 0)
            running.pop(pid)
            record(key, {'error': f'killed after {timeout} s', 'bad': []})
    time.sleep(0.05)
"""


def _scenarios(tmp: str) -> dict:
    out = {}
    for name, stage in WORKLOADS:
        out[f"workload/{name}"] = (
            "from repro_torch.configs import get_config\n"
            "from repro_torch.workload import workload_for\n"
            f"wl = workload_for(get_config({name!r}))\n"
            f"assert wl.cost_descriptor().stages[1].name == {stage!r}\n"
            "assert all(p.device.type == 'meta' for p in wl.model.parameters())\n")
    out["encdec"] = (
        "import torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.launch import steps\n"
        "from repro_torch.workload import reduced_workload\n"
        "wl = reduced_workload(get_config('whisper-base'))\n"
        "model = wl.init(0, 'cpu')\n"
        "batch = {'enc_embeds': torch.randn(2, 16, 64), 'tokens': torch.zeros(2, 5, dtype=torch.long)}\n"
        "logits, caches, ctx = steps.make_prefill_step(model, wl.cfg, max_len=7)(batch)\n"
        "serve = steps.make_serve_step(model, wl.cfg)\n"
        "for cur in (5, 6):\n"
        "    logits, caches = serve(logits[:, -1].argmax(-1)[:, None], caches, cur, context=ctx)\n"
        "assert tuple(logits.shape) == (2, 1, 256) and bool(torch.isfinite(logits).all())\n")
    out["training"] = (
        "from repro_torch.checkpoint import Checkpointer\n"
        "from repro_torch.launch import train\n"
        f"d = {tmp!r}\n"
        "model, state, hist = train.main(['--arch', 'olmo-1b', '--reduced', '--device', 'cpu',\n"
        "    '--steps', '2', '--batch', '2', '--seq', '16', '--ckpt-dir', d])\n"
        "assert len(hist) == 2\n"
        "ck = Checkpointer(d, async_save=False)\n"
        "ck.save(2, state)\n"
        "assert int(ck.restore(state)['opt']['step']) == 2\n")
    out["serve"] = (
        "import numpy as np\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.serving import ServeConfig, ServeEngine\n"
        "from repro_torch.workload import reduced_workload\n"
        "wl = reduced_workload(get_config('stable-diffusion'))\n"
        "eng = ServeEngine(wl, wl.init(0, 'cpu'), ServeConfig(route='cascade'))\n"
        "eng.submit(0, np.arange(5))\n"
        "assert tuple(eng.run()[0].shape) == (8, 8, 3)\n")
    out["characterization"] = (
        "from repro_torch.configs import get_config\n"
        "from repro_torch.core import characterize, perf_model\n"
        "from repro_torch.workload import workload_for\n"
        "ev = characterize.trace_generative(workload_for(get_config('phenaki')))\n"
        "assert len(ev) == 546 and perf_model.total_flops(ev) > 0\n")
    return out


@pytest.fixture(scope="module")
def no_jax(tmp_path_factory):
    """Every scenario's result, each from a process of its own that starts
    without ``jax`` or ``repro``."""
    tmp = tmp_path_factory.mktemp("no_jax")
    scen, out = tmp / "scenarios.json", tmp / "results"
    scenarios = _scenarios(str(tmp / "ckpt"))
    scen.write_text(json.dumps(scenarios))
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", HARNESS, str(scen), str(out), str(SCENARIO_TIMEOUT_S)],
                   check=True, env=env, timeout=2 * SCENARIO_TIMEOUT_S)
    return {key: json.loads((out / (key.replace("/", "_") + ".json")).read_text())
            for key in scenarios if (out / (key.replace("/", "_") + ".json")).exists()}


def _ran_without_jax(no_jax: dict, key: str) -> None:
    assert key in no_jax, f"{key}: its process left no result"
    res = no_jax[key]
    assert res["error"] is None, res["error"]
    assert not res["bad"], res["bad"]


@pytest.mark.parametrize("name,stage", WORKLOADS)
def test_workload_builds_without_jax(no_jax, name, stage):
    """A process that never imported ``jax`` or ``repro`` builds the
    full-size workload (on ``meta``: nothing is allocated)."""
    _ran_without_jax(no_jax, f"workload/{name}")


def test_encdec_steps_run_without_jax(no_jax):
    """A process that never imported ``jax`` or ``repro`` runs reduced
    whisper-base on the CPU through ``launch/steps.py``: the prefill on frame
    embeddings and decoder tokens, then two serve steps against the
    context."""
    _ran_without_jax(no_jax, "encdec")


def test_training_runs_without_jax(no_jax):
    """A process that never imported ``jax`` or ``repro`` trains reduced
    olmo-1b on the CPU through ``launch/train.py``, then checkpoints its
    state and restores it."""
    _ran_without_jax(no_jax, "training")


def test_serve_engine_runs_without_jax(no_jax):
    """A process that never imported ``jax`` or ``repro`` serves reduced
    Stable Diffusion through the port's ``ServeEngine`` on the CPU."""
    _ran_without_jax(no_jax, "serve")


def test_characterization_runs_without_jax(no_jax):
    """A process that never imported ``jax`` or ``repro`` traces full-width
    Phenaki's event stream on ``meta`` through ``core.characterize``."""
    _ran_without_jax(no_jax, "characterization")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [name for name in _imports(path) if _banned(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_flags_reference_imports_but_not_the_port():
    assert _banned("jax.numpy") and _banned("repro") and _banned("repro.kernels")
    assert not _banned("repro_torch") and not _banned("repro_torch.kernels")
    assert not _banned("jaxtyping_free") and not _banned(None)
