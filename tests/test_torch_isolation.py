"""The PyTorch/CUDA port stands alone: no module of ``src/repro_torch``, no
line of ``chip_smoke.py`` and no line of the card tests
(``tests/test_torch_cuda.py``) imports ``jax`` or the JAX package ``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# the port, its chip run, and its card tests (which run where JAX is absent)
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"]
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
                "runtime/straggler.py", "training/compression.py"):
        assert port / rel in PORT_FILES


@pytest.mark.parametrize("name,stage", [
    ("muse", "parallel_decode"), ("phenaki", "parallel_decode"), ("llama2-7b", "decode"),
    ("parti", "ar_decode"), ("deepseek-moe-16b", "decode"), ("mamba2-780m", "decode"),
    ("recurrentgemma-9b", "decode"), ("whisper-base", "decode"), ("qwen2-vl-2b", "decode")])
def test_workload_builds_without_jax(name, stage):
    """A process that never imported ``jax`` or ``repro`` builds the
    full-size workload (on ``meta``: nothing is allocated)."""
    code = (
        "import sys\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.workload import workload_for\n"
        f"wl = workload_for(get_config({name!r}))\n"
        f"assert wl.cost_descriptor().stages[1].name == {stage!r}\n"
        "assert all(p.device.type == 'meta' for p in wl.model.parameters())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=300)


def test_encdec_steps_run_without_jax():
    """A process that never imported ``jax`` or ``repro`` runs reduced
    whisper-base on the CPU through ``launch/steps.py``: the prefill on frame
    embeddings and decoder tokens, then two serve steps against the
    context."""
    code = (
        "import sys\n"
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
        "assert tuple(logits.shape) == (2, 1, 256) and bool(torch.isfinite(logits).all())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=300)


def test_training_runs_without_jax(tmp_path):
    """A process that never imported ``jax`` or ``repro`` trains reduced
    olmo-1b on the CPU through ``launch/train.py``, then checkpoints its
    state and restores it."""
    code = (
        "import sys\n"
        "from repro_torch.checkpoint import Checkpointer\n"
        "from repro_torch.launch import train\n"
        f"d = {str(tmp_path)!r}\n"
        "model, state, hist = train.main(['--arch', 'olmo-1b', '--reduced', '--device', 'cpu',\n"
        "    '--steps', '2', '--batch', '2', '--seq', '16', '--ckpt-dir', d])\n"
        "assert len(hist) == 2\n"
        "ck = Checkpointer(d, async_save=False)\n"
        "ck.save(2, state)\n"
        "assert int(ck.restore(state)['opt']['step']) == 2\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=300)


def test_serve_engine_runs_without_jax():
    """A process that never imported ``jax`` or ``repro`` serves reduced
    Stable Diffusion through the port's ``ServeEngine`` on the CPU."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.serving import ServeConfig, ServeEngine\n"
        "from repro_torch.workload import reduced_workload\n"
        "wl = reduced_workload(get_config('stable-diffusion'))\n"
        "eng = ServeEngine(wl, wl.init(0, 'cpu'), ServeConfig(route='cascade'))\n"
        "eng.submit(0, np.arange(5))\n"
        "assert tuple(eng.run()[0].shape) == (8, 8, 3)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=300)


def test_characterization_runs_without_jax():
    """A process that never imported ``jax`` or ``repro`` traces full-width
    Phenaki's event stream on ``meta`` through ``core.characterize``."""
    code = (
        "import sys\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.core import characterize, perf_model\n"
        "from repro_torch.workload import workload_for\n"
        "ev = characterize.trace_generative(workload_for(get_config('phenaki')))\n"
        "assert len(ev) == 546 and perf_model.total_flops(ev) > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=300)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [name for name in _imports(path) if _banned(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_flags_reference_imports_but_not_the_port():
    assert _banned("jax.numpy") and _banned("repro") and _banned("repro.kernels")
    assert not _banned("repro_torch") and not _banned("repro_torch.kernels")
    assert not _banned("jaxtyping_free") and not _banned(None)
