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
                "pipeline/stage.py", "pipeline/cascade.py", "launch/serve.py"):
        assert port / rel in PORT_FILES


@pytest.mark.parametrize("name,stage", [
    ("muse", "parallel_decode"), ("phenaki", "parallel_decode"), ("llama2-7b", "decode"),
    ("parti", "ar_decode")])
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


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [name for name in _imports(path) if _banned(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_flags_reference_imports_but_not_the_port():
    assert _banned("jax.numpy") and _banned("repro") and _banned("repro.kernels")
    assert not _banned("repro_torch") and not _banned("repro_torch.kernels")
    assert not _banned("jaxtyping_free") and not _banned(None)
