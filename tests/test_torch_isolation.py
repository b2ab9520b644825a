"""The PyTorch/CUDA port stands alone: no module of ``src/repro_torch``, no
line of ``chip_smoke.py`` and no line of the card tests
(``tests/test_torch_cuda.py``) imports ``jax`` or the JAX package ``repro``."""

import ast
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


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [name for name in _imports(path) if _banned(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_flags_reference_imports_but_not_the_port():
    assert _banned("jax.numpy") and _banned("repro") and _banned("repro.kernels")
    assert not _banned("repro_torch") and not _banned("repro_torch.kernels")
    assert not _banned("jaxtyping_free") and not _banned(None)
