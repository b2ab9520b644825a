"""Build, load and launch-count the port's hand-written CUDA kernels.

The sources in ``csrc/`` are compiled at first use with ``nvcc`` for Hopper
(``sm_90a``), one object per source with all compilers started together,
linked into one shared library with a plain C interface and loaded with
``ctypes``.  The library lands in ``build/<hash of the sources>/`` beside
this file (listed in ``.gitignore``), so a checkout builds it on its first
kernel call and an edited source gets a fresh build.  Nothing here runs at
import time: the CPU tests import every module on a machine with no
``nvcc`` and no card.

``launches`` counts, per kernel, the wrapper calls that launched the CUDA
kernel; plain-version calls on CPU tensors do not count.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "build"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of csrc/common.cuh (rt::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches: collections.Counter = collections.Counter()

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = Path(CUDA_HOME) / "bin" / "nvcc" if CUDA_HOME else None
    found = str(cand) if cand is not None and cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library (once per source hash)
    and return its path.  A failed compile raises with nvcc's output."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        sources = sorted(CSRC.glob("*.cu"))
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(tmp / f"{src.stem}.o")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in sources
        ]
        logs = [p.communicate()[0] for p in procs]
        (tmp / "nvcc.log").write_text("".join(
            f"== {src.name}\n{log}" for src, log in zip(sources, logs)))
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *(str(tmp / f"{s.stem}.o") for s in sources), "-o", str(tmp / LIB_NAME)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        try:
            os.rename(tmp, out_dir)
        except OSError:
            if not lib.exists():  # not a concurrent build that finished first
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp)
    return lib


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def function(name: str, argtypes: list):
    """C entry point ``name`` of the built library, with its argtypes set."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_device(*tensors: torch.Tensor | None) -> torch.device:
    """All given tensors on one CUDA device of compute capability 9.0."""
    present = [t for t in tensors if t is not None]
    dev = present[0].device
    for t in present:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        raise RuntimeError(
            f"the kernels are built for sm_90a (Hopper); {torch.cuda.get_device_name(dev)} "
            f"has compute capability {cap}")
    return dev


def check_error(err: int, name: str) -> None:
    if err != 0:
        msg = library().rt_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def nvcc_log() -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) of
    the current build."""
    log = BUILD_ROOT / source_hash() / "nvcc.log"
    return log.read_text() if log.exists() else ""
