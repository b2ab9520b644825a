"""Device meshes and the process group, the port of ``repro.launch.mesh``.

The port runs SPMD: one process a rank, every rank running the same
Python.  :func:`init_world` joins the process group: from ``torchrun``'s
environment where it is set (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``), else
a world of one started in-process from a ``FileStore`` (no TCP).  NCCL on
the card, gloo on the CPU; a failed init raises, with no fallback.

:func:`make_debug_mesh` and :func:`make_production_mesh` build a torch
``DeviceMesh`` with the reference's axis names, on ``cuda`` unless the
caller asks for the CPU, and raise where the world is not the mesh's size
(the reference's meshes need their devices).  The dry-run's fake-device
setup (``ensure_host_device_count``) has no counterpart yet.
"""

from __future__ import annotations

import datetime
import os
import re
import tempfile

import torch

# A collective that waits longer than this fails its rank.
DEFAULT_TIMEOUT_S = 600.0


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_world(device="cuda", *, rank: int | None = None, world_size: int | None = None,
               store_path: str | None = None, timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the process group (once a process) and return ``(rank,
    world_size)``.  ``rank``/``world_size``/``store_path`` name a
    ``FileStore`` world explicitly (the CPU tests' ranks); without them the
    world comes from ``torchrun``'s environment, else it is a world of one."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    dev = torch.device(device)
    backend = backend_for(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank or 0)))
    if rank is None and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        rank, world_size = (0, 1) if rank is None else (rank, world_size)
        if store_path is None:
            store_path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"), "store")
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                timeout=timeout)
    return dist.get_rank(), dist.get_world_size()


def parse_mesh(spec: str) -> tuple[int, int]:
    """Parse a ``--mesh DxM`` flag ("4x2" -> (4, 2): data=4, model=2)."""
    m = re.fullmatch(r"(\d+)\s*[xX]\s*(\d+)", spec.strip())
    if m is None:
        raise ValueError(f"bad mesh spec {spec!r}; expected DxM, e.g. 4x2")
    d, t = int(m.group(1)), int(m.group(2))
    if d < 1 or t < 1:
        raise ValueError(f"mesh axes must be >= 1, got {spec!r}")
    return d, t


def _mesh(shape: tuple, names: tuple, device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    need = 1
    for s in shape:
        need *= s
    # the world this process would join, known before it joins one
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    if world != need:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh {names} needs a world of {need} "
                         f"ranks; this one has {world}")
    init_world(device)
    return init_device_mesh(torch.device(device).type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2,
    data=16, model=16) = 512; ``pod`` is pure data parallelism."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device)


def make_debug_mesh(n_data: int = 1, n_model: int = 1, device="cuda"):
    """A (data, model) mesh over the whole world (tests, ``--mesh DxM``)."""
    return _mesh((n_data, n_model), ("data", "model"), device)


def mesh_chips(mesh) -> int:
    from repro_torch.parallel.sharding import mesh_shape

    n = 1
    for s in mesh_shape(mesh).values():
        n *= s
    return n
