"""Device meshes and the process group, the port of ``repro.launch.mesh``.

The port runs SPMD: one process a rank, every rank running the same
Python.  :func:`init_world` joins the process group: from ``torchrun``'s
environment where it is set (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``), else
a world of one started in-process from a ``FileStore`` (no TCP).  NCCL on
the card, gloo on the CPU; a failed init raises, with no fallback.

:func:`make_debug_mesh` and :func:`make_production_mesh` build a torch
``DeviceMesh`` with the reference's axis names, on ``cuda`` unless the
caller asks for the CPU, and raise where the world is not the mesh's size
(the reference's meshes need their devices).

The dry-run's devices (``launch/dryrun.py``) are a world of fake ranks:
:func:`fake_world` joins a process group of ``n`` ranks on torch's
``"fake"`` backend as rank 0 (a ``FakeStore``; no rank but this one exists
and no collective moves data).  The production meshes are then built on
it, on the first 256 or 512 ranks, with device type ``cuda`` so that
DTensor picks the card's collectives (all-to-all where a CPU mesh would
all-gather); their local tensors stay on ``meta``.  It is the counterpart
of XLA's fake host devices, and :func:`ensure_host_device_count` keeps the
reference's contract on the same ``XLA_FLAGS`` flag, so one environment
sizes both packages' dry-runs.  A process has one default group: a fake
world lives in its own process (the CLI, a test's subprocess), never beside
an NCCL or gloo world.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import re
import tempfile

import torch

# A collective that waits longer than this fails its rank.
DEFAULT_TIMEOUT_S = 600.0

_COUNT_RE = re.compile(r"--xla_force_host_platform_device_count=(\d+)")


def ensure_host_device_count(n: int = 512, *, respect_env: bool = True) -> int:
    """Set ``--xla_force_host_platform_device_count=n`` in ``XLA_FLAGS``
    and return the count in effect: the size of the dry-run's fake world.

    With ``respect_env`` (the default) an existing count in ``XLA_FLAGS``
    wins, so ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` sizes
    both packages' dry-runs; ``respect_env=False`` overrides it."""
    flags = os.environ.get("XLA_FLAGS", "")
    m = _COUNT_RE.search(flags)
    if m is not None:
        if respect_env:
            return int(m.group(1))
        os.environ["XLA_FLAGS"] = _COUNT_RE.sub(f"--xla_force_host_platform_device_count={n}",
                                                flags)
        return n
    extra = f"--xla_force_host_platform_device_count={n}"
    os.environ["XLA_FLAGS"] = f"{flags} {extra}".strip()
    return n


@contextlib.contextmanager
def fake_world(n: int):
    """A process group of ``n`` ranks on the ``"fake"`` backend, this
    process rank 0, for the duration of the block (destroyed on exit).
    Raises where the process already holds a default group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("this process already holds a process group; a fake world needs a "
                           "process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield n
    finally:
        dist.destroy_process_group()


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
    if dist.is_initialized() and world > need and dist.get_backend() == "fake":
        # the first ranks of a larger fake world
        from torch.distributed.device_mesh import DeviceMesh

        return DeviceMesh(torch.device(device).type, torch.arange(need).reshape(shape),
                          mesh_dim_names=names)
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
