"""Mesh-aware execution of the canonical stage path, the port of
``repro.parallel.mesh_exec``, SPMD on a torch ``DeviceMesh``.

``workload.run_stage`` stays mesh-oblivious: given a mesh, every workload
delegates here, and :func:`run_stage_on_mesh` (1) makes each leaf of the
batched stage state a DTensor with its batch dim sharded over the mesh's
data axes (each rank keeps its slice: every rank holds the same state) and
(2) re-enters the same ``run_stage`` body inside :func:`mesh_scope`, so the
``constrain`` pins and the kernel dispatchers see the ambient mesh, then
(3) gathers the output state whole on every rank, so each rank's engine
state stays the same.  Per-request noise is drawn whole on every rank from
the ``(seed, rid, stage)`` generators before it meets the sharded batch, so
outputs do not depend on the mesh.

Inside a scope DTensor runs under ``implicit_replication``: a plain tensor
made in a stage body (a timestep, a position table, the noise) holds the
same global value on every rank, and is taken as replicated.

:func:`stage_mesh_slices` carves the mesh into one contiguous slice of
ranks per cascade stage, sized from each stage's HBM-demand profile
(heavy stages tensor-parallel ``(1, k)``, light ones data-parallel
``(k, 1)``).  Every rank builds every slice (a process group is made
collectively); a stage runs on its slice's ranks, and the slice's first
rank then broadcasts the output state to the rest of the world.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.parallel.sharding import (
    _AMBIENT_MESH,
    batch_sharding_for,
    distribute,
    install_dtensor_rules,
    is_dtensor,
)

# A stage whose mean HBM demand is within this factor of the heaviest
# stage's is laid out tensor-parallel (model axis); lighter stages are
# data-parallel.
HEAVY_DEMAND_FRAC = 0.5


@contextlib.contextmanager
def mesh_scope(mesh):
    """Make ``mesh`` the ambient mesh (``sharding.current_mesh``) with plain
    tensors taken as replicated; a no-op for None."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    install_dtensor_rules()
    token = _AMBIENT_MESH.set(mesh)
    try:
        with implicit_replication():
            yield
    finally:
        _AMBIENT_MESH.reset(token)


def _tree_map(fn, tree):
    from repro_torch.workload.base import tree_map

    return tree_map(fn, tree)


def shard_batched_state(state, mesh):
    """Every tensor leaf of a stacked (batch-first) state as a DTensor with
    its batch dim sharded over the mesh's data axes (replicated where the
    batch does not divide; a 0-d leaf replicated)."""

    def one(x):
        if not isinstance(x, torch.Tensor) or is_dtensor(x):
            return x
        if x.ndim == 0:
            return distribute(x, mesh, ())
        return distribute(x, mesh, batch_sharding_for(mesh, x.shape[0], x.ndim).spec)

    return _tree_map(one, state)


def shard_batch(batch: dict, mesh, axes: dict | None = None) -> dict:
    """A train batch (the global value on every rank) with each leaf's batch
    axis (0, or ``axes[key]``) sharded over the profile's batch axes."""
    out = {}
    for key, x in batch.items():
        x = torch.as_tensor(x)
        ax = (axes or {}).get(key, 0)
        spec = batch_sharding_for(mesh, x.shape[ax], x.ndim - ax).spec
        out[key] = distribute(x, mesh, (None,) * ax + spec)
    return out


def gather_state(state):
    """Every DTensor leaf whole, on every rank of its mesh."""
    return _tree_map(lambda x: x.full_tensor() if is_dtensor(x) else x, state)


def mesh_ranks(mesh) -> list[int]:
    return [int(r) for r in mesh.mesh.flatten().tolist()]


def _world():
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()


def broadcast_state(state, src: int, device):
    """``state`` (given on rank ``src``; anything elsewhere) on every rank of
    the world: its structure as an object, then each tensor leaf."""
    import torch.distributed as dist

    rank, _ = _world()
    skel = [_tree_map(lambda x: _Leaf(x), state) if rank == src else None]
    dist.broadcast_object_list(skel, src=src)

    def leaf(s, x):
        if s.shape is None:
            return s.value
        t = x.contiguous() if rank == src else torch.empty(s.shape, dtype=s.dtype, device=device)
        dist.broadcast(t, src=src)
        return t

    from repro_torch.workload.base import tree_map

    return tree_map(leaf, skel[0], state if rank == src else skel[0])


class _Leaf:
    """A state leaf's shape and dtype (a tensor), or its value (anything
    else): what a broadcast's receivers allocate from."""

    def __init__(self, x):
        tensor = isinstance(x, torch.Tensor)
        self.shape = tuple(x.shape) if tensor else None
        self.dtype = x.dtype if tensor else None
        self.value = None if tensor else x


def mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def run_stage_on_mesh(workload, params, stage, state, gens, *, impl: str = "auto",
                      temperature: float = 0.0, mesh):
    """Run one stage with the batch sharded over the mesh's data axes and the
    body inside ``mesh_scope`` (TP pins and kernel boundaries on); returns
    the output state whole on every rank of the world.  ``params`` are used
    as they are: the engine shards them once."""
    ranks = mesh_ranks(mesh)
    rank, world = _world()
    out = None
    if rank in ranks:
        # DTensor's views (a stacked layer's slice) cannot be made under
        # inference mode: the body runs under no_grad instead.
        with torch.inference_mode(False), torch.no_grad():
            sharded = shard_batched_state(state, mesh)
            with mesh_scope(mesh):
                out = workload.run_stage(params, stage, sharded, gens, impl=impl,
                                         temperature=temperature)
            out = gather_state(out)
    if len(ranks) < world:
        out = broadcast_state(out, ranks[0], mesh_device(mesh))
    return out


def stage_slice_plan(demands: list, n: int) -> list[tuple[int, int, tuple]]:
    """``(first rank, count, (data, model))`` of each stage's slice of ``n``
    ranks, from the stages' mean HBM demands; ``None`` entries (fewer ranks
    than stages) mean the whole mesh."""
    k = len(demands)
    if k == 0:
        return []
    if n < k:
        return [None] * k
    demands = [max(float(d), 1e-9) for d in demands]
    total = sum(demands)
    extra = [d / total * (n - k) for d in demands]
    floors = [int(e) for e in extra]
    alloc = [1 + f for f in floors]
    residual = n - sum(alloc)
    order = sorted(range(k), key=lambda i: (extra[i] - floors[i], demands[i]), reverse=True)
    j = 0
    while residual > 0:
        alloc[order[j % k]] += 1
        residual -= 1
        j += 1
    dmax = max(demands)
    plan, off = [], 0
    for i in range(k):
        cnt = alloc[i]
        shape = (1, cnt) if demands[i] >= HEAVY_DEMAND_FRAC * dmax else (cnt, 1)
        plan.append((off, cnt, shape))
        off += cnt
    return plan


def stage_mesh_slices(stages, mesh) -> list:
    """One contiguous slice of ``mesh``'s ranks per stage (see
    :func:`stage_slice_plan`); with fewer ranks than stages every stage
    shares the whole mesh."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.pipeline.stage import mean_demand

    ranks = mesh.mesh.flatten()
    out = []
    for entry in stage_slice_plan([mean_demand(s) for s in stages], int(ranks.numel())):
        if entry is None:
            out.append(mesh)
            continue
        off, cnt, shape = entry
        out.append(DeviceMesh(mesh.device_type, ranks[off:off + cnt].reshape(shape),
                              mesh_dim_names=("data", "model")))
    return out
