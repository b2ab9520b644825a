"""The DTensor boundary of the kernel dispatchers.

A kernel is launched through ``ctypes`` into ``torch.empty`` and cannot take
a DTensor.  On a mesh each dispatcher (``flash_attention.ops.attention`` and
``temporal_attention``, ``conv2d.ops.conv2d`` and ``temporal_conv1d``,
``groupnorm_silu.ops.groupnorm_silu``) therefore redistributes its operands
to the layout the reference's ``constrain`` pins, calls its tier on the
local shards (the kernel on the card, the plain version on the CPU: the
same boundary on both) and wraps the result back as a DTensor.

Gradients flow through ``to_local`` / ``from_local``.  An operand that is
replicated over a mesh dim on which the output is sharded feeds a different
computation on each rank there (K/V under head-parallel attention, a conv's
input under channel-parallel conv, a weight under data parallelism), so
its local gradient is a partial sum over that dim (:func:`grad_placements`).
"""

from __future__ import annotations

import torch

from repro_torch.parallel.sharding import is_dtensor


def on_mesh(*ts) -> bool:
    return any(is_dtensor(t) for t in ts)


def mesh_of(*ts):
    return next(t.device_mesh for t in ts if is_dtensor(t))


def as_placed(x, mesh, placements: tuple):
    """``x`` (a DTensor, or a plain tensor holding the global value on every
    rank) redistributed to ``placements``; None stays None."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if x is None:
        return None
    if not isinstance(x, DTensor):
        return distribute_tensor(x, mesh, placements, src_data_rank=None)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


def grad_placements(op_placements: tuple, out_placements: tuple) -> tuple:
    """The placements of an operand's local gradient: a partial sum over a
    mesh dim where the operand is replicated and the output sharded."""
    from torch.distributed.tensor import Partial

    return tuple(Partial() if (p.is_replicate() and o.is_shard()) else p
                 for p, o in zip(op_placements, out_placements))


def local(x, out_placements: tuple):
    """The local shard of a placed DTensor (None stays None)."""
    if x is None:
        return None
    return x.to_local(grad_placements=grad_placements(tuple(x.placements), out_placements))


def wrap(y: torch.Tensor, mesh, placements: tuple, shape: tuple):
    """A local result as the DTensor of global ``shape`` (contiguous)."""
    from torch.distributed.tensor import DTensor

    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= int(s)
    return DTensor.from_local(y.contiguous(), mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(reversed(stride)))


def pinned(shape: tuple, spec_names: tuple, mesh) -> list:
    """The placements ``constrain(x, spec_names)`` pins for a tensor of
    ``shape`` (a list, to override a mesh dim)."""
    from repro_torch.parallel.sharding import activation_spec, placements

    return list(placements(activation_spec(tuple(shape), spec_names, mesh), mesh))


def sharded_dims(x, dim: int) -> tuple:
    """The mesh dims on which DTensor ``x`` is sharded along tensor ``dim``."""
    dim = dim % x.ndim
    return tuple(i for i, p in enumerate(x.placements) if p.is_shard(dim))
