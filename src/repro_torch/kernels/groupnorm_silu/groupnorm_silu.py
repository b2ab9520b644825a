"""Wrapper of the GroupNorm(+SiLU) CUDA kernel (``csrc/groupnorm_silu.cu``).

The port of ``repro.kernels.groupnorm_silu.groupnorm_silu.groupnorm_silu_pallas``.
Ragged N needs no padding here: the blocks of a cluster split the rows
themselves.  ``plan`` gives each call's launch: the channel chunks, the
cluster of blocks over N, and whether a block keeps its rows in shared
memory or reads them twice.  A CUDA tensor launches the hand-written
kernel; a CPU tensor takes the plain version (``ref.groupnorm_silu_ref``),
and a ``meta`` tensor takes it shape only (``build.takes_plain``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.groupnorm_silu import ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 10 + [ctypes.c_float] + [_I] * 2 + [_P]

# csrc/groupnorm_silu.cu: threads per block; thread-block clusters of at
# most 8 blocks (the portable size); at most 8 channel chunks, so a row of a
# chunk stays wide enough to coalesce.
THREADS = 256
MAX_CLUSTER = 8
MAX_CHUNKS = 8
VEC = 4  # channels per vector load
# The most bytes of rows a block keeps where the grid allows: four such
# blocks fit an SM, so each SM has the loads of several blocks in flight.
ROWS_BYTES = 48 * 1024


class Plan(NamedTuple):
    groups_per_chunk: int
    width: int  # channels per chunk
    chunks: int
    vec: int  # 4: rows load as 4-channel vectors; 1: scalar loads
    cluster: int  # blocks per (chunk, batch), splitting N
    rows_per_block: int
    row_lanes: int  # threads down the rows of a column vector
    cached: bool  # rows kept in shared memory between the two passes
    smem: int  # bytes of dynamic shared memory per block
    blocks: int  # B * chunks * cluster


@functools.lru_cache(maxsize=None)
def plan(B: int, N: int, C: int, groups: int, elem_bytes: int, aligned: bool = True) -> Plan:
    """The launch of one (B, N, C) call.

    Chunks are whole groups: the fewest groups per chunk (so the most
    chunks, at most ``MAX_CHUNKS``) whose width is a multiple of ``VEC``
    channels, or, where no chunk size gives one or the data is not aligned
    to a vector, the fewest groups per chunk with scalar loads.  N is split
    over a cluster of 1, 2, 4 or 8 blocks: the smallest whose grid fills the
    card's ``build.SMS`` and whose blocks keep at most ``ROWS_BYTES`` of
    rows, else 8 (fewer, larger blocks save the cluster's barriers where
    there are clusters enough), with no block empty.  A block keeps its rows
    in shared memory when they fit beside its reduction scratch
    (``2 * row_lanes * width + 4 * groups_per_chunk`` floats); otherwise it
    reads them again in its second pass."""
    cpg = C // groups
    sizes = [k for k in range(1, groups + 1) if groups % k == 0 and groups // k <= MAX_CHUNKS]
    vec_sizes = [k for k in sizes if k * cpg % VEC == 0] if aligned else []
    gpc = vec_sizes[0] if vec_sizes else sizes[0]
    vec = VEC if vec_sizes else 1
    width, chunks = gpc * cpg, groups // gpc
    cluster = next((c for c in (1, 2, 4) if B * chunks * c >= build.SMS
                    and -(-N // c) * width * elem_bytes <= ROWS_BYTES), MAX_CLUSTER)
    rows = -(-N // cluster)
    cluster = -(-N // rows)
    lanes = THREADS // min(width // vec, THREADS)
    scratch = 4 * (2 * lanes * width + 4 * gpc)
    cache = -(-rows * width * elem_bytes // 16) * 16
    cached = cache + scratch <= build.SMEM_LIMIT
    return Plan(gpc, width, chunks, vec, cluster, rows, lanes, cached,
                scratch + (cache if cached else 0), B * chunks * cluster)


@build.counted
def groupnorm_silu(
    x: torch.Tensor,  # (B, N, C)
    scale: torch.Tensor,  # (C,)
    bias: torch.Tensor,
    *,
    groups: int,
    eps: float = 1e-5,
    silu: bool = True,
) -> torch.Tensor:
    if build.takes_plain(x):
        return ref.groupnorm_silu_ref(x, scale, bias, groups=groups, eps=eps, silu=silu)
    dev = build.check_device(x, scale, bias)
    if x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"groupnorm kernel takes fp32/bf16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"expected contiguous (B, N, C), got {tuple(x.shape)}")
    B, N, C = x.shape
    if C % groups or scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"{C} channels, {groups} groups, scale {tuple(scale.shape)}")
    if N * C >= 2 ** 31 or not 1 <= B < 2 ** 16 or N == 0:
        raise ValueError(f"groupnorm kernel takes 1 <= B < 65536 batches of 0 < N*C < 2^31 "
                         f"elements, got {tuple(x.shape)}")
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        scale = scale.to(torch.float32).contiguous()
    if bias.dtype != torch.float32 or not bias.is_contiguous():
        bias = bias.to(torch.float32).contiguous()
    p = plan(B, N, C, groups, x.element_size(), x.data_ptr() % (VEC * x.element_size()) == 0)
    out = torch.empty_like(x)
    err = build.function("rt_groupnorm_silu", _ARGTYPES)(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), B, N, C, groups,
        p.groups_per_chunk, p.vec, p.cluster, p.rows_per_block, int(p.cached), p.smem,
        float(eps), int(silu), build.DTYPE_CODES[x.dtype], build.stream(dev))
    build.check_error(err, "groupnorm_silu")
    build.launches["groupnorm_silu"] += 1
    return out
