"""Dense / Embedding primitives (``repro.models.layers.basic``), each
recording its tracer event under the reference's ``name``."""

from __future__ import annotations

import math

import torch

from repro_torch.core import tracer
from repro_torch.kernels import shards
from repro_torch.nn import Module, normal_init, scaled_init, zeros_init
from repro_torch.parallel.sharding import constrain, current_mesh, current_rules


class Dense(Module):
    """y = x @ W (+ b), W stored ``(in, out)`` as in the reference."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = False,
                 dtype=torch.float32, name: str = "dense", *, axes: tuple = ("embed", "mlp")):
        super().__init__()
        self.in_dim, self.out_dim, self.use_bias, self.name = in_dim, out_dim, use_bias, name
        self.axes = tuple(axes)
        self.param("kernel", (in_dim, out_dim), scaled_init((0,)), dtype, axes=self.axes)
        if use_bias:
            self.param("bias", (out_dim,), zeros_init, dtype, axes=(self.axes[1],))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(x.dtype)
        if current_mesh() is not None:
            # ZeRO-3 at use, as the reference: the weight's FSDP axes (data,
            # pod) gathered, its TP axes (model) kept sharded
            use_spec = []
            for ax in self.axes:
                r = current_rules().get(ax)
                rt = r if isinstance(r, tuple) else (r,)
                use_spec.append(None if any(a in ("data", "pod") for a in rt) else r)
            w = constrain(w, tuple(use_spec))
        y = torch.matmul(x, w)
        if self.use_bias:
            y = y + self.bias.to(x.dtype)
        if tracer.active():
            tracer.record(
                "linear", self.name,
                flops=2.0 * tracer.numel(x.shape[:-1]) * self.in_dim * self.out_dim,
                bytes_hbm=tracer.nbytes((x.shape, x.dtype), (y.shape, y.dtype),
                                        ((self.in_dim, self.out_dim), x.dtype)))
        return y


class Embedding(Module):
    """Token embedding, with the tied logits head (:meth:`attend`)."""

    def __init__(self, vocab: int, dim: int, dtype=torch.float32, name: str = "embed"):
        super().__init__()
        self.name = name
        self.param("table", (vocab, dim), normal_init(0.02), dtype, axes=("vocab", "embed"))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = self._lookup_on_mesh(ids) if shards.on_mesh(self.table, ids) else self.table[ids]
        if tracer.active():
            tracer.record("embed", self.name, flops=0.0,
                          bytes_hbm=tracer.nbytes((out.shape, out.dtype))
                          + tracer.numel(ids.shape) * 4)
        return out

    def _lookup_on_mesh(self, ids) -> torch.Tensor:
        """The lookup on DTensors, through the kernels' boundary: the table
        gathered whole (every rank looks up any row), each rank's own ids
        (batch-sharded) looked up locally, the rows batch-sharded.  DTensor
        takes the same gather; done locally, the backward's ``index_put``
        runs on plain tensors (DTensor's rule for it fails on these
        placements in torch 2.11), the table's gradient a partial sum over
        the batch axes."""
        from torch.distributed.tensor import Replicate

        mesh = shards.mesh_of(self.table, ids)
        shape = (*ids.shape, self.table.shape[1])
        out_pl = tuple(shards.pinned(shape, ("batch",) + (None,) * ids.ndim, mesh))
        ids_pl = tuple(shards.pinned(tuple(ids.shape), ("batch",) + (None,) * (ids.ndim - 1),
                                     mesh))
        table = shards.as_placed(self.table, mesh, (Replicate(),) * mesh.ndim)
        rows = shards.local(table, out_pl)[shards.local(shards.as_placed(ids, mesh, ids_pl),
                                                        out_pl)]
        return shards.wrap(rows, mesh, out_pl, shape)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Logits through the transposed table (the tied head), in ``x``'s
        dtype: x (..., dim) -> (..., vocab)."""
        table = self.table.to(x.dtype)
        y = torch.matmul(x, table.T)
        if tracer.active():
            vocab, dim = table.shape
            tracer.record(
                "linear", f"{self.name}_logits",
                flops=2.0 * tracer.numel(x.shape[:-1]) * dim * vocab,
                bytes_hbm=tracer.nbytes((x.shape, x.dtype), (y.shape, y.dtype),
                                        ((vocab, dim), x.dtype)))
        return y


def sinusoidal_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Timestep / position sinusoidal features: t (...,) -> (..., dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb
