"""The step's program analysis: collective bytes, cost and memory summaries
and an op histogram, the port of ``repro.core.hlo_analysis``.

The reference reads XLA's compiled program of a step (``cost_analysis()``,
``memory_analysis()``, the HLO text).  Eager PyTorch compiles nothing: it
runs each op on its own, so the port's "compiled program" is the record of
one step dispatched once (:func:`record_step`): every ATen op the step runs
on **this rank's local tensors**, with its operands and outputs.  A
dry-run dispatches the step on ``meta`` on a fake world
(``launch.mesh.fake_world``): the parameters and activations are DTensors
whose local tensors hold shapes only, so a 256-rank cell of a 72 B model
runs on a laptop's memory.

:class:`StepCounter` is a ``TorchDispatchMode`` that counts **below**
DTensor's dispatch: it declines every op that has a DTensor operand
(``NotImplemented``), DTensor then runs the op's local ops and its
redistributions' collectives on the local tensors, and those reach the
counter.  (A mode that counted the DTensor op would count the global op,
256 ranks' work.)  The ops DTensor runs on global-shape fake tensors to
propagate shapes are not the step's and are not counted.

What is counted, per rank:

  * ``flops``: matmul-class flops of the local ops (``torch.utils.flop_counter``'s
    formulas: mm, addmm, bmm, baddbmm, convolutions and their backward);
    XLA's figure also counts elementwise ops, so it is larger;
  * ``bytes accessed``: operand plus output bytes of every local op that
    runs (views and bare allocations move no data and count none;
    collectives count in :class:`CollectiveStats` instead);
  * collectives: DTensor's redistributions (``_c10d_functional`` ops,
    ``_dtensor.shard_dim_alltoall``) and any direct ``c10d`` call, each
    mapped to the reference's HLO type, its bytes the per-rank output bytes
    (the reference sums the ops' output shapes);
  * memory: the local bytes of the step's arguments and results, the results
    that are arguments written in place (alias), and the peak of the bytes
    the step itself allocates (temp).

The hand kernels launch through ``ctypes`` (``kernels/build.py``), which no
dispatch mode sees.  On ``meta`` a kernel wrapper runs its plain version
(``build.takes_plain``), and that is what is counted.  On the card a
launch is counted as the same wrapper's call on ``meta`` copies of its
inputs (``build.counted``, :meth:`StepCounter.count_launch`): the plain
version's ops, so a step counts the same work on ``meta`` and on the card,
whatever runs it.  The card's own readings of a step (device time by
kernel, busy share, the allocator's peak) are ``core.profiler_analysis``'s
(``op_histogram``, ``busy``, ``memory_summary``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# wire-traffic multiplier (ring algorithms): all-reduce moves ~2x the data
_WIRE_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# collective op (its overload packet) -> the reference's HLO type; a
# point-to-point or one-to-all transfer is a collective-permute
_COLLECTIVE_TYPES = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "collective-permute",
    "_c10d_functional.broadcast_": "collective-permute",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "collective-permute",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
}

# ops counted as views: whether they copy depends on strides alone
_LAYOUT_FREE = frozenset({torch.ops.aten.reshape.default, torch.ops.aten.contiguous.default})

# a copy op -> the position of its source
_COPIES = {torch.ops.aten._to_copy.default: 0, torch.ops.aten.copy_.default: 1}

# host scalars a step takes or returns (a decode position, a learning
# rate) count as the 4-byte scalars the reference's jitted step passes
_SCALAR_BYTES = 4


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_type: dict
    count_by_type: dict

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_type.values())

    @property
    def wire_bytes(self) -> float:
        return sum(
            b * _WIRE_FACTOR.get(t, 1.0) for t, b in self.bytes_by_type.items()
        )


@dataclasses.dataclass
class StepRecord:
    """What one dispatched step ran on this rank (the port's compiled
    program): the counts :class:`StepCounter` took, and the step's
    argument, result and alias bytes."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    ops: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    collective_counts: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0  # the most the step's own allocations held at once
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(x):
    """A DTensor's local tensor (this rank's shard); anything else as is."""
    return getattr(x, "_local_tensor", x)


def _leaves(tree) -> list:
    return [_local(x) for x in tree_flatten(tree)[0]]


def _leaf_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return _nbytes(x)
    if isinstance(x, (int, float)) and not isinstance(x, bool):
        return _SCALAR_BYTES
    return 0


def _tensors(obj, out: list) -> list:
    """The tensors in an op's arguments or results (lists, tuples and dicts
    of them), appended to ``out``."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _tensors(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _tensors(x, out)
    return out


class StepCounter(TorchDispatchMode):
    """Counts the local ops of the steps run under it into ``record``
    (:func:`record_step` runs one step under a fresh counter): the ops on
    ``device`` or ``meta`` (a launch's replay, ``count_launch``); an op
    only on another device is host bookkeeping (DTensor's shard arithmetic
    on small CPU tensors) and is not counted."""

    def __init__(self, device="meta"):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        self.record = StepRecord()
        self._devices = {torch.device(device).type, "meta"}
        self._dtensor = DTensor
        self._flops = flop_registry
        self._paused = 0
        self._live: dict = {}  # storage id -> bytes, of the step's own allocations
        self._current = 0

    def _allocated(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._current += n
        self.record.peak_bytes = max(self.record.peak_bytes, self._current)
        weakref.finalize(st, self._freed, key)

    def _freed(self, key) -> None:
        self._current -= self._live.pop(key, 0)

    @contextlib.contextmanager
    def paused(self):
        """Ops run inside are neither counted nor tracked."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def count_launch(self, wrapper: Callable, args: tuple, kwargs: dict):
        """A kernel wrapper's launch on the card: run it uncounted, then
        count the wrapper's call on ``meta`` tensors of its inputs' shapes
        and strides (its plain version, as a ``meta`` step runs it).
        Returns the launch's result."""

        def meta(x):
            if not isinstance(x, torch.Tensor):
                return x
            return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device="meta")

        with self.paused():
            out = wrapper(*args, **kwargs)
            margs = [meta(x) for x in args]
            mkwargs = {k: meta(x) for k, x in kwargs.items()}
        wrapper(*margs, **mkwargs)
        for t in _tensors(out, []):
            self._allocated(t)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs), [])
        if any(isinstance(x, self._dtensor) for x in ins):
            return NotImplemented  # a DTensor op: its local ops come here instead
        # a composite op (``matmul`` reaches a mode whole under inference
        # mode) is counted as the ops it decomposes into, but a reshape is
        # a view whatever its input's strides (it copies where they do not
        # allow a view, and a ``meta`` kernel lays its output out as the
        # card's kernel may not)
        if func not in _LAYOUT_FREE:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self._paused or torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out  # uncounted, or DTensor's shape propagation
        outs = _tensors(out, [])
        if not any(t.device.type in self._devices for t in (*ins, *outs)):
            return out  # host bookkeeping (DTensor's shard arithmetic), not the step's
        if (func in _COPIES and args[_COPIES[func]].device.type == "cpu"
                and outs[0].device.type != "cpu"):
            return out  # a host constant's upload, which a cache keeps after a first step
        rec = self.record
        name = str(func.overloadpacket)
        rec.ops[name] += 1
        ctype = _COLLECTIVE_TYPES.get(name)
        if ctype is not None:
            rec.collective_bytes[ctype] = (rec.collective_bytes.get(ctype, 0.0)
                                           + float(sum(_nbytes(t) for t in outs)))
            rec.collective_counts[ctype] = rec.collective_counts.get(ctype, 0) + 1
        elif not (func.is_view or func in _LAYOUT_FREE
                  or name.startswith(("aten.empty", "_c10d_functional."))):
            rec.bytes_accessed += float(sum(_nbytes(t) for t in ins)
                                        + sum(_nbytes(t) for t in outs))
            count = self._flops.get(func.overloadpacket)
            if count is not None:
                rec.flops += float(count(*args, **kwargs, out_val=out))
        # an output in a storage none of the op's inputs has is an allocation
        # (a view or an in-place write reuses its input's)
        used = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            if t.untyped_storage()._cdata not in used:
                self._allocated(t)
        return out


def active_counter() -> StepCounter | None:
    """The innermost :class:`StepCounter` on the dispatch mode stack."""
    if torch._C._len_torch_dispatch_stack() == 0:
        return None
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, StepCounter):
            return mode
    return None


def record_step(fn: Callable, *args, **kwargs) -> tuple[Any, StepRecord]:
    """Run ``fn(*args, **kwargs)`` once under a :class:`StepCounter`;
    returns ``(result, record)``.  The arguments' and results' leaves are
    measured by their local tensors (a DTensor's shard); a result leaf whose
    storage is an argument's is an alias (written in place)."""
    arg_leaves = _leaves((args, kwargs))
    tensors = [x for x in arg_leaves if isinstance(x, torch.Tensor)]
    counter = StepCounter(tensors[0].device if tensors else "meta")
    arg_storages = {x.untyped_storage()._cdata for x in arg_leaves
                    if isinstance(x, torch.Tensor)}
    with counter:
        out = fn(*args, **kwargs)
    rec = counter.record
    rec.argument_bytes = sum(_leaf_bytes(x) for x in arg_leaves)
    out_leaves = _leaves(out)
    rec.output_bytes = sum(_leaf_bytes(x) for x in out_leaves)
    rec.alias_bytes = sum(_nbytes(x) for x in out_leaves if isinstance(x, torch.Tensor)
                          and x.untyped_storage()._cdata in arg_storages)
    return out, rec


def collective_stats(record: StepRecord) -> CollectiveStats:
    return CollectiveStats(dict(record.collective_bytes), dict(record.collective_counts))


def cost_summary(record: StepRecord) -> dict:
    """``{"flops", "bytes accessed"}`` of one rank (the reference's
    ``cost_analysis()`` keys)."""
    return {"flops": record.flops, "bytes accessed": record.bytes_accessed}


def memory_summary(record: StepRecord) -> dict:
    """The reference's ``memory_analysis()`` keys, in local bytes of one
    rank: arguments and results (a host scalar 4 bytes), aliases (results
    written into an argument), temp (the peak of the step's own
    allocations beyond the results it returns).  No code is generated."""
    out = {
        "argument_size_in_bytes": record.argument_bytes,
        "output_size_in_bytes": record.output_bytes,
        "temp_size_in_bytes": max(record.peak_bytes
                                  - (record.output_bytes - record.alias_bytes), 0),
        "generated_code_size_in_bytes": 0,
        "alias_size_in_bytes": record.alias_bytes,
    }
    out["total_bytes"] = (
        out["argument_size_in_bytes"]
        + out["output_size_in_bytes"]
        + out["temp_size_in_bytes"]
        - out["alias_size_in_bytes"]
    )
    return out


def op_histogram(record: StepRecord) -> dict:
    """Op-count histogram by ATen op (its overload packet, ``aten.mm``):
    duplicate matmul counts beyond the model's layer count show recompute."""
    return dict(record.ops)
