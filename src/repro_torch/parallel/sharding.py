"""Logical-axis -> mesh-axis sharding rules, the port of
``repro.parallel.sharding`` on torch ``DeviceMesh`` and DTensor.

Every parameter carries a tuple of *logical* axis names (``ParamDef.axes``,
``nn.specs_of``).  This module maps them onto the mesh:

    mesh axes: ("pod", "data", "model")  [multi-pod]  /  ("data", "model")

  * FSDP / ZeRO-3: the "embed" axis of every weight shards over ``data``
    (gathered at use, ``Dense``), optimizer state inherits the sharding.
  * TP: "mlp" / "heads" / "vocab" shard over ``model``; EP: "experts".
  * DP: the batch dim of activations shards over ``("pod", "data")``.

A rule applies only where the dimension divides the axis size; a dim that
does not stays replicated, counted by ``REPLICATION_FALLBACKS`` and warned
once per signature, as in the reference.

A spec is the reference's per-tensor-dim ``PartitionSpec`` as a tuple: an
entry is None, a mesh axis name, or a tuple of names that split one dim
major to minor.  :func:`placements` turns it into DTensor placements, one a
mesh dim.  The rule functions read only axis names and sizes, so they take
a torch ``DeviceMesh`` or a shape-only :class:`AbstractMesh` alike.

:func:`constrain` and :func:`concat_unsharded` pin activation layouts at the
reference's sites: on a DTensor inside :func:`repro_torch.parallel.mesh_exec.mesh_scope`
they redistribute; on a plain tensor, or outside a scope, they are no-ops.
"""

from __future__ import annotations

import contextvars
import dataclasses
import warnings
from typing import Any

import torch

from repro_torch.telemetry import Counter

# logical axis -> preferred mesh axis (None = replicate)
DEFAULT_RULES: dict[str, Any] = {
    "embed": "data",  # FSDP
    "embed2": None,
    "mlp": "model",  # TP
    "mlp2": None,
    "heads": "model",
    "kv_heads": "model",
    "kv_heads_small": None,  # GQA with kv < TP width: replicate
    "vocab": "model",
    "experts": "model",  # EP
    "layers": None,
    "conv_in": None,
    "conv_out": None,
    "norm": None,
    None: None,
}

# Pure data parallelism + ZeRO-3 over the whole grid: no per-layer TP.
FSDP_RULES: dict[str, Any] = {
    **DEFAULT_RULES,
    "embed": ("data", "model"),
    "mlp": None,
    "heads": None,
    "kv_heads": None,
    "vocab": None,
    "experts": "model",
}

# Serving: weights replicated over ``data``, TP-sharded over ``model``.
SERVE_RULES: dict[str, Any] = {**DEFAULT_RULES, "embed": None}

# Serving TP for conv-dominated stages: channel-parallel convs ("conv_out"
# over ``model``), each shard computing a slice of the output channels.
SERVE_TP_RULES: dict[str, Any] = {**SERVE_RULES, "conv_out": "model"}

PROFILES = {
    "2d": {"rules": DEFAULT_RULES, "batch": ("pod", "data")},
    "fsdp": {"rules": FSDP_RULES, "batch": ("pod", "data", "model")},
    "serve": {"rules": SERVE_RULES, "batch": ("pod", "data")},
}

REPLICATION_FALLBACKS = Counter(
    "sharding_replication_fallbacks",
    "param dims that fell back to replication (dim % axis_size != 0)",
)
_warned_fallbacks: set = set()

_current_profile = "2d"

# The ambient mesh of ``mesh_exec.mesh_scope`` (None outside one).
_AMBIENT_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


def set_profile(name: str) -> None:
    global _current_profile
    if name not in PROFILES:
        raise KeyError(f"unknown sharding profile {name!r}; have {list(PROFILES)}")
    _current_profile = name


def current_profile() -> str:
    return _current_profile


def current_rules() -> dict:
    return PROFILES[_current_profile]["rules"]


def current_mesh():
    """The mesh of the enclosing ``mesh_scope``, or None."""
    return _AMBIENT_MESH.get()


# ---------------------------------------------------------------------------
# Meshes: names and sizes
# ---------------------------------------------------------------------------


class AbstractMesh:
    """A shape-only mesh, the counterpart of ``jax.sharding.AbstractMesh``:
    axis names and sizes, no devices and no process group."""

    def __init__(self, axis_sizes: tuple, axis_names: tuple):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"mesh sizes {axis_sizes} and names {axis_names} differ in rank")
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def check_mesh(mesh):
    """``mesh`` if it is None or a torch ``DeviceMesh`` with named axes;
    anything else raises."""
    from torch.distributed.device_mesh import DeviceMesh

    if mesh is not None and not (isinstance(mesh, DeviceMesh) and mesh.mesh_dim_names):
        raise TypeError(f"a mesh is a torch DeviceMesh with named axes "
                        f"(launch.mesh.make_debug_mesh), got {type(mesh).__name__}")
    return mesh


def axis_names(mesh) -> tuple:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` in mesh order (the reference's ``mesh.shape``)."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def batch_axes(mesh) -> tuple:
    """Mesh axes over which the batch dim shards (DP), per active profile."""
    want = PROFILES[_current_profile]["batch"]
    names = axis_names(mesh)
    return tuple(a for a in want if a in names)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    shape = mesh_shape(mesh)
    n = 1
    for a in axis if isinstance(axis, tuple) else (axis,):
        n *= shape[a]
    return n


# ---------------------------------------------------------------------------
# Specs, shardings, placements
# ---------------------------------------------------------------------------


def placements(spec: tuple, mesh) -> tuple:
    """A spec -> DTensor placements, one a mesh dim.  A tuple of mesh axes
    on one tensor dim becomes a ``Shard(d)`` on each of those mesh dims;
    DTensor splits such a dim major to minor in mesh-dim order, which is
    JAX's order when the tuple follows the mesh's (every rule's does)."""
    from torch.distributed.tensor import Replicate, Shard

    names, sizes = axis_names(mesh), mesh_shape(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in (entry if isinstance(entry, tuple) else (entry,))]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} does not follow the mesh's axis order {names}")
        for i in idx:
            # a shard over a mesh dim of one rank is the whole tensor: kept
            # replicated, which DTensor's view rules take on any dim
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: tuple

    def __post_init__(self):
        used = [a for e in self.spec if e is not None for a in (e if isinstance(e, tuple) else (e,))]
        dup = sorted({a for a in used if used.count(a) > 1})
        if dup:
            raise ValueError(f"a spec maps every mesh axis to at most one dim, but {self.spec} "
                             f"uses {dup} more than once")

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def spec_for(logical_axes: tuple, shape: tuple, mesh, rules: dict | None = None) -> tuple:
    """Logical axes + concrete shape -> spec, respecting divisibility (a
    dim that does not divide its axis stays replicated)."""
    rules = rules or current_rules()
    assert len(logical_axes) == len(shape), (logical_axes, shape)
    names = axis_names(mesh)
    out = []
    used: set = set()
    for name, dim in zip(logical_axes, shape):
        axis = rules.get(name, None)
        if axis is None:
            out.append(None)
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        if any(a not in names for a in axes) or any(a in used for a in axes):
            out.append(None)
            continue
        size = _axis_size(mesh, axis)
        if dim % size != 0:
            REPLICATION_FALLBACKS.inc()
            sig = (name, dim, axis, size)
            if sig not in _warned_fallbacks:
                _warned_fallbacks.add(sig)
                warnings.warn(
                    f"sharding: logical axis {name!r} (dim={dim}) does not "
                    f"divide mesh axis {axis!r} (size={size}); replicating. "
                    "Check engine.stats['mesh']['params'] for TP coverage.",
                    stacklevel=2,
                )
            out.append(None)
            continue
        out.append(axis)
        used.update(axes)
    return tuple(out)


def _leaves(params) -> dict:
    """``{key: tensor}`` of a module's declared leaves, or a dict as given."""
    if isinstance(params, torch.nn.Module):
        from repro_torch.nn import param_defs

        return {k: params.get_parameter(k) for k in param_defs(params)}
    return dict(params)


def logical_to_sharding(specs: dict, shapes: dict, mesh, rules=None) -> dict:
    """``{key: logical axes}`` + ``{key: tensor or shape}`` (or a module)
    -> ``{key: NamedSharding}``."""
    shapes = _leaves(shapes)
    return {k: NamedSharding(mesh, spec_for(tuple(specs[k]), tuple(getattr(v, "shape", v)),
                                            mesh, rules))
            for k, v in shapes.items()}


def _set_params(module: torch.nn.Module, values: dict) -> torch.nn.Module:
    """A shallow copy of ``module``'s tree whose declared parameters are
    ``values`` (by key); the source module is not touched."""

    def rec(mod, prefix):
        out = torch.nn.Module.__new__(type(mod))
        out.__dict__.update(mod.__dict__)
        params = {}
        for name, p in mod._parameters.items():
            key = f"{prefix}{name}"
            params[name] = (torch.nn.Parameter(values[key], requires_grad=p.requires_grad)
                            if key in values else p)
        out.__dict__["_parameters"] = params
        out.__dict__["_modules"] = {k: rec(c, f"{prefix}{k}.") for k, c in mod._modules.items()}
        return out

    return rec(module, "")


def distribute(x: torch.Tensor, mesh, spec: tuple):
    """``x`` (the full value, the same on every rank) as a DTensor with
    ``spec`` on ``mesh``: each rank keeps its own slice, no communication.
    A DTensor is first gathered whole (it may live on another mesh)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(x, DTensor):
        if x.device_mesh == mesh:
            return x.redistribute(mesh, placements(spec, mesh))
        x = x.full_tensor()
    return distribute_tensor(x.detach(), mesh, placements(spec, mesh), src_data_rank=None)


def shard_params_tree(params: torch.nn.Module, specs: dict, mesh, rules=None):
    """The pipeline module with every declared parameter a DTensor placed
    by the rules (a new module tree over the same buffers; ``params`` is
    left as it was)."""
    shardings = logical_to_sharding(specs, params, mesh, rules)
    leaves = _leaves(params)
    return _set_params(params, {k: distribute(leaves[k], mesh, s.spec)
                                for k, s in shardings.items()})


def _nbytes(x) -> int:
    n = 1
    for s in x.shape:
        n *= int(s)
    return n * torch.empty((), dtype=x.dtype).element_size()


def shard_report(params, specs: dict, mesh, rules=None) -> dict:
    """Sharded-vs-replicated byte accounting ("TP coverage") of a params
    tree (a module, or ``{key: tensor}``, ``meta`` ones included) under the
    given rules, as ``engine.stats["mesh"]["params"]`` reports it."""
    leaves = _leaves(params)
    shardings = logical_to_sharding(specs, leaves, mesh, rules)
    sharded = replicated_b = 0
    for k, x in leaves.items():
        if any(p is not None for p in shardings[k].spec):
            sharded += _nbytes(x)
        else:
            replicated_b += _nbytes(x)
    total = sharded + replicated_b
    return {
        "sharded_bytes": sharded,
        "replicated_bytes": replicated_b,
        "total_bytes": total,
        "tp_coverage": (sharded / total) if total else 0.0,
    }


# ---------------------------------------------------------------------------
# Activation layouts
# ---------------------------------------------------------------------------


def activation_spec(shape: tuple, spec_names: tuple, mesh) -> tuple:
    """The spec ``constrain`` pins: "batch" expands to the profile's batch
    axes; each entry keeps its largest prefix of unused axes whose product
    divides the dim (None if none does)."""
    names, sizes = axis_names(mesh), mesh_shape(mesh)
    parts = []
    used: set = set()
    for dim, name in zip(shape, spec_names):
        if name is None:
            parts.append(None)
            continue
        axes = batch_axes(mesh) if name == "batch" else (
            name if isinstance(name, tuple) else (name,))
        axes = tuple(a for a in axes if a in names and a not in used)
        while axes:
            n = 1
            for a in axes:
                n *= sizes[a]
            if dim % n == 0:
                break
            axes = axes[:-1]
        if not axes:
            parts.append(None)
            continue
        used.update(axes)
        parts.append(axes if len(axes) > 1 else axes[0])
    return tuple(parts) + (None,) * (len(shape) - len(parts))


_DTENSOR: list = []  # DTensor's class, imported at the first check


def is_dtensor(x) -> bool:
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor

        _DTENSOR.append(DTensor)
    return isinstance(x, _DTENSOR[0])


def reduce_partial(x):
    """A DTensor's partial sums reduced (its ``Partial`` mesh dims made
    ``Replicate``); anything else as it is.  A row-parallel product's output
    meets its bias this way: DTensor cannot make a sharded bias partial
    (torch 2.11), or reduce-scatters the sums onto whichever dim its costs
    pick, a batch the mesh axis does not divide among them (2.13)."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, tuple(Replicate() if p.is_partial() else p
                                               for p in x.placements))


def whole(x):
    """A DTensor's full value on every rank (a plain tensor as it is): the
    host reads of a stage's control values (cache position, budget)."""
    return x.full_tensor() if is_dtensor(x) else x


def constrain(x, spec_names: tuple):
    """Activation layout pin at the reference's sites: a DTensor inside a
    ``mesh_scope`` is redistributed to the spec ``activation_spec`` gives;
    anything else is returned as it is."""
    if current_mesh() is None or not is_dtensor(x):
        return x
    mesh = x.device_mesh
    want = placements(activation_spec(tuple(x.shape), spec_names, mesh), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def place(x: torch.Tensor, spec_names: tuple):
    """A plain tensor made inside a ``mesh_scope`` (the same global value on
    every rank: a zero cache) as a DTensor with the spec ``constrain`` would
    pin, each rank keeping its slice; anything else as it is."""
    mesh = current_mesh()
    if mesh is None or is_dtensor(x):
        return x
    return distribute(x, mesh, activation_spec(tuple(x.shape), spec_names, mesh))


def concat_unsharded(xs, axis: int = -1):
    """``torch.cat`` with the concatenated axis pinned unsharded (dim 0
    keeps its batch axes, every other dim replicated), inputs and output,
    as the reference's; a plain ``torch.cat`` outside a mesh scope."""
    xs = list(xs)
    nd = xs[0].ndim
    ax = axis % nd
    spec = tuple("batch" if (i == 0 and ax != 0) else None for i in range(nd))
    out = torch.cat([constrain(x, spec) for x in xs], dim=axis)
    return constrain(out, spec)


# ---------------------------------------------------------------------------
# Rules DTensor lacks
# ---------------------------------------------------------------------------

_RULES_INSTALLED: list = []


def install_dtensor_rules() -> None:
    """Register, once a process, the sharding rules the mesh path needs and
    DTensor does not give (``mesh_scope`` calls this):

      * a view that cannot carry a shard evenly (96 tokens split back into
        3 x 32 over a data axis of 2) takes the offending mesh dims
        ``Replicate`` first, the layout :func:`activation_spec` gives a dim
        its axes do not divide, where DTensor's strict view rule raises.
        XLA's partitioner reshards the reference's reshapes the same way.  A
        view DTensor can carry keeps its placements.
      * ``softplus``'s backward (the SSM's and RG-LRU's gates) is pointwise:
        the gradient follows ``grad_output``'s and the input's placements.
      * where DTensor has no rule, or no rule per mesh dim (torch 2.11):
        ``F.pad`` (the causal depthwise conv), ``flip`` (``cumsum``'s
        backward in the SSD scan) and ``roll`` (the ring-buffer cache) keep
        the shard of every dim they do not move, where 2.11 has none or a
        placeholder naming one mesh dim only; in-place ``index_put_`` (the
        MoE's dispatch) takes its out-of-place twin's rule; ``add`` (the
        backward's gradient sums) never asks to make a shard partial, which
        2.11's redistribution cannot do."""
    if _RULES_INSTALLED:
        return
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor.experimental import register_sharding

    aten = torch.ops.aten
    prop = DTensor._op_dispatcher.sharding_propagator
    per_dim = getattr(prop, "op_single_dim_strategy_funcs", {})
    for op in (aten.view.default, aten._unsafe_view.default):
        prop.register_op_strategy(op, _uneven_view_strategy(prop.op_strategy_funcs[op]),
                                  prop.op_to_schema_info.get(op))

    def padded(schema):
        pad, ndim = schema.args_schema[1], len(schema.args_schema[0].shape)
        return {ndim - 1 - i // 2 for i in range(0, len(pad), 2) if pad[i] or pad[i + 1]}

    def rolled(schema):
        dims = schema.args_schema[2] if len(schema.args_schema) > 2 else []
        return set(dims) if dims else None  # no dims: a roll of the flattened tensor

    def zero_pad(schema):
        return len(schema.args_schema) < 3 or schema.args_schema[2] == 0

    moving = {aten.constant_pad_nd.default: (padded, zero_pad),
              aten.flip.default: (lambda schema: set(schema.args_schema[1]), None),
              aten.roll.default: (rolled, None)}
    for op, (moved, linear) in moving.items():
        if op not in per_dim:
            prop.register_op_strategy(op, _unmoved_dims_strategy(moved, linear),
                                      RuntimeSchemaInfo(1))
    if aten.add.Tensor not in per_dim:
        prop.register_op_strategy(aten.add.Tensor,
                                  _no_shard_to_partial(prop.op_strategy_funcs[aten.add.Tensor]),
                                  prop.op_to_schema_info.get(aten.add.Tensor))
    if (aten.index_put_.default not in per_dim
            and aten.index_put_.default not in prop.op_strategy_funcs
            and aten.index_put.default in prop.op_strategy_funcs):
        prop.register_op_strategy(aten.index_put_.default,
                                  prop.op_strategy_funcs[aten.index_put.default],
                                  prop.op_to_schema_info.get(aten.index_put.default))

    @register_sharding(aten.softplus_backward.default)
    def _softplus_backward(grad_output, x, beta, threshold):
        # one mesh dim's choices, (output, inputs) alike: replicated, the
        # same dim sharded, or a partial gradient (linear in grad_output)
        del beta, threshold
        out = [([Replicate()], [Replicate(), Replicate(), None, None]),
               ([Partial()], [Partial(), Replicate(), None, None])]
        out += [([Shard(d)], [Shard(d), Shard(d), None, None]) for d in range(x.ndim)]
        return out

    _RULES_INSTALLED.append(True)


def _unmoved_dims_strategy(moved, linear=None):
    """The rule of an op that moves data along some dims of its one tensor
    input (``moved(schema)``, None: all of them): each mesh dim replicated,
    or sharded on a dim it does not move, or (where ``linear(schema)``, by
    default always) partial."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._ops.utils import expand_to_full_mesh_op_strategy

    def strategy(op_schema):
        x = op_schema.args_schema[0]
        ndim = len(x.shape)
        dims = moved(op_schema)
        dims = set(range(ndim)) if dims is None else {d % ndim for d in dims}
        choices = [[Replicate(), Replicate()]]
        choices += [[Shard(d), Shard(d)] for d in range(ndim) if d not in dims]
        if linear is None or linear(op_schema):
            choices.append([Partial(), Partial()])
        return expand_to_full_mesh_op_strategy(x.mesh, op_schema, choices, input_index=1)

    return strategy


def _no_shard_to_partial(rule):
    """DTensor's rule ``rule`` for a pointwise op without the choices that
    would turn an input's shard into a partial sum; where none is left and
    the inputs share a shape, each mesh dim on which an input is sharded
    takes that shard for every input and the output (a partial input is
    reduce-scattered onto it)."""
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSpec
    from torch.distributed.tensor._ops.utils import generate_redistribute_costs

    def strategy(op_schema):
        out = rule(op_schema)
        args = [a for a in op_schema.args_schema if hasattr(a, "strategies")]
        have = [a.strategies[0].output_spec for a in args]

        def wants(spec):
            return (spec.input_specs if spec.input_specs is not None
                    else [spec.output_spec] * len(args))

        def feasible(spec):
            return not any(w.placements[m].is_partial() and h.placements[m].is_shard()
                           for h, w in zip(have, wants(spec))
                           for m in range(len(h.placements)))

        kept = [s for s in out.strategies if feasible(s)]
        if kept or len({tuple(h.shape) for h in have}) != 1:
            out.strategies = kept or out.strategies
            return out
        pl = list(out.strategies[0].output_spec.placements)
        for m in range(len(pl)):
            shard = next((h.placements[m] for h in have if h.placements[m].is_shard()), None)
            if shard is not None:
                pl[m] = shard
        mesh = have[0].mesh
        ins = [DTensorSpec(mesh, tuple(pl), tensor_meta=h.tensor_meta) for h in have]
        out.strategies = [OpSpec(output_specs=DTensorSpec(mesh, tuple(pl)), input_specs=ins,
                                 redistribute_cost=[generate_redistribute_costs(a, i)
                                                    for a, i in zip(args, ins)])]
        return out

    return strategy


def _uneven_view_strategy(strict):
    """DTensor's strict view strategy ``strict``, retried where it raises with
    the fewest sharded mesh dims of the input made ``Replicate``."""
    import itertools

    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSchema, OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import generate_redistribute_costs

    def strategy(op_schema):
        try:
            return strict(op_schema)
        except RuntimeError as e:
            refused = e
        src = op_schema.args_schema[0]
        spec = src.strategies[0].output_spec
        sharded = [i for i, p in enumerate(spec.placements) if not (p.is_replicate()
                                                                   or p.is_partial())]
        for k in range(1, len(sharded) + 1):
            for drop in itertools.combinations(sharded, k):
                want = DTensorSpec(spec.mesh, tuple(Replicate() if i in drop else p
                                                    for i, p in enumerate(spec.placements)),
                                   tensor_meta=spec.tensor_meta)
                schema = OpSchema(op_schema.op, (OpStrategy([OpSpec(want)]),)
                                  + tuple(op_schema.args_schema[1:]),
                                  op_schema.kwargs_schema, schema_info=op_schema.schema_info)
                try:
                    out = strict(schema)
                except RuntimeError:
                    continue
                for s in out.strategies:
                    s.redistribute_cost = [generate_redistribute_costs(src, s.input_specs[0])]
                return out
        raise refused

    return strategy


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def data_sharding(mesh, *trailing) -> NamedSharding:
    """Batch-sharded activation: spec ((pod, data), *trailing)."""
    ba = batch_axes(mesh)
    lead = ba if len(ba) > 1 else (ba[0] if ba else None)
    return NamedSharding(mesh, (lead, *trailing))


def batch_sharding_for(mesh, global_batch: int, ndim: int, trailing: tuple = ()) -> NamedSharding:
    """Shard dim 0 over the largest prefix of the batch axes whose product
    divides ``global_batch``, else replicate."""
    ba = batch_axes(mesh)
    sizes = mesh_shape(mesh)
    for k in range(len(ba), 0, -1):
        axes = ba[:k]
        n = 1
        for a in axes:
            n *= sizes[a]
        if global_batch % n == 0:
            spec = [axes if len(axes) > 1 else axes[0]] + [None] * (ndim - 1)
            for i, t in enumerate(trailing):
                spec[i + 1] = t
            return NamedSharding(mesh, tuple(spec))
    return NamedSharding(mesh, (None,) * ndim)
