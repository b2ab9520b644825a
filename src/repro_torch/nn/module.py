"""Module base: declared parameters under the reference's keys, seeded init,
and the weight bridge from a JAX parameter tree.

Every layer subclasses :class:`Module` (a ``torch.nn.Module``) and declares
each parameter with :meth:`Module.param` under the key the JAX layer's
``defs()`` gives it, in the JAX layout (HWIO conv kernels, ``(in, out)``
Dense kernels).  Sub-layers are registered under their ``defs()`` keys too,
so the port's ``state_dict`` keys are the JAX tree's paths joined by ``.``
and a flattened JAX tree loads with no transpose (:func:`from_jax_params`).

Layers are built on the ``meta`` device: building the full-size model costs
no memory, and :func:`init_params` / :func:`materialize` give it values;
:func:`init_module` draws the seeded values leaf by leaf straight onto the
device, so the host never holds the whole state dict.  Parameters are
declared with ``requires_grad=False`` (inference needs no graph);
:func:`trainable` turns it on for every declared leaf of a built module
and returns them by name, the dict the optimizer and the checkpointer take.

A stack of identical layers keeps the reference's scanned layout: every
parameter of the layer gains a leading layer axis under the layer's own keys
(:func:`stack_params`, as ``repro.models.transformer._stack_defs``), and
:func:`layer_views` gives each layer as a module whose parameters are views
of its slice.
"""

from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
import math
import os
from typing import Any, Callable, Mapping

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Initializers: f(generator, shape, dtype) -> CPU tensor, the init families
# of repro.nn.module
# ---------------------------------------------------------------------------


def zeros_init(gen, shape, dtype):
    del gen
    return torch.zeros(shape, dtype=dtype)


def ones_init(gen, shape, dtype):
    del gen
    return torch.ones(shape, dtype=dtype)


def normal_init(stddev: float = 0.02) -> Callable:
    def init(gen, shape, dtype):
        return (stddev * torch.randn(shape, generator=gen, dtype=torch.float32)).to(dtype)

    return init


def scaled_init(fan_in_axes: tuple[int, ...] = (0,)) -> Callable:
    """LeCun-normal style init: stddev = 1/sqrt(fan_in)."""

    def init(gen, shape, dtype):
        fan_in = max(1, int(np.prod([shape[a] for a in fan_in_axes])))
        return ((1.0 / math.sqrt(fan_in))
                * torch.randn(shape, generator=gen, dtype=torch.float32)).to(dtype)

    return init


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative description of one parameter tensor.  ``layers`` > 0
    marks a stacked leaf: ``shape[0]`` is the layer axis, and each layer's
    slice draws ``init`` at ``shape[1:]`` in turn from the leaf's generator
    (the fan-in is the layer's, as the reference's ``vmap`` of the layer's
    init gives it)."""

    shape: tuple[int, ...]
    init: Callable = normal_init()
    dtype: Any = torch.float32
    layers: int = 0
    axes: tuple = ()

    def __post_init__(self):
        if not self.axes:
            object.__setattr__(self, "axes", (None,) * len(self.shape))
        if len(self.axes) != len(self.shape):
            raise ValueError(f"ParamDef shape {self.shape} and axes {self.axes} rank mismatch")

    def draw(self, gen: torch.Generator, out: torch.Tensor | None = None) -> torch.Tensor:
        """The leaf's values from ``gen``, written into ``out`` (any device)
        where given, one layer at a time for a stacked leaf."""
        if not self.layers:
            val = self.init(gen, self.shape, self.dtype)
            return val if out is None else out.copy_(val)
        out = torch.empty(self.shape, dtype=self.dtype) if out is None else out
        for j in range(self.layers):
            out[j].copy_(self.init(gen, self.shape[1:], self.dtype))
        return out


def _stable_hash(s: str) -> int:
    # FNV-1a, deterministic across processes (as repro.nn.module._stable_hash).
    h = 2166136261
    for ch in s.encode():
        h = (h ^ ch) * 16777619 & 0xFFFFFFFF
    return h


def leaf_seed(seed: int, path: str) -> int:
    """Seed of one leaf's generator: the root seed and the leaf's path, so a
    leaf's init does not depend on the order of the tree.  (The CPU
    generator keeps 32 bits of its seed, so both go through one hash.)"""
    return _stable_hash(f"{int(seed)}:{path}")


# ---------------------------------------------------------------------------
# Module base
# ---------------------------------------------------------------------------


class Module(torch.nn.Module):
    """``torch.nn.Module`` whose parameters are declared with a ``ParamDef``."""

    def __init__(self):
        super().__init__()
        self.param_defs: dict[str, ParamDef] = {}

    def param(self, name: str, shape: tuple, init: Callable, dtype, layers: int = 0, *,
              axes: tuple = ()) -> None:
        """Declare ``name``; ``axes`` are its logical axis names, one a dim
        (the reference's ``ParamDef.axes``; all None when not given), which
        ``parallel.sharding`` maps onto a mesh."""
        shape = tuple(int(s) for s in shape)
        self.param_defs[name] = ParamDef(shape, init, dtype, layers, tuple(axes))
        self.register_parameter(name, torch.nn.Parameter(
            torch.empty(shape, dtype=dtype, device="meta"), requires_grad=False))


def stack_params(module: torch.nn.Module, n: int) -> torch.nn.Module:
    """``module`` (on ``meta``) with every declared parameter re-declared
    with a leading axis of ``n`` layers, in place: the reference's scanned
    layout (``blocks/g0_dense/attn/wq/kernel`` of shape ``(n, in, out)``),
    so a JAX tree bridges with no restacking."""
    for mod in module.modules():
        for name, d in list(getattr(mod, "param_defs", {}).items()):
            mod.param(name, (n, *d.shape), d.init, d.dtype, layers=n, axes=("layers", *d.axes))
    return module


def layer_views(module: torch.nn.Module, n: int) -> list:
    """The ``n`` layers of a module built by :func:`stack_params`: shallow
    copies of its module tree whose parameters are plain attributes holding
    views of slice ``j`` (no copy; nothing registered, so the views add no
    ``state_dict`` keys).  Each leaf is split by one ``unbind``, whose
    backward stacks the layers' gradients once (a view a layer, ``p[j]``,
    would write a zero-filled whole stack for each layer's gradient: bytes
    quadratic in the depth)."""
    slices: dict = {}

    def view(mod, j):
        if id(mod) not in slices:
            slices[id(mod)] = {name: p.unbind(0) for name, p in mod._parameters.items()}
        out = copy.copy(mod)
        out.__dict__["_parameters"] = {}
        for name, parts in slices[id(mod)].items():
            out.__dict__[name] = parts[j]
        out.__dict__["_modules"] = {k: view(c, j) for k, c in mod._modules.items()}
        return out

    return [view(module, j) for j in range(n)]


def trainable(module: torch.nn.Module) -> dict[str, torch.nn.Parameter]:
    """Every declared leaf of a built ``module``, by its ``state_dict`` key,
    with ``requires_grad`` turned on: all of them train, as the reference's
    ``value_and_grad`` over the whole tree (a leaf the loss does not reach
    gets a zero gradient there; see ``training.optimizer``).  A stacked
    leaf trains through the per-layer views its forward takes.  Values
    drawn or loaded under ``torch.inference_mode`` cannot be saved for
    backward: load outside it."""
    out = {}
    for key in param_defs(module):
        p = module.get_parameter(key)
        if p.device.type == "meta":
            raise ValueError(f"{key} is on meta: build the module's values first "
                             f"(init_module, materialize)")
        if p.is_inference():
            raise ValueError(f"{key} was made under torch.inference_mode and cannot train: "
                             f"load it outside inference mode")
        out[key] = p.requires_grad_(True)
    return out


def param_defs(module: torch.nn.Module) -> dict[str, ParamDef]:
    """Every declared parameter of ``module`` by its ``state_dict`` key."""
    out = {}
    for prefix, mod in module.named_modules():
        for name, d in getattr(mod, "param_defs", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = d
    return out


def count_params(params) -> int:
    """Elements over every declared leaf of a module (its shapes: a module
    on ``meta`` counts), or over the tensors of a ``{key: tensor}`` dict."""
    if isinstance(params, torch.nn.Module):
        return sum(math.prod(d.shape) for d in param_defs(params).values())
    return sum(t.numel() for t in params.values())


def specs_of(module: torch.nn.Module) -> dict[str, tuple]:
    """The logical axis names of every declared parameter by its
    ``state_dict`` key (the reference's ``specs()``, flattened)."""
    return {key: d.axes for key, d in param_defs(module).items()}


def _leaf_generator(seed: int, key: str) -> torch.Generator:
    return torch.Generator().manual_seed(leaf_seed(seed, "/" + key.replace(".", "/")))


def init_params(module: torch.nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """Seeded CPU values for every declared parameter: the leaf at key
    ``a.b.c`` draws from a generator seeded by ``leaf_seed(seed, "/a/b/c")``
    (the JAX package's leaf path).  The bits differ from ``jax.random``."""
    return {key: d.draw(_leaf_generator(seed, key)) for key, d in param_defs(module).items()}


def init_module(module: torch.nn.Module, seed: int, device):
    """``module`` (built on ``meta``) with the values of
    ``init_params(module, seed)``, drawn leaf by leaf straight into tensors
    on ``device``: the host holds one layer of each leaf in flight, never the
    state dict (Parti's is 43.8 GB in bf16).  A thread per CPU core (at most
    8) draws the leaves; each leaf keeps its own generator, so the values do
    not depend on the order or the number of threads."""
    dev = torch.device(device)
    defs = param_defs(module)
    state = {k: torch.empty(d.shape, dtype=d.dtype, device=dev) for k, d in defs.items()}

    def fill(key):
        defs[key].draw(_leaf_generator(seed, key), state[key])

    with concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        for f in [pool.submit(fill, k) for k in defs]:
            f.result()
    module.load_state_dict(state, strict=True, assign=True)
    return module.eval()


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    out = {}
    for name, sub in tree.items():
        key = f"{prefix}.{name}" if prefix else name
        if isinstance(sub, Mapping):
            out.update(flatten_tree(sub, key))
        else:
            out[key] = sub
    return out


def from_jax_params(tree: Mapping[str, Any], device="cpu") -> dict[str, torch.Tensor]:
    """The weight bridge: a JAX parameter tree with numpy leaves -> the
    port's state dict (keys joined by ``.``), on ``device``.  Layouts are
    shared, so no leaf is transposed."""
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in flatten_tree(tree).items()}


def materialize(module: torch.nn.Module, state: Mapping[str, torch.Tensor], device):
    """``module`` (built on ``meta``) with every declared parameter set from
    ``state``, on ``device``.  Keys must match exactly, shapes and dtypes too."""
    defs = param_defs(module)
    missing, extra = defs.keys() - state.keys(), state.keys() - defs.keys()
    if missing or extra:
        raise KeyError(f"parameter keys differ: missing {sorted(missing)[:5]}, "
                       f"unexpected {sorted(extra)[:5]}")
    for key, d in defs.items():
        t = state[key]
        if tuple(t.shape) != d.shape:
            raise ValueError(f"{key}: shape {tuple(t.shape)} != {d.shape}")
        if t.dtype != d.dtype:
            raise TypeError(f"{key}: dtype {t.dtype} != {d.dtype}")
    module.load_state_dict({k: state[k].to(device) for k in defs}, strict=True, assign=True)
    return module.eval()
