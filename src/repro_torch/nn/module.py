"""Module base: declared parameters under the reference's keys, seeded init,
and the weight bridge from a JAX parameter tree.

Every layer subclasses :class:`Module` (a ``torch.nn.Module``) and declares
each parameter with :meth:`Module.param` under the key the JAX layer's
``defs()`` gives it, in the JAX layout (HWIO conv kernels, ``(in, out)``
Dense kernels).  Sub-layers are registered under their ``defs()`` keys too,
so the port's ``state_dict`` keys are the JAX tree's paths joined by ``.``
and a flattened JAX tree loads with no transpose (:func:`from_jax_params`).

Layers are built on the ``meta`` device: building the full-size model costs
no memory, and :func:`init_params` / :func:`materialize` give it values.
"""

from __future__ import annotations

import dataclasses
import math
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
    """Declarative description of one parameter tensor."""

    shape: tuple[int, ...]
    init: Callable = normal_init()
    dtype: Any = torch.float32


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

    def param(self, name: str, shape: tuple, init: Callable, dtype) -> None:
        shape = tuple(int(s) for s in shape)
        self.param_defs[name] = ParamDef(shape, init, dtype)
        self.register_parameter(name, torch.nn.Parameter(
            torch.empty(shape, dtype=dtype, device="meta"), requires_grad=False))


def param_defs(module: torch.nn.Module) -> dict[str, ParamDef]:
    """Every declared parameter of ``module`` by its ``state_dict`` key."""
    out = {}
    for prefix, mod in module.named_modules():
        for name, d in getattr(mod, "param_defs", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = d
    return out


def init_params(module: torch.nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """Seeded CPU values for every declared parameter: the leaf at key
    ``a.b.c`` draws from a generator seeded by ``leaf_seed(seed, "/a/b/c")``
    (the JAX package's leaf path).  The bits differ from ``jax.random``."""
    out = {}
    for key, d in param_defs(module).items():
        gen = torch.Generator().manual_seed(leaf_seed(seed, "/" + key.replace(".", "/")))
        out[key] = d.init(gen, d.shape, d.dtype)
    return out


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
