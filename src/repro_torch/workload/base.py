"""The ``GenerativeWorkload`` protocol and its config-keyed registry, the
port of ``repro.workload.base``.

One API over the suite, as in the reference:

  * ``init(seed, device)``     -- the pipeline module with seeded parameters
  * ``load(state, device)``    -- the same module from a state dict (for
    example one bridged from JAX by ``repro_torch.nn.from_jax_params``)
  * ``prepare_request(...)``   -- modality-specific inputs -> ``GenRequest``
  * ``generate(params, tokens, seed)`` -- the canonical stage composition:
    ``init_stage_state`` -> the descriptor's stages via ``run_stage`` ->
    ``stage_output``; there is no other pipeline driver
  * ``cost_descriptor()``      -- the stage/step structure
  * ``trace_events(impl)``     -- the operator event stream of one
    representative generate, traced on ``meta`` (``core.characterize``)

``params`` is the materialised pipeline module (what ``init``/``load``
return), the counterpart of the reference's parameter tree.  Entry points
run on ``device="cuda"`` unless the caller passes another device.

Per-request randomness follows the reference's contract: a stage's noise
for a request depends only on ``(seed, rid, stage_index)``
(:func:`stage_generator`), never on the batch it rides in.

Routes, as the reference's taxonomy: the *workload* route
(``WORKLOAD_ROUTES``) names the scheduler family a workload's requests
belong to, ``"lm"`` (bucketed prefill + decode) or ``"pod"`` (staggered
denoise pods); the *serve* route (``SERVE_ROUTES``) is how
``serving.ServeEngine`` runs them, those two or ``"cascade"`` (the
stage-level pipeline).  Every serve route runs the one stage loop,
``generate_requests``.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import tracer
from repro_torch.kernels.tiers import resolve_model_impl
from repro_torch.nn import init_module, materialize, specs_of
from repro_torch.nn.module import _stable_hash

WORKLOAD_ROUTES = ("lm", "pod")
SERVE_ROUTES = ("lm", "pod", "cascade")
SLO_TIERS = ("interactive", "batch")


def default_slo_tier(modality: str) -> str:
    return "batch" if modality == "video" else "interactive"


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return dev


def params_device(params) -> torch.device:
    """The device of a materialised pipeline module's parameters."""
    return next(params.parameters()).device


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU): a host
    clock read after it measures the work, not its launch."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Per-request PRNG contract
# ---------------------------------------------------------------------------


def stage_generator(seed: int, rid: int, stage_index: int) -> torch.Generator:
    """The per-request generator of one stage: seeded from ``(seed, rid,
    stage_index)`` only, so batch composition never changes a sample."""
    return torch.Generator().manual_seed(
        _stable_hash(f"{int(seed)}/{int(rid)}/{int(stage_index)}"))


def stage_noise(gens: list, shape: tuple, dtype, device) -> torch.Tensor:
    """Stacked standard normals, one ``shape`` draw per request generator
    (drawn on the CPU so a seed gives the same noise on every device)."""
    return torch.stack([torch.randn(shape, generator=g, dtype=torch.float32)
                        for g in gens]).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Uniform request / cost views
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GenRequest:
    """One generation request, uniform across modalities."""

    rid: int
    modality: str  # "text" | "image" | "video"
    route: str  # workload route: "lm" | "pod"
    tokens: Any  # (S,) int32 prompt / text-conditioning ids
    max_new_tokens: int = 0
    denoise_steps: int = 0
    slo_tier: str = "interactive"
    deadline_ticks: int | None = None
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.route not in WORKLOAD_ROUTES:
            raise ValueError(f"unknown workload route {self.route!r} "
                             f"(expected one of {WORKLOAD_ROUTES})")
        if self.slo_tier not in SLO_TIERS:
            raise ValueError(f"unknown SLO tier {self.slo_tier!r} (expected one of {SLO_TIERS})")
        if self.deadline_ticks is not None and self.deadline_ticks <= 0:
            raise ValueError(f"deadline_ticks must be > 0 or None, got {self.deadline_ticks}")

    @property
    def prompt_len(self) -> int:
        return int(np.shape(self.tokens)[-1])


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage: ``steps`` executions of its graph; ``seq_len`` a
    representative attention sequence length; ``demand`` an optional
    per-tick relative HBM-demand profile inside the stage (the UNet's
    U-shape), which the serving scheduler's stagger reads."""

    name: str
    steps: int
    seq_len: int
    demand: tuple = ()


@dataclasses.dataclass(frozen=True)
class CostDescriptor:
    arch: str
    route: str
    stages: tuple

    def __post_init__(self):
        if self.route not in WORKLOAD_ROUTES:
            raise ValueError(f"unknown workload route {self.route!r} for {self.arch!r}")

    def iterative_steps(self) -> int:
        return max((s.steps for s in self.stages), default=1)

    def step_demands(self) -> list:
        """Relative per-tick HBM demand across the iterative stages.  Stages
        without a profile contribute their (flat) ``seq_len``; one-shot
        stages (text encoder, VAE) none."""
        out: list = []
        for s in self.stages:
            if s.steps <= 1 and not s.demand:
                continue
            prof = list(s.demand) if s.demand else [s.seq_len]
            reps = max(1, s.steps // max(len(prof), 1))
            out += (prof * reps)[: max(s.steps, len(prof))]
        return out or [1.0]


# ---------------------------------------------------------------------------
# Batched stage state
# ---------------------------------------------------------------------------


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of equally shaped trees of dicts, lists
    and tuples (a NamedTuple such as ``AttentionCache`` keeps its type), as
    ``jax.tree.map``."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        out = [tree_map(fn, *xs) for xs in zip(*trees)]
        if isinstance(t, list):
            return out
        return type(t)(*out) if hasattr(t, "_fields") else tuple(out)
    return fn(*trees)


def tree_leaves(tree) -> list:
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def stack_states(states: list):
    """Per-request (unbatched) states -> one batched state, the batch axis
    first in every leaf."""
    return tree_map(lambda *xs: torch.stack(xs), *states)


def split_state(state, n: int) -> list:
    """Batched state -> n per-request (unbatched) views."""
    return [tree_map(lambda x: x[i], state) for i in range(n)]


def resolve_stage_impls(stages, impl: str, stage_impl: dict | None) -> list[str]:
    """Per-stage tier: ``stage_impl`` overrides ``impl`` by exact stage name,
    then by the longest matching prefix; keys matching no stage raise."""
    stage_impl = dict(stage_impl or {})
    names = [s.name for s in stages]
    unused = [k for k in stage_impl if not any(n == k or n.startswith(k) for n in names)]
    if unused:
        raise ValueError(f"stage_impl keys {sorted(unused)} match no stage (stages: {names})")
    out = []
    for name in names:
        if name in stage_impl:
            out.append(stage_impl[name])
            continue
        prefixes = [k for k in stage_impl if name.startswith(k)]
        out.append(stage_impl[max(prefixes, key=len)] if prefixes else impl)
    return out


# ---------------------------------------------------------------------------
# Protocol
# ---------------------------------------------------------------------------


class GenerativeWorkload:
    route: str = "pod"
    modality: str = "image"

    def __init__(self, cfg):
        if self.route not in WORKLOAD_ROUTES:
            raise ValueError(f"{type(self).__name__}.route={self.route!r} is not a workload route")
        self.cfg = cfg
        self.model = self.build_model(cfg)  # parameters on "meta": structure only

    def build_model(self, cfg) -> torch.nn.Module:
        raise NotImplementedError

    def init(self, seed: int, device="cuda", mesh=None) -> torch.nn.Module:
        """The pipeline module with seeded parameters on ``device``: the
        values of ``nn.init_params(self.model, seed)``, drawn leaf by leaf
        onto the device (``nn.init_module``); with a ``mesh``, sharded once
        here (:meth:`shard_params`), the serving path's one sharding point."""
        params = init_module(copy.deepcopy(self.model), seed, resolve_device(device))
        return params if mesh is None else self.shard_params(params, mesh)

    def shard_params(self, params, mesh):
        """``params`` with every leaf a DTensor on ``mesh`` under the serving
        TP rules (weights replicated over ``data``, TP-sharded over
        ``model``, channel-parallel convs).  Dims that do not divide their
        axis replicate, with a warning and a count
        (``parallel.sharding.REPLICATION_FALLBACKS``)."""
        from repro_torch.parallel.sharding import SERVE_TP_RULES, shard_params_tree

        return shard_params_tree(params, specs_of(self.model), mesh, SERVE_TP_RULES)

    def load(self, state: dict, device="cuda") -> torch.nn.Module:
        """The pipeline module with parameters from ``state`` on ``device``."""
        return materialize(copy.deepcopy(self.model), state, resolve_device(device))

    def reduced(self):
        raise NotImplementedError

    def cost_descriptor(self) -> CostDescriptor:
        raise NotImplementedError

    @property
    def prompt_vocab(self) -> int:
        """Vocab to draw conditioning prompt ids from."""
        return self.cfg.text.vocab

    @property
    def max_prompt_len(self) -> int:
        return self.cfg.text.max_len

    def prepare_request(self, rid: int, tokens, *, max_new_tokens: int = 0,
                        slo_tier: str | None = None, deadline_ticks: int | None = None,
                        **meta) -> GenRequest:
        cd = self.cost_descriptor()
        return GenRequest(
            rid=rid, modality=self.modality, route=self.route,
            tokens=np.asarray(tokens, np.int32), max_new_tokens=max_new_tokens,
            denoise_steps=cd.iterative_steps() if self.route == "pod" else 0,
            slo_tier=default_slo_tier(self.modality) if slo_tier is None else slo_tier,
            deadline_ticks=deadline_ticks, meta=meta)

    def generate(self, params, tokens, seed: int, *, impl: str = "auto", device="cuda",
                 max_new_tokens=0, temperature: float = 0.0, rids=None,
                 stage_impl: dict | None = None,
                 on_stage: Callable | None = None, mesh=None) -> torch.Tensor:
        """Batched full-pipeline inference: (B, S) tokens -> stacked output.
        With a ``mesh`` (a torch ``DeviceMesh``, ``params`` sharded on it by
        :meth:`shard_params`) every stage runs SPMD over it, the batch
        sharded and the weights TP-sharded; outputs do not depend on the
        mesh (``parallel.mesh_exec``)."""
        return torch.stack(self.generate_requests(
            params, tokens, seed, impl=impl, device=device, max_new_tokens=max_new_tokens,
            temperature=temperature, rids=rids, stage_impl=stage_impl, on_stage=on_stage,
            mesh=mesh))

    @torch.inference_mode()
    def generate_requests(self, params, tokens, seed: int, *, impl: str = "auto",
                          device="cuda", max_new_tokens=0, temperature: float = 0.0,
                          rids=None, stage_impl: dict | None = None,
                          on_stage: Callable | None = None, mesh=None) -> list:
        """The loop behind :meth:`generate`, returning per-request outputs:
        the one stage loop of every serve route.  ``max_new_tokens`` is the LM
        decode budget, one for the batch or one a request (the other
        workloads ignore it); ``temperature`` the LM sampling temperature (0:
        greedy).  ``on_stage(name, wall_s, batch)`` is called after each
        stage, with the wall time up to a device synchronisation.  Each stage
        runs under ``tracer.scope(stage.name)``; ``tokens`` may be a tensor
        (a ``meta`` one under :meth:`trace_events`)."""
        stages, impls = self._stage_plan(impl, stage_impl)
        dev = resolve_device(device)
        p_dev = params_device(params)
        if p_dev.type != dev.type or dev.index not in (None, p_dev.index):
            raise ValueError(f"params live on {p_dev}, generate asked for {dev}")
        tokens = (tokens.to(torch.int64) if isinstance(tokens, torch.Tensor)
                  else torch.as_tensor(np.asarray(tokens), dtype=torch.int64))
        B = int(tokens.shape[0])
        rids = list(range(B)) if rids is None else list(rids)
        if len(rids) != B:
            raise ValueError(f"got {len(rids)} rids for batch of {B}")
        mnt = (list(max_new_tokens) if np.ndim(max_new_tokens)
               else [int(max_new_tokens)] * B)
        state = stack_states([self.init_stage_state(tokens[i], p_dev, max_new_tokens=mnt[i])
                              for i in range(B)])
        # forwarded only when set, so mesh-free run_stage doubles keep working
        mesh_kw = {} if mesh is None else {"mesh": mesh}
        for idx, stage in enumerate(stages):
            gens = [stage_generator(seed, rid, idx) for rid in rids]
            t0 = time.perf_counter()
            with tracer.scope(stage.name):
                state = self.run_stage(params, stage, state, gens, impl=impls[idx],
                                       temperature=temperature, **mesh_kw)
            if on_stage is not None:
                synchronize(p_dev)
                on_stage(stage.name, time.perf_counter() - t0, B)
        return [self.stage_output(s) for s in split_state(state, B)]

    def _stage_plan(self, impl: str, stage_impl: dict | None):
        """(stages, the ``impl`` string each stage runs under): the caller's
        or its ``stage_impl`` override, passed on unchanged (the dispatchers
        resolve the tier, ``resolve_model_impl``; the tracer's events read
        the string); an unknown string raises here."""
        stages = self.cost_descriptor().stages
        impls = resolve_stage_impls(stages, impl, stage_impl)
        for i in impls:
            resolve_model_impl(i)
        return stages, impls

    def init_stage_state(self, tokens, device, *, max_new_tokens: int = 0) -> dict:
        """Per-request state entering the first stage (no batch axis)."""
        del max_new_tokens  # the LM workload keeps it; pod workloads do not
        return {"tokens": torch.as_tensor(tokens, dtype=torch.int64).to(device)}

    def run_stage(self, params, stage: Stage, state: dict, gens: list, *,
                  impl: str = "auto", temperature: float = 0.0, mesh=None) -> dict:
        """Execute one ``stage`` over batched ``state``; ``gens`` holds one
        :func:`stage_generator` per request; ``temperature`` is the sampling
        temperature of token-sampling stages (the others ignore it).  With
        a ``mesh`` implementations delegate to
        ``parallel.mesh_exec.run_stage_on_mesh``, which shards the batch and
        re-enters the same body inside ``mesh_scope``."""
        raise NotImplementedError

    def stage_group_key(self, stage: Stage, state: dict):
        """Extra batch-compatibility key of ``stage`` over an unbatched
        ``state``, beyond its shapes and dtypes (the LM's decode merges
        requests at one cache position only).  None: shapes only."""
        return None

    def stage_output(self, state: dict):
        return state["out"]

    # -- characterization ------------------------------------------------------

    def trace_inputs(self) -> tuple:
        """``generate``'s prompt under tracing: a ``meta`` (1, max_prompt_len)."""
        return (torch.empty((1, self.max_prompt_len), dtype=torch.int64, device="meta"),)

    def trace_events(self, impl: str = "auto") -> list:
        """The operator event stream of one ``generate`` of the full model,
        traced on ``meta`` (loops stand one pass for all, scaled).  ``impl``
        is passed as the caller gives it: the events follow the string
        (``tiers.event_impl``)."""
        from repro_torch.core import characterize

        (toks,) = self.trace_inputs()
        return characterize.trace_workload(
            lambda p, t: self.generate(p, t, 0, impl=impl, device="meta"),
            characterize.abstract_params(self.model), toks)


# ---------------------------------------------------------------------------
# Registry (keyed by config type)
# ---------------------------------------------------------------------------

_WORKLOADS: dict[type, type] = {}


def register_workload(*config_types) -> Callable:
    def deco(cls):
        for t in config_types:
            _WORKLOADS[t] = cls
        return cls

    return deco


def workload_for(cfg) -> GenerativeWorkload:
    for t in type(cfg).__mro__:
        if t in _WORKLOADS:
            return _WORKLOADS[t](cfg)
    raise TypeError(f"no GenerativeWorkload registered for {type(cfg).__name__}; "
                    f"known: {sorted(t.__name__ for t in _WORKLOADS)}")


def reduced_workload(cfg) -> GenerativeWorkload:
    """Config -> workload over its reduced config (the CPU test path)."""
    return workload_for(workload_for(cfg).reduced())
