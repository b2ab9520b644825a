"""The port's serving stack against the JAX package's, on the CPU.

The JAX ``ServeEngine`` is the oracle, on its ``auto`` tier (``xla`` /
``blocked_jax`` on the CPU), over the same seeded parameters handed to JAX
as is and bridged unchanged into the port:

- ``ArrivalTrace.ticks``: the same seeded numpy draws give the same ticks;
- ``TINY_TTI_CASCADE`` on the cascade route under a poisson trace, with each
  admission policy: the same dispatches, per-request completion ticks,
  stagger profiles and tick-valued stats, and the same key tree of
  ``stats``;
- reduced ``llama2-7b`` on the lm and cascade routes: greedy tokens equal to
  the JAX engine's live output (never to constants pinned earlier), and the
  same padding waste and ticks.

One module-scoped fixture runs every JAX engine of the file.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs.suite  # noqa: F401  (registers the suite)
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.configs import tiny as j_tiny
from repro.serving import ArrivalTrace as JArrivalTrace
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro.workload import workload_for as j_workload_for
from repro_torch.configs import get_config
from repro_torch.configs import tiny as t_tiny
from repro_torch.nn import from_jax_params, init_params
from repro_torch.serving import PATTERNS, ArrivalTrace, ServeConfig, ServeEngine
from repro_torch.workload import reduced_workload, workload_for

N_TTI, POD = 3, 2
LM_LENGTHS = (5, 12, 7, 3, 14)  # two buckets of (8, 16)
LM_NEW = 6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny models: under several test
    workers, 8 threads a worker oversubscribe the cores ~10x.  Restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(state: dict, seed: int = 3) -> dict:
    """The port's flat state dict as a nested numpy tree (JAX's layout),
    every norm scale drawn around 1 so that no leaf is trivial."""
    rng = np.random.default_rng(seed)
    tree = {}
    for k, v in state.items():
        *path, leaf = k.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        v = v.numpy()
        if leaf == "scale":
            v = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        node[leaf] = v
    return tree


def _bridge(twl):
    """(JAX params, the port's params on the CPU) of one seeded tree."""
    tree = _tree(init_params(twl.model, 0))
    return jax.tree.map(jnp.asarray, tree), twl.load(from_jax_params(tree), "cpu")


def _tti_requests():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, t_tiny.TINY_TEXT.vocab, size=int(rng.integers(4, 9)))
               for _ in range(N_TTI)]
    return prompts, ArrivalTrace("poisson", rate=0.5, seed=0).ticks(N_TTI)


def _lm_prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, size=n) for n in LM_LENGTHS]


def _drive(eng, prompts, arrivals=None, max_new=0):
    """Submit, step to the end; (outputs, completion tick of each rid)."""
    for rid, p in enumerate(prompts):
        eng.submit(rid, p, max_new, arrival_tick=0 if arrivals is None else arrivals[rid])
    out, done = {}, {}
    while eng.pending():
        tick = eng._tick
        for rid, o in eng.step():
            out[rid], done[rid] = o, tick
    return out, done


def _tti_config(cfg_cls, admission):
    # handoff queues as deep as a pod: every stage batch holds 1 or 2
    # requests, so JAX compiles each stage at two batch sizes only
    return cfg_cls(max_batch=POD, buckets=(8,), route="cascade", admission=admission,
                   arrival_flush_wait=1, queue_capacity=POD)


def _lm_config(cfg_cls, route):
    return cfg_cls(max_batch=2, buckets=(8, 16), route=route)


@pytest.fixture(scope="module")
def jax_runs():
    """Every JAX engine run of this file: the tiny cascade under each
    admission policy, reduced LLaMA on the lm and cascade routes."""
    out = {}
    twl = workload_for(t_tiny.TINY_TTI_CASCADE)
    jparams, tparams = _bridge(twl)
    prompts, ticks = _tti_requests()
    jwl = j_workload_for(j_tiny.TINY_TTI_CASCADE)  # one workload: its compiled shapes are shared
    for admission in ("continuous", "pod"):
        eng = JServeEngine(jwl, jparams, _tti_config(JServeConfig, admission))
        out["tti", admission] = (eng, *_drive(eng, prompts, ticks))
    out["tti_params"] = tparams
    lwl = reduced_workload(get_config("llama2-7b"))
    jparams, tparams = _bridge(lwl)
    jwl = j_workload_for(j_reduced(j_get_config("llama2-7b")))
    for route in ("auto", "cascade"):
        eng = JServeEngine(jwl, jparams, _lm_config(JServeConfig, route))
        out["lm", route] = (eng, *_drive(eng, _lm_prompts(lwl.prompt_vocab), max_new=LM_NEW))
    out["lm_params"] = tparams
    return out


# ---------------------------------------------------------------------------
# Arrival traces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_arrival_ticks_equal_the_reference(pattern, seed):
    kw = dict(rate=0.7, burst_size=3, burst_gap=2, concurrency=2, period=8, amplitude=0.6,
              seed=seed)
    assert ArrivalTrace(pattern, **kw).ticks(24) == JArrivalTrace(pattern, **kw).ticks(24)


# ---------------------------------------------------------------------------
# The tiny cascade: the same schedule
# ---------------------------------------------------------------------------


def _key_tree(d):
    """The nested keys of a stats dict; tier names (the packages name their
    tiers differently) become one placeholder."""
    if not isinstance(d, dict):
        return None
    return {("<tier>" if k in ("kernel", "torch", "auto", "xla", "interpret", "pallas")
             else k): _key_tree(v) for k, v in d.items()}


def _same(a, b, path="stats"):
    """Nested dicts and lists equal, numbers to float rounding."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-12, abs=1e-12), path
    else:
        assert a == b, path


def _tick_fields(stats):
    """Every tick-valued or count-valued field of a drained cascade engine's
    stats (the wall-time fields dropped)."""
    c = stats["cascade"]
    return dict(
        requests=stats["requests"], pods=stats["pods"], latency=stats["request_latency_ticks"],
        clock={k: stats["clock"][k] for k in ("ticks", "busy_ticks", "source")},
        ticks=c["ticks"], submitted=c["submitted"], completed=c["completed"],
        parked=c["parked"], resumed=c["resumed"], concurrency=c["concurrency"],
        admission=c["admission"], cascade_latency=c["request_latency_ticks"], hbm=c["hbm"],
        stages={n: {k: st[k] for k in ("batches", "items", "mean_batch", "max_batch", "queue",
                                       "queue_wait_ticks", "impl")}
                for n, st in c["stages"].items()})


@pytest.mark.parametrize("admission", ["continuous", "pod"])
def test_tiny_cascade_schedule_equals_the_reference(jax_runs, admission):
    jeng, jout, jdone = jax_runs["tti", admission]
    twl = workload_for(t_tiny.TINY_TTI_CASCADE)
    eng = ServeEngine(twl, jax_runs["tti_params"], _tti_config(ServeConfig, admission))
    prompts, ticks = _tti_requests()
    out, done = _drive(eng, prompts, ticks)
    assert eng.pipeline.executed == jeng.pipeline.executed
    assert done == jdone and sorted(out) == sorted(jout) == list(range(N_TTI))
    _same(eng.stats["bandwidth_profile"], jeng.stats["bandwidth_profile"])
    _same(_tick_fields(eng.stats), _tick_fields(jeng.stats))
    assert _key_tree(eng.stats) == _key_tree(jeng.stats)
    assert {k: st["effective_impl"] for k, st in eng.stats["cascade"]["stages"].items()} == {
        "text_encoder": "kernel", "denoise": "kernel", "sr0": "kernel"}
    for rid in out:
        assert tuple(out[rid].shape) == np.shape(jout[rid]) == (16, 16, 3)


def test_the_policies_schedule_differently(jax_runs):
    """The trace leaves partial pods: holding them (``pod``) and flushing
    them (``continuous``) give two schedules, so each test above pins one."""
    assert jax_runs["tti", "continuous"][2] != jax_runs["tti", "pod"][2]


# ---------------------------------------------------------------------------
# Reduced LLaMA: the same tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["auto", "cascade"])
def test_reduced_llama_greedy_tokens_equal_the_reference(jax_runs, route):
    jeng, jout, jdone = jax_runs["lm", route]
    twl = reduced_workload(get_config("llama2-7b"))
    eng = ServeEngine(twl, jax_runs["lm_params"], _lm_config(ServeConfig, route))
    out, done = _drive(eng, _lm_prompts(twl.prompt_vocab), max_new=LM_NEW)
    tokens = {r: [int(t) for t in v] for r, v in out.items()}
    assert tokens == {r: [int(t) for t in v] for r, v in jout.items()}
    assert all(len(v) == LM_NEW for v in tokens.values())
    assert done == jdone
    if route == "auto":
        _same(eng.stats["padding_waste"], jeng.stats["padding_waste"])
        assert len(eng.stats["padding_waste"]) == 3  # two buckets, batches of 2
        assert eng.stats["tokens"] == jeng.stats["tokens"]
    else:
        assert eng.pipeline.executed == jeng.pipeline.executed
    assert eng.stats["request_latency_ticks"] == jeng.stats["request_latency_ticks"]
    assert _key_tree(eng.stats) == _key_tree(jeng.stats)
