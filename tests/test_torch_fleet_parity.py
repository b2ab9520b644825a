"""The port's fleet against the JAX package's, on the CPU: one run of the
reference's ``_mixed_fleet`` scenario (``tests/test_fleet.py``: a batch TTV
front of 6 at tick 0, 4 interactive TTI requests at ticks 2, 2, 4, 4 with a
deadline of 3 ticks) in both packages, on 2 replicas with the slo policy and
migration.  (The FIFO baseline and the slo-beats-FIFO pin run in the port
alone, ``tests/test_torch_fleet.py``.)

The JAX ``FleetRouter`` is the oracle, over the same seeded parameters
handed to JAX as is and bridged unchanged into the port, on its ``naive``
tier (the plain composite: the cheapest to compile, ~43 s of this file's
time).  The port's diffusion noise is JAX's draw for each request's folded
key.  The two ``summary()`` dicts must be equal (placement, preemption and
migration are host decisions on the tick clock), and every output equal
within the fp32 chain tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import tiny as j_tiny
from repro.fleet import FleetRouter as JFleetRouter
from repro.serving import ServeConfig as JServeConfig
from repro.workload import workload_for as j_workload_for
from repro.workload.base import stage_key as j_stage_key
from repro_torch.configs import tiny as t_tiny
from repro_torch.fleet import FleetRouter
from repro_torch.nn import from_jax_params, init_params
from repro_torch.pipeline import stage as t_stage
from repro_torch.serving import ServeConfig
from repro_torch.telemetry import validate_fleet_summary
from repro_torch.workload import diffusion as t_wl_diffusion
from repro_torch.workload import ttv as t_wl_ttv
from repro_torch.workload import workload_for

CHAIN = dict(rtol=1e-4, atol=1e-4)
RUNS = {"slo": dict(n_replicas=2, policy="slo", preempt=True)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny models: under several test
    workers, 8 threads a worker oversubscribe the cores.  Restored after."""
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


def _mixed_fleet(router_cls, cfg_cls, pools, n_replicas, policy, preempt, impl, deadline=3):
    fleet = router_cls(pools, cfg_cls(max_batch=2, pod_size=2, queue_capacity=4, seed=0,
                                      impl=impl),
                       n_replicas=n_replicas, policy=policy, preempt=preempt)
    ttv, tti = pools["ttv"][0], pools["tti"][0]
    rng = np.random.default_rng(0)
    for i in range(6):
        fleet.submit("ttv", 100 + i, rng.integers(0, ttv.prompt_vocab, 8), arrival_tick=0,
                     slo_tier="batch")
    for i in range(4):
        fleet.submit("tti", i, rng.integers(0, tti.prompt_vocab, 8),
                     arrival_tick=2 + 2 * (i // 2), slo_tier="interactive",
                     deadline_ticks=deadline)
    results = fleet.run()
    return fleet, results


class _StageKey:
    """What the port's ``stage_generator`` gives here: the reference's
    folded key of the request's ``(seed, rid, stage_index)``."""

    def __init__(self, seed, rid, stage_index):
        self.key = j_stage_key(jax.random.PRNGKey(seed), rid, stage_index)


def _jax_stage_noise(gens, shape, dtype, device):
    """The reference's per-request draw, ``jax.random.normal`` of each
    request's folded key (its ``vmap`` draws each key on its own)."""
    return torch.stack([torch.from_numpy(np.array(jax.random.normal(g.key, shape, jnp.float32)))
                        for g in gens]).to(device=device, dtype=dtype)


@pytest.fixture(scope="module")
def fleets():
    """Both packages' fleets of each run, on one seeded tree per pool; the
    port's diffusion noise is JAX's (the two packages draw from different
    generators, and the routing must not depend on it)."""
    jpools, tpools = {}, {}
    for name, cfg, jcfg in (("tti", t_tiny.TINY_TTI_CASCADE, j_tiny.TINY_TTI_CASCADE),
                            ("ttv", t_tiny.TINY_TTV_CASCADE, j_tiny.TINY_TTV_CASCADE)):
        twl = workload_for(cfg)
        tree = _tree(init_params(twl.model, 0))
        jpools[name] = (j_workload_for(jcfg), jax.tree.map(jnp.asarray, tree))
        tpools[name] = (twl, twl.load(from_jax_params(tree), "cpu"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_stage, "stage_generator", _StageKey)
        for mod in (t_wl_diffusion, t_wl_ttv):
            mp.setattr(mod, "stage_noise", _jax_stage_noise)
        return {run: (_mixed_fleet(JFleetRouter, JServeConfig, jpools, impl="naive", **kw),
                      _mixed_fleet(FleetRouter, ServeConfig, tpools, impl="auto", **kw))
                for run, kw in RUNS.items()}


def _same(a, b, path="summary"):
    """Nested dicts and lists equal, floats to rounding."""
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


@pytest.mark.parametrize("run", list(RUNS))
def test_fleet_summary_equals_the_reference(fleets, run):
    (jfleet, _), (tfleet, _) = fleets[run]
    _same(tfleet.summary(), jfleet.summary())
    validate_fleet_summary(tfleet.summary())
    assert tfleet.completed == jfleet.completed
    assert tfleet.replica_trajectory == jfleet.replica_trajectory
    if run == "slo":
        assert tfleet.summary()["preempted_ticks"] > 0


@pytest.mark.parametrize("run", list(RUNS))
def test_fleet_outputs_equal_the_reference(fleets, run):
    (_, jout), (_, tout) = fleets[run]
    assert sorted(tout) == sorted(jout) == [0, 1, 2, 3, 100, 101, 102, 103, 104, 105]
    for rid in jout:
        gold = np.asarray(jout[rid], np.float32)
        out = tout[rid].numpy()
        assert out.shape == gold.shape
        scale = max(1.0, float(np.abs(gold).max()))
        np.testing.assert_allclose(out, gold, rtol=CHAIN["rtol"], atol=CHAIN["atol"] * scale)

