"""The port's fleet serving (``repro_torch.fleet``) on the CPU, without JAX:
each case of the reference's ``tests/test_fleet.py`` on the port's tiny
cascades (``TINY_TTI_CASCADE``, ``TINY_TTV_CASCADE``), with its assertions:
SLO classes, placement (round-robin cycles, least-queue, slo segregation),
migration only on a strict improvement, the autoscale steps and clamps and
the diurnal A/B, the fleet summary's schema, and the SLO-vs-FIFO acceptance
pin.  Beyond the reference's cases: a migrated request's output equals the
same rid served without migration, the launcher's fleet mode, and the
schema's validators refusing a broken summary.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.tiny import TINY_TTI_CASCADE, TINY_TTV_CASCADE
from repro_torch.fleet import (
    CROSS_TIER_WEIGHT,
    ENGINE_POLICIES,
    PLACEMENT_POLICIES,
    AutoscalePolicy,
    FleetReplica,
    FleetRouter,
    RequestMeta,
)
from repro_torch.launch import serve as launcher
from repro_torch.serving import ArrivalTrace
from repro_torch.serving.engine import ServeConfig, ServeEngine
from repro_torch.telemetry import validate_engine_stats, validate_fleet_summary
from repro_torch.workload import reduced_workload, workload_for
from repro_torch.workload.base import SLO_TIERS, default_slo_tier

CFG = ServeConfig(max_batch=2, pod_size=2, queue_capacity=4, seed=0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny models: under several test
    workers, 8 threads a worker oversubscribe the cores.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pools():
    tti = workload_for(TINY_TTI_CASCADE)
    ttv = workload_for(TINY_TTV_CASCADE)
    return {"tti": (tti, tti.init(0, "cpu")), "ttv": (ttv, ttv.init(0, "cpu"))}


def _prompt(wl, seed=0, n=8):
    return np.random.default_rng(seed).integers(0, wl.prompt_vocab, n)


# ---------------------------------------------------------------------------
# SLO classes on GenRequest (checked at prepare_request)
# ---------------------------------------------------------------------------


def test_slo_tier_defaults_by_modality(pools):
    """slo_tier=None picks the paper's traffic-mix default: video = batch,
    image and text = interactive."""
    tti, ttv = pools["tti"][0], pools["ttv"][0]
    assert default_slo_tier("video") == "batch"
    assert default_slo_tier("image") == "interactive"
    assert tti.prepare_request(0, _prompt(tti)).slo_tier == "interactive"
    assert ttv.prepare_request(0, _prompt(ttv)).slo_tier == "batch"
    lm = reduced_workload(get_config("olmo-1b"))
    assert lm.prepare_request(0, _prompt(lm)).slo_tier == "interactive"


def test_slo_class_validated_at_prepare_request(pools):
    wl = pools["tti"][0]
    req = wl.prepare_request(1, _prompt(wl), slo_tier="batch", deadline_ticks=9)
    assert req.slo_tier == "batch" and req.deadline_ticks == 9
    with pytest.raises(ValueError, match="SLO tier"):
        wl.prepare_request(2, _prompt(wl), slo_tier="bulk")
    with pytest.raises(ValueError, match="deadline_ticks"):
        wl.prepare_request(3, _prompt(wl), deadline_ticks=0)
    with pytest.raises(ValueError, match="deadline_ticks"):
        wl.prepare_request(4, _prompt(wl), deadline_ticks=-3)
    assert SLO_TIERS == ("interactive", "batch")


def test_engine_submit_threads_slo_class_through(pools):
    wl, params = pools["tti"]
    eng = ServeEngine(wl, params, CFG)
    with pytest.raises(ValueError, match="SLO tier"):
        eng.submit(0, _prompt(wl), slo_tier="platinum")
    with pytest.raises(ValueError, match="deadline_ticks"):
        eng.submit(0, _prompt(wl), deadline_ticks=-1)


def test_preempt_requires_cascade_route():
    """Stage-boundary preemption needs the cascade route; other routes
    refuse loudly."""
    wl = reduced_workload(get_config("olmo-1b"))
    eng = ServeEngine(wl, wl.init(0, "cpu"), ServeConfig(max_batch=2, buckets=(8,)))
    assert eng.parked_rids() == []  # benign on non-cascade routes
    with pytest.raises(ValueError, match="cascade route"):
        eng.preempt([0])
    with pytest.raises(ValueError, match="cascade route"):
        eng.resume([])


# ---------------------------------------------------------------------------
# Router construction + placement policies
# ---------------------------------------------------------------------------


def test_router_rejects_bad_configs(pools):
    with pytest.raises(ValueError, match="placement policy"):
        FleetRouter(pools, CFG, policy="random")
    with pytest.raises(ValueError, match="preempt"):
        FleetRouter(pools, CFG, policy="least-queue", preempt=True)
    with pytest.raises(ValueError, match="n_replicas"):
        FleetRouter(pools, CFG, n_replicas=0)
    fleet = FleetRouter(pools, CFG, n_replicas=1)
    wl = pools["tti"][0]
    with pytest.raises(ValueError, match="unknown pool"):
        fleet.submit("t2i", 0, _prompt(wl))
    with pytest.raises(ValueError, match="timed arrivals"):
        fleet.submit("tti", 0, _prompt(wl), arrival_tick=None)
    fleet.submit("tti", 0, _prompt(wl), arrival_tick=0)
    with pytest.raises(ValueError, match="duplicate rid"):
        fleet.submit("tti", 0, _prompt(wl), arrival_tick=1)
    with pytest.raises(ValueError, match="SLO tier"):
        fleet.submit("tti", 1, _prompt(wl), slo_tier="bronze")
    with pytest.raises(ValueError, match="engine policy"):
        fleet.replicas[0].choose_pool("lifo")
    with pytest.raises(TypeError, match="DeviceMesh"):
        FleetRouter(pools, ServeConfig(mesh="2x1"))


def test_replica_engines_are_cascade_engines_sharing_one_workload(pools):
    fleet = FleetRouter(pools, ServeConfig(seed=3), n_replicas=2)
    assert ENGINE_POLICIES == ("fifo", "slo") and CROSS_TIER_WEIGHT == 2.0
    for pool, (wl, params) in pools.items():
        engines = [r.engines[pool] for r in fleet.replicas]
        assert all(e.route == "cascade" and e.serve_cfg.seed == 3 for e in engines)
        assert all(e.workload is wl and e.params is params for e in engines)
    assert [e.spans.track for e in fleet.replicas[1].engines.values()] == [
        "replica1/tti", "replica1/ttv"]


def test_round_robin_placement_cycles(pools):
    fleet = FleetRouter(pools, CFG, n_replicas=3, policy="round-robin")
    wl = pools["tti"][0]
    for rid in range(6):
        fleet.submit("tti", rid, _prompt(wl), arrival_tick=0)
    fleet._admit_due()
    owners = {rid: rep.index for rep in fleet.replicas for rid in rep.meta}
    assert [owners[r] for r in range(6)] == [0, 1, 2, 0, 1, 2]


def test_least_queue_placement_picks_unloaded_replica(pools):
    fleet = FleetRouter(pools, CFG, n_replicas=2, policy="least-queue")
    wl = pools["tti"][0]
    for rid in range(100, 103):  # pre-load replica 0 directly
        fleet.replicas[0].submit(_prompt(wl), RequestMeta(rid=rid, pool="tti", tier="batch",
                                                          deadline_ticks=None, arrival=0))
    fleet.submit("tti", 0, _prompt(wl), arrival_tick=0)
    fleet._admit_due()
    assert 0 in fleet.replicas[1].meta  # routed around the loaded replica


def test_slo_placement_segregates_tiers(pools):
    fleet = FleetRouter(pools, CFG, n_replicas=2, policy="slo")
    ttv, tti = pools["ttv"][0], pools["tti"][0]
    fleet.submit("ttv", 100, _prompt(ttv), arrival_tick=0, slo_tier="batch")
    fleet.submit("tti", 0, _prompt(tti), arrival_tick=0, slo_tier="interactive")
    fleet.submit("tti", 1, _prompt(tti), arrival_tick=0, slo_tier="interactive")
    fleet._admit_due()
    batch_rep = next(r for r in fleet.replicas if 100 in r.meta)
    inter_reps = {next(r.index for r in fleet.replicas if rid in r.meta) for rid in (0, 1)}
    assert inter_reps == {1 - batch_rep.index}


def test_saturation_counts_bounded_buffers_only(pools):
    rep = FleetReplica(0, {"tti": pools["tti"]}, CFG)
    assert rep.saturation() == 0.0
    wl = pools["tti"][0]
    for rid in range(2):
        rep.submit(_prompt(wl), RequestMeta(rid=rid, pool="tti", tier="interactive",
                                            deadline_ticks=None, arrival=0))
    rep.step()  # the pod's first stage ran: its state waits in a bounded buffer
    bufs = [b for b in rep.engines["tti"].pipeline.buffers if b.capacity is not None]
    used = sum(b.capacity - b.free_slots() for b in bufs)
    assert used == 2 and rep.saturation() == used / sum(b.capacity for b in bufs)


# ---------------------------------------------------------------------------
# Migration mechanics (slo policy + preempt=True)
# ---------------------------------------------------------------------------


def test_migration_moves_parked_batch_work_to_unloaded_replica(pools):
    fleet = FleetRouter(pools, CFG, n_replicas=2, policy="slo", preempt=True)
    src, dst = fleet.replicas
    ttv, tti = pools["ttv"][0], pools["tti"][0]
    for rid in (100, 101):  # batch pod onto the SOURCE replica directly
        src.submit(_prompt(ttv), RequestMeta(rid=rid, pool="ttv", tier="batch",
                                             deadline_ticks=None, arrival=0))
    src.engines["ttv"].step()  # park the pod at its first stage boundary
    assert set(src.parked_rids("ttv", tier="batch")) == {100, 101}
    src.submit(_prompt(tti), RequestMeta(rid=0, pool="tti", tier="interactive",
                                         deadline_ticks=8, arrival=0))
    fleet._migrate()
    assert fleet.migrations == 2
    assert src.parked_rids("ttv") == []
    assert set(dst.parked_rids("ttv", tier="batch")) == {100, 101}
    assert set(dst.meta) == {100, 101} and set(src.meta) == {0}
    assert dst.engines["ttv"].pipeline.resumed == 2
    assert [e.name for e in fleet.spans.events] == ["migrate", "migrate"]
    while src.pending() or dst.pending():
        src.step("slo")
        dst.step("slo")
    assert not src.meta and not dst.meta


def test_migration_skipped_without_strict_improvement(pools):
    fleet = FleetRouter(pools, CFG, n_replicas=2, policy="slo", preempt=True)
    ttv, tti = pools["ttv"][0], pools["tti"][0]
    for rep in fleet.replicas:  # both replicas equally loaded with batch
        base = 100 + rep.index * 10
        for rid in (base, base + 1):
            rep.submit(_prompt(ttv), RequestMeta(rid=rid, pool="ttv", tier="batch",
                                                 deadline_ticks=None, arrival=0))
        rep.engines["ttv"].step()
    fleet.replicas[0].submit(_prompt(tti), RequestMeta(rid=0, pool="tti", tier="interactive",
                                                       deadline_ticks=8, arrival=0))
    fleet._migrate()
    assert fleet.migrations == 0  # dst.pending() + moved >= src.pending()


def test_migrated_request_output_equals_the_unmigrated_one(pools):
    """The PRNG contract migration relies on: batch requests preempted on
    one replica and finished on another give the outputs the same rids give
    served where they started."""
    ttv, tti = pools["ttv"][0], pools["tti"][0]
    prompts = {rid: _prompt(ttv, seed=rid) for rid in (100, 101)}

    def serve(migrate):
        fleet = FleetRouter(pools, CFG, n_replicas=2, policy="slo", preempt=True)
        src, dst = fleet.replicas
        for rid, p in prompts.items():
            src.submit(p, RequestMeta(rid=rid, pool="ttv", tier="batch", deadline_ticks=None,
                                      arrival=0))
        src.engines["ttv"].step()
        if migrate:
            src.submit(_prompt(tti), RequestMeta(rid=0, pool="tti", tier="interactive",
                                                 deadline_ticks=8, arrival=0))
            fleet._migrate()
            assert fleet.migrations == 2 and set(dst.meta) == {100, 101}
        out = {}
        while src.pending() or dst.pending():
            for rep in (src, dst):
                out.update({rid: o for rid, o, _ in rep.step("slo")})
        return out

    moved, home = serve(True), serve(False)
    for rid in prompts:
        assert torch.equal(moved[rid], home[rid])
    assert moved[0].shape == (16, 16, 3)


# ---------------------------------------------------------------------------
# Autoscaling
# ---------------------------------------------------------------------------


def test_autoscale_policy_steps_and_clamps():
    pol = AutoscalePolicy(min_replicas=1, max_replicas=3, target_queue=4.0)
    assert pol.desired(1, 0) == 1  # never below min
    assert pol.desired(1, 5) == 2  # one step up toward ceil(5/4)=2
    assert pol.desired(1, 100) == 2  # ...even when the target is far
    assert pol.desired(3, 100) == 3  # never above max
    assert pol.desired(3, 4) == 2  # one step down
    assert pol.desired(2, 8) == 2  # on target: hold
    with pytest.raises(ValueError, match="min_replicas"):
        AutoscalePolicy(min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError, match="target_queue"):
        AutoscalePolicy(target_queue=0.0)
    with pytest.raises(ValueError, match="cooldown"):
        AutoscalePolicy(cooldown=-1)


def test_autoscaled_fleet_tracks_diurnal_load_and_saves_replica_ticks(pools):
    def run(autoscale):
        fleet = FleetRouter({"tti": pools["tti"]}, CFG, n_replicas=3, policy="least-queue",
                            autoscale=autoscale)
        fleet.submit_trace("tti", ArrivalTrace("diurnal", rate=0.8, period=12, amplitude=0.9,
                                               seed=1), 8, deadline_ticks=12)
        assert len(fleet.run()) == 8
        return fleet.summary()

    fixed = run(None)
    auto = run(AutoscalePolicy(min_replicas=1, max_replicas=3, target_queue=3.0, cooldown=2))
    assert fixed["autoscale"] is None
    assert auto["autoscale"]["scale_events"]
    assert auto["replicas"]["mean_active"] < fixed["replicas"]["mean_active"]
    assert auto["replicas"]["replica_ticks"] < fixed["replicas"]["replica_ticks"]
    assert auto["completed"] == fixed["completed"] == 8
    validate_fleet_summary(auto)


# ---------------------------------------------------------------------------
# End-to-end fleet serving + stats schema + the SLO-vs-FIFO acceptance pin
# ---------------------------------------------------------------------------


def _mixed_fleet(pools, n_replicas, policy, preempt, deadline=3):
    """The reference's scenario: a batch TTV front at tick 0, interactive
    TTI landing mid-flight with a tight deadline."""
    fleet = FleetRouter(pools, CFG, n_replicas=n_replicas, policy=policy, preempt=preempt)
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
    assert set(results) == {100, 101, 102, 103, 104, 105, 0, 1, 2, 3}
    return fleet.summary()


def test_fleet_e2e_stats_schema(pools, tmp_path):
    assert set(PLACEMENT_POLICIES) == {"round-robin", "least-queue", "slo"}
    fleet = FleetRouter(pools, CFG, n_replicas=2, policy="slo", preempt=True)
    ttv, tti = pools["ttv"][0], pools["tti"][0]
    fleet.submit("ttv", 100, _prompt(ttv), arrival_tick=0, slo_tier="batch")
    fleet.submit("tti", 0, _prompt(tti), arrival_tick=1, slo_tier="interactive",
                 deadline_ticks=10)
    fleet.run()
    s = fleet.summary()
    assert set(s) >= {"policy", "engine_policy", "preempt", "pools", "ticks", "requests",
                      "completed", "tiers", "preemptions", "preempted_ticks", "parked",
                      "resumed", "migrations", "replicas", "autoscale"}
    assert s["requests"] == s["completed"] == 2
    assert set(s["tiers"]) == set(SLO_TIERS)
    for t in s["tiers"].values():
        assert set(t) == {"requests", "latency_ticks", "deadline_requests",
                          "deadline_attainment", "deadline_misses", "deadline_margin_ticks"}
        assert set(t["latency_ticks"]) == {"p50", "p95", "mean", "max"}
        assert 0.0 <= t["deadline_attainment"] <= 1.0
    assert s["tiers"]["interactive"]["deadline_requests"] == 1
    rep = s["replicas"]
    assert rep["configured"] == 2 and len(rep["utilization"]) == 2
    assert rep["replica_ticks"] >= s["ticks"] >= 1
    validate_fleet_summary(s)
    for r in fleet.replicas:  # mirrored into every replica engine's stats
        for eng in r.engines.values():
            assert eng.stats["fleet"] is not None and eng.stats["fleet"]["policy"] == "slo"
            if eng.stats["requests"]:
                validate_engine_stats(eng.stats, "cascade")
    assert fleet.tick_seconds() > 0
    n = fleet.export_chrome_trace(str(tmp_path / "fleet.json"))
    assert n > 0 and (tmp_path / "fleet.json").exists()


def test_slo_fleet_beats_fifo_baseline_on_interactive_deadlines(pools):
    """The acceptance pin: on the mixed TTV+TTI trace, SLO-aware routing with
    stage-boundary preemption improves interactive-tier deadline attainment
    AND p95 latency over the FIFO single-replica baseline, and exercised
    preemption to do it."""
    fifo = _mixed_fleet(pools, n_replicas=1, policy="round-robin", preempt=False)
    slo = _mixed_fleet(pools, n_replicas=2, policy="slo", preempt=True)
    f_it, s_it = fifo["tiers"]["interactive"], slo["tiers"]["interactive"]
    assert s_it["deadline_attainment"] > f_it["deadline_attainment"]
    assert s_it["latency_ticks"]["p95"] < f_it["latency_ticks"]["p95"]
    assert slo["preempted_ticks"] > 0
    assert fifo["preempted_ticks"] == 0 and fifo["preemptions"] == 0
    assert slo["tiers"]["batch"]["requests"] == 6
    validate_fleet_summary(fifo)
    validate_fleet_summary(slo)


def test_fleet_schema_refuses_a_broken_summary(pools):
    fleet = FleetRouter({"tti": pools["tti"]}, CFG, n_replicas=1)
    fleet.submit("tti", 0, _prompt(pools["tti"][0]))
    fleet.run()
    good = fleet.summary()
    validate_fleet_summary(good)
    for key, bad in (("policy", "random"), ("preempt", 1), ("migrations", -1)):
        with pytest.raises(ValueError, match="fleet summary failed"):
            validate_fleet_summary(dict(good, **{key: bad}))
    broken = dict(good, replicas=dict(good["replicas"], configured=0))
    with pytest.raises(ValueError, match="replicas.configured"):
        validate_fleet_summary(broken)
    eng = fleet.replicas[0].engines["tti"]
    with pytest.raises(ValueError, match="stats.fleet"):
        validate_engine_stats(dict(eng.stats, fleet={k: v for k, v in good.items()
                                                     if k != "autoscale"}), "cascade")


# ---------------------------------------------------------------------------
# The launcher's fleet mode
# ---------------------------------------------------------------------------


def test_launcher_serves_a_fleet(capsys, tmp_path):
    stats = tmp_path / "fleet.json"
    results = launcher.main(["--arch", "stable-diffusion", "--reduced", "--device", "cpu",
                             "--replicas", "2", "--router", "slo", "--preempt", "--requests",
                             "4", "--stats-json", str(stats), "--trace-out",
                             str(tmp_path / "trace.json")])
    out = capsys.readouterr().out
    assert sorted(results) == [0, 1, 2, 3]
    for line in ("arch stable-diffusion-reduced | route cascade | stages", "device cpu",
                 "fleet [slo, preempt]: served 4 requests in", "over 2 replicas",
                 "tier interactive: ", "tier batch: ", "preemption: ", "replicas: r0=",
                 "per-replica tracks", "stats json -> "):
        assert line in out, line
    import json

    validate_fleet_summary(json.loads(stats.read_text()))


def test_launcher_autoscales_a_fleet(capsys):
    results = launcher.main(["--arch", "stable-diffusion", "--reduced", "--device", "cpu",
                             "--autoscale", "1:2", "--requests", "3", "--arrivals", "burst"])
    out = capsys.readouterr().out
    assert sorted(results) == [0, 1, 2]
    assert "fleet [round-robin | autoscale 1:2]" in out and "autoscale events: " in out
    assert launcher.parse_autoscale("2:3") == AutoscalePolicy(min_replicas=2, max_replicas=3)
    assert launcher.parse_autoscale(None) is None
