"""The port's serving stack (``repro_torch.{telemetry,serving,pipeline,launch}``)
on the CPU, without JAX: the reference's unit cases of the schedulers,
buffers, arrival traces, metrics and schema, held against the port's
modules; route parity inside the port (``generate`` vs the pod / lm route vs
the cascade route); LM sampling at ``temperature > 0``; preemption and
resumption across two engines; and the launcher's report.

Routes compute one function in batches of other sizes: CPU matmul blocking
depends on the batch, so diffusion outputs agree within 1e-5 and tokens are
equal.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.tiny import TINY_TTI_CASCADE, TINY_TTV_CASCADE
from repro_torch.kernels.tiers import resolve_model_impl
from repro_torch.launch import serve as launcher
from repro_torch.pipeline import (
    CascadePipeline,
    StageBuffer,
    StageTask,
    resolve_stage_impls,
    stage_batch_sizes,
    state_nbytes,
    state_signature,
)
from repro_torch.serving import (
    ON_COMPLETION,
    ArrivalTrace,
    BucketedScheduler,
    DenoisePodScheduler,
    LMServeEngine,
    Request,
    ServeConfig,
    ServeEngine,
    bucket_of,
)
from repro_torch.telemetry import (
    Histogram,
    MetricsRegistry,
    json_ready,
    percentiles,
    validate_engine_stats,
    validate_snapshot,
)
from repro_torch.workload import LMWorkload, Stage, reduced_workload, workload_for
from repro_torch.workload.base import split_state, stack_states, stage_generator

ROUTE_TOL = dict(rtol=1e-5, atol=1e-5)
N_REQ, POD, PROMPT_LEN = 4, 2, 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny models: under several test
    workers, 8 threads a worker oversubscribe the cores ~10x.  Restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """The tiny SR cascade, the tiny TTV cascade and reduced LLaMA, with
    seeded parameters on the CPU."""
    out = {}
    for name, wl in (("tti", workload_for(TINY_TTI_CASCADE)),
                     ("ttv", workload_for(TINY_TTV_CASCADE)),
                     ("lm", reduced_workload(get_config("llama2-7b")))):
        out[name] = (wl, wl.init(0, "cpu"))
    return out


def _prompts(wl, n=N_REQ, seed=0, length=PROMPT_LEN):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, wl.prompt_vocab, size=length) for _ in range(n)]


def _engine(wl, params, route="auto", **kw):
    kw = dict(dict(max_batch=POD, buckets=(PROMPT_LEN,), queue_capacity=POD), **kw)
    return ServeEngine(wl, params, ServeConfig(route=route, **kw))


def _serve(wl, params, prompts, route="auto", max_new=0, arrivals=None, **kw):
    eng = _engine(wl, params, route, **kw)
    for rid, p in enumerate(prompts):
        eng.submit(rid, p, max_new_tokens=max_new,
                   arrival_tick=0 if arrivals is None else arrivals[rid])
    return eng.run(), eng


# ---------------------------------------------------------------------------
# Buffers, batch sizes, schedulers
# ---------------------------------------------------------------------------


def test_stage_buffer_is_bounded_and_groups_by_signature():
    buf = StageBuffer("in/denoise", capacity=3)
    a = StageTask(rid=0, state={}, group=("A",))
    b = StageTask(rid=1, state={}, group=("B",))
    assert buf.push(a) and buf.push(b) and buf.push(dataclasses.replace(a, rid=2))
    assert buf.room() == 0 and not buf.push(a)  # bounded: push refused
    assert [t.rid for t in buf.pop_group(8)] == [0, 2]  # the head's group, FIFO
    assert [t.rid for t in buf.pop_group(8)] == [1]
    assert len(buf) == 0 and buf.pop_group(8) == []


def test_stage_buffer_free_slots_reports_real_capacity():
    unbounded = StageBuffer("admission", capacity=None)
    assert unbounded.free_slots() is None and unbounded.room() == math.inf
    for i in range(100):
        assert unbounded.push(StageTask(rid=i, state={}))
    assert unbounded.free_slots() is None
    bounded = StageBuffer("handoff", capacity=2)
    assert bounded.push(StageTask(rid=0, state={})) and bounded.push(StageTask(rid=1, state={}))
    assert bounded.free_slots() == 0 and not bounded.push(StageTask(rid=2, state={}))
    assert bounded.push(StageTask(rid=2, state={}), force=True)  # a resumed request lands
    assert len(bounded) == 3 and bounded.free_slots() == 0


def test_stage_buffer_records_queue_waits_and_drains_by_rid():
    buf = StageBuffer("in/sr0", capacity=None)
    for rid, now in ((0, 0), (1, 1), (2, 3)):
        buf.push(StageTask(rid=rid, state={}, group=("g",)), now=now)
    assert [t.rid for t in buf.drain({1})] == [1]
    assert [t.rid for t in buf.pop_group(8, now=5)] == [0, 2]
    assert buf.waits.count == 2 and buf.waits.max == 5.0 and buf.waits.min == 2.0


def test_stage_batch_sizes_heaviest_stage_gets_pod_batch():
    stages = [Stage("text_encoder", 1, 16), Stage("denoise", 4, 256, demand=(256, 64, 256)),
              Stage("sr", 2, 4096, demand=(4096, 1024, 4096))]
    sizes = stage_batch_sizes(stages, pod_size=2, queue_capacity=64)
    assert sizes[2] == 2 and sizes[0] > sizes[1] > sizes[2] and min(sizes) >= 2


def test_pod_scheduler_fifo_flush_and_stagger():
    sched = DenoisePodScheduler(pod_size=2, total_steps=4)
    for i in range(5):
        sched.submit(Request(rid=i, prompt_len=4, denoise_steps=4))
    assert [r.rid for r in sched.next_pod()] == [0, 1]  # FIFO
    assert [r.rid for r in sched.next_pod()] == [2, 3]
    assert sched.pop_pod() == [] and sched.open_size() == 1
    assert [r.rid for r in sched.next_pod()] == [4]  # drain flushes the partial pod
    # a pod larger than the step count spreads its offsets evenly
    big = DenoisePodScheduler(pod_size=6, total_steps=4)
    pod = [Request(rid=i, prompt_len=4) for i in range(6)]
    ticks = big.schedule(pod)
    assert len(ticks) == 4 and all(len(t) == 6 for t in ticks)
    assert sorted(ticks[0]) == [0, 0, 1, 2, 2, 3]
    # staggering levels a U-shaped demand: the peak falls, the mean stays
    prof = DenoisePodScheduler.bandwidth_profile([4.0, 1.0, 1.0, 4.0],
                                                 DenoisePodScheduler(2, 4).schedule(pod[:2]))
    assert prof["aligned_peak"] == 8.0 and prof["staggered_peak"] == 5.0
    assert prof["peak_reduction"] == pytest.approx(1.6)


def test_early_flushed_pod_keeps_membership_and_profile_size():
    demands = [1.0, 2.0, 3.0, 2.0, 1.0, 1.0]
    sched = DenoisePodScheduler(pod_size=4, total_steps=len(demands))
    for i in range(2):
        sched.submit(Request(rid=i, prompt_len=8, denoise_steps=6, arrived_at=0.0))
    assert not sched.flush_stale(now=1, max_wait=2)
    assert sched.flush_stale(now=2, max_wait=2)
    assert not sched.flush_stale(now=2, max_wait=2)  # idempotent
    for i in range(2, 6):
        sched.submit(Request(rid=i, prompt_len=8, denoise_steps=6, arrived_at=3.0))
    pods = []
    while pod := sched.pop_pod():
        pods.append([r.rid for r in pod])
    assert pods == [[0, 1], [2, 3, 4, 5]]
    prof = DenoisePodScheduler.bandwidth_profile(
        demands, sched.schedule([Request(rid=i, prompt_len=8) for i in range(2)]))
    assert prof["aligned_peak"] == max(demands) * 2


@pytest.mark.parametrize("length,bucket", [(1, 8), (8, 8), (9, 16), (16, 16), (40, 32)])
def test_bucket_of(length, bucket):
    assert bucket_of(length, (8, 16, 32)) == bucket


def test_bucketed_scheduler_fullest_bucket_first_and_padding_waste():
    sched = BucketedScheduler(buckets=(16, 8), max_batch=2)
    assert sched.buckets == (8, 16)
    for rid, n in enumerate((3, 12, 5, 7)):
        sched.submit(Request(rid=rid, prompt_len=n))
    bucket, batch = sched.next_batch()  # bucket 8 holds 3 requests, 16 one
    assert bucket == 8 and [r.rid for r in batch] == [0, 2]
    assert sched.padding_waste(batch, bucket) == pytest.approx(1 - 8 / 16)
    bucket, batch = sched.next_batch()  # a tie: the bucket opened first
    assert (bucket, [r.rid for r in batch]) == (8, [3])
    assert sched.next_batch()[1][0].rid == 1 and sched.next_batch() == (0, [])
    assert sched.padding_waste([], 8) == 0.0


# ---------------------------------------------------------------------------
# Arrival traces
# ---------------------------------------------------------------------------


def test_arrival_traces_are_seeded_and_shaped():
    a = ArrivalTrace("poisson", rate=0.5, seed=3).ticks(16)
    assert a == ArrivalTrace("poisson", rate=0.5, seed=3).ticks(16) == sorted(a)
    assert a != ArrivalTrace("poisson", rate=0.5, seed=4).ticks(16)
    assert max(ArrivalTrace("poisson", rate=5.0, seed=3).ticks(16)) < max(a)
    assert ArrivalTrace("burst", burst_size=2, burst_gap=3).ticks(5) == [0, 0, 3, 3, 6]
    assert ArrivalTrace("closed-loop", concurrency=2).ticks(4) == [0, 0, ON_COMPLETION,
                                                                  ON_COMPLETION]
    d = ArrivalTrace("diurnal", rate=1.0, period=8, amplitude=0.9, seed=5).ticks(64)
    assert len(d) == 64 and d == sorted(d)
    assert (sum(t % 8 in (1, 2, 3) for t in d) > sum(t % 8 in (5, 6, 7) for t in d))
    assert ArrivalTrace("poisson").ticks(0) == []


def test_arrival_traces_reject_bad_configs_and_convert_rates():
    for kw, match in ((dict(pattern="uniform"), "pattern"), (dict(rate=0.0), "rate"),
                      (dict(pattern="closed-loop", concurrency=0), "concurrency"),
                      (dict(pattern="diurnal", period=0), "period"),
                      (dict(pattern="diurnal", amplitude=1.5), "amplitude")):
        with pytest.raises(ValueError, match=match):
            ArrivalTrace(**kw)
    assert ArrivalTrace.from_rps("poisson", rps=4.0, tick_seconds=0.5).rate == pytest.approx(2.0)
    assert ArrivalTrace.from_rps("burst", rps=2.0, tick_seconds=0.5, burst_size=4).burst_gap == 4
    with pytest.raises(ValueError, match="no arrival rate"):
        ArrivalTrace.from_rps("closed-loop", rps=1.0, tick_seconds=0.5)


# ---------------------------------------------------------------------------
# Metrics and schema
# ---------------------------------------------------------------------------


def test_histogram_matches_numpy_percentiles():
    """The estimator's contract: on a linear scale, within one bucket
    ``resolution`` of ``numpy.percentile``; on a log scale, within its
    relative resolution; the mean and the extremes exact."""
    rng = np.random.default_rng(0)
    small = [1, 2, 3, 4]
    h = Histogram("t")
    h.observe_many(small)
    assert h.summary() == pytest.approx(percentiles(small))
    for lo, hi, res in ((0, 50, 1.0), (0.0, 100.0, 0.5), (0.0, 4095.0, 1.0)):
        xs = rng.uniform(lo, hi, 300) if res != 1.0 or hi > 50 else rng.integers(lo, hi, 300)
        h = Histogram("x", lo=0.0, hi=4096.0, resolution=res)
        h.observe_many(xs)
        for q in (0, 25, 50, 90, 95, 99, 100):
            assert abs(h.percentile(q) - np.percentile(xs, q)) <= res + 1e-9
        assert h.mean == pytest.approx(np.mean(xs)) and h.max == max(xs)
    log = Histogram("s", lo=1e-7, hi=1e4, resolution=0.02, scale="log")
    wall = 10.0 ** rng.uniform(-6, 2, 200)
    log.observe_many(wall)
    for q in (50, 95):
        assert log.percentile(q) == pytest.approx(np.percentile(wall, q), rel=0.05)
    log.observe(1e9)  # clamped into the edge bucket; the max stays exact
    assert log.percentile(100) == log.max == 1e9
    assert percentiles([]) == Histogram("e").summary() == {"p50": 0.0, "p95": 0.0,
                                                           "mean": 0.0, "max": 0.0}


def test_registry_snapshot_and_kind_conflict():
    reg = MetricsRegistry()
    reg.counter("c").inc(3)
    reg.gauge("g").set(2)
    reg.histogram("h").observe(4)
    assert reg.counter("c").value == 3
    with pytest.raises(TypeError):
        reg.gauge("c")
    with pytest.raises(ValueError):
        reg.counter("c").inc(-1)
    snap = reg.snapshot()
    validate_snapshot(snap)
    assert snap["histograms"]["h"]["count"] == 1


@pytest.mark.parametrize("name,route", [("tti", "auto"), ("tti", "cascade"), ("lm", "auto")])
def test_engine_stats_match_the_schema_and_json(tiny, name, route):
    wl, params = tiny[name]
    _, eng = _serve(wl, params, _prompts(wl), route, max_new=3)
    validate_engine_stats(eng.stats, eng.route)
    assert json.loads(json.dumps(json_ready(eng.stats))) == json_ready(eng.stats)
    validate_snapshot(eng.snapshot())


def test_schema_validator_rejects_drift(tiny):
    wl, params = tiny["tti"]
    _, eng = _serve(wl, params, _prompts(wl), "cascade")
    for mutate, where in (
            (lambda s: s.pop("clock"), "stats.clock"),
            (lambda s: s.__setitem__("schema", "engine-stats/v0"), "stats.schema"),
            (lambda s: s["cascade"]["stages"]["sr0"].__setitem__("effective_impl", "pallas"),
             "effective_impl"),
            (lambda s: s["cascade"]["stages"]["denoise"]["service_s"].pop("p95"), "service_s"),
            (lambda s: s["cascade"]["admission"].__setitem__("policy", "eager"), "policy")):
        stats = json.loads(json.dumps(json_ready(eng.stats)))
        mutate(stats)
        with pytest.raises(ValueError, match=where):
            validate_engine_stats(stats, "cascade")


def test_chrome_trace_has_stage_lanes_and_lifecycle_spans(tiny, tmp_path):
    wl, params = tiny["tti"]
    _, eng = _serve(wl, params, _prompts(wl), "cascade")
    path = tmp_path / "trace.json"
    n = eng.export_chrome_trace(str(path), arch="tiny")
    doc = json.loads(path.read_text())
    assert len(doc["traceEvents"]) == n and doc["otherData"]["arch"] == "tiny"
    lanes = {e["args"]["name"] for e in doc["traceEvents"] if e["name"] == "thread_name"}
    assert {"text_encoder", "denoise", "sr0", "request", "admission"} <= lanes
    cats = {e.get("cat") for e in doc["traceEvents"]}
    assert {"exec", "queue", "request", "admission"} <= cats


# ---------------------------------------------------------------------------
# Stage states and the tiers
# ---------------------------------------------------------------------------


def test_states_stack_and_split_over_lists_and_named_tuples():
    from repro_torch.models.layers.attention import AttentionCache

    states = [{"a": torch.full((2,), float(i)),
               "caches": [{"attn": AttentionCache(torch.full((3,), i), torch.zeros(1))}]}
              for i in range(3)]
    batched = stack_states(states)
    assert isinstance(batched["caches"][0]["attn"], AttentionCache)
    assert tuple(batched["caches"][0]["attn"].k.shape) == (3, 3)
    back = split_state(batched, 3)
    assert isinstance(back[2]["caches"], list) and torch.equal(back[2]["caches"][0]["attn"].k,
                                                               torch.full((3,), 2))
    assert state_signature(back[0]) == state_signature(states[1])
    assert state_signature(states[0]) != state_signature({"a": torch.zeros(3)})
    assert state_nbytes(states[0]) == 2 * 4 + 3 * 8 + 4


def test_lm_prefill_state_is_batch_first_views(tiny):
    """The prefill stage leaves its caches batch axis first, as views of the
    layer-first storage that decode writes in place: generate copies
    nothing."""
    wl, params = tiny["lm"]
    stages = wl.cost_descriptor().stages
    state = stack_states([wl.init_stage_state(torch.arange(5), "cpu", max_new_tokens=3)] * 2)
    gens = [stage_generator(0, r, 0) for r in range(2)]
    with torch.inference_mode():
        out = wl.run_stage(params, stages[0], state, gens, impl="kernel")
    k = out["caches"][0]["attn"].k
    n = wl.cfg.n_layers
    assert tuple(k.shape) == (2, n, 5 + 3, wl.cfg.n_kv_heads, wl.cfg.head_dim)
    assert not k.is_contiguous() and k.movedim(0, 1).is_contiguous()
    assert wl.stage_group_key(stages[1], split_state(out, 2)[0]) == 5
    assert wl.stage_group_key(stages[0], split_state(state, 2)[0]) is None


@pytest.mark.parametrize("name", ["tti", "lm"])
@pytest.mark.parametrize("route", ["auto", "cascade"])
def test_stage_impl_typo_rejected_on_every_route(tiny, name, route):
    wl, params = tiny[name]
    with pytest.raises(ValueError, match="match no stage"):
        _engine(wl, params, route, stage_impl={"not_a_stage": "torch"})
    _engine(wl, params, route, stage_impl={wl.cost_descriptor().stages[0].name: "torch"})


def test_resolve_stage_impls_exact_prefix_and_default():
    stages = [Stage("text_encoder", 1, 8), Stage("denoise", 2, 64), Stage("sr0", 2, 256),
              Stage("sr1", 2, 1024)]
    assert resolve_stage_impls(stages, "auto", {"sr": "pallas", "sr1": "naive",
                                                "denoise": "blocked_jax"}) == [
        "auto", "blocked_jax", "pallas", "naive"]


def test_stage_impl_reaches_run_stage_as_the_ports_tiers(tiny, monkeypatch):
    """Every stage gets its requested string unchanged (as the reference's
    driver passes it: the tracer's events read the string), which resolves
    to the port's tier, ``kernel`` or ``torch``, on the pod and the cascade
    route; stats keep the requested and effective."""
    wl, params = tiny["tti"]
    seen = {}
    orig = wl.run_stage

    def spy(params, stage, state, gens, *, impl="auto", temperature=0.0):
        seen.setdefault(stage.name, set()).add(impl)
        return orig(params, stage, state, gens, impl=impl, temperature=temperature)

    monkeypatch.setattr(wl, "run_stage", spy)
    stage_impl = {"text_encoder": "naive", "sr": "pallas"}
    for route in ("auto", "cascade"):
        seen.clear()
        _, eng = _serve(wl, params, _prompts(wl, 3), route, stage_impl=stage_impl)
        assert seen == {"text_encoder": {"naive"}, "denoise": {"auto"}, "sr0": {"pallas"}}
        assert {k: {resolve_model_impl(i) for i in v} for k, v in seen.items()} == {
            "text_encoder": {"torch"}, "denoise": {"kernel"}, "sr0": {"kernel"}}
    st = eng.stats["cascade"]["stages"]
    assert (st["sr0"]["impl"], st["sr0"]["effective_impl"]) == ("pallas", "kernel")
    assert eng.stats["cascade"]["tiers"]["torch"]["stages"] == ["text_encoder"]


def test_mesh_is_refused():
    with pytest.raises(NotImplementedError, match="mesh"):
        ServeConfig(mesh=object())
    wl = workload_for(TINY_TTI_CASCADE)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        CascadePipeline(wl, wl.init(0, "cpu"), mesh=object())


# ---------------------------------------------------------------------------
# Online admission
# ---------------------------------------------------------------------------


def test_continuous_admission_joins_partially_drained_stage_queue(tiny):
    wl, params = tiny["tti"]
    eng = _engine(wl, params, "cascade", arrival_flush_wait=1, queue_capacity=8)
    for rid, (p, t) in enumerate(zip(_prompts(wl, 3), (0, 0, 2))):
        eng.submit(rid, p, arrival_tick=t)
    first_stage_ticks = []
    while eng.pending():
        tick, before = eng._tick, eng.pipeline.executors[0].batches
        eng.step()
        if eng.pipeline.executors[0].batches > before:
            first_stage_ticks.append(tick)
    assert len(first_stage_ticks) >= 2 and first_stage_ticks[1] >= 2
    assert eng.stats["cascade"]["concurrency"]["max"] >= 2
    assert eng.stats["cascade"]["admission"]["policy"] == "continuous"


def test_pod_admission_holds_partial_pods_continuous_flushes_them(tiny):
    wl, params = tiny["tti"]
    e2e = {}
    for admission in ("pod", "continuous"):
        _, eng = _serve(wl, params, _prompts(wl, 2), "cascade", arrivals=[0, 4],
                        admission=admission, arrival_flush_wait=1)
        e2e[admission] = eng.stats["cascade"]["request_latency_ticks"]["p95"]
    assert e2e["continuous"] < e2e["pod"]


def test_closed_loop_admits_into_an_idle_engine_immediately(tiny):
    wl, params = tiny["lm"]
    eng = _engine(wl, params, buckets=(8, 16))
    for rid in range(2):
        eng.submit(rid, np.arange(5), 4, arrival_tick=None)
    assert eng.scheduler.pending() == 1 and len(eng._closed_loop) == 1
    results = eng.run()  # terminates: 0 now, 1 on 0's completion
    assert sorted(results) == [0, 1] and all(len(v) == 4 for v in results.values())
    assert eng._arrival_tick == {0: 0, 1: 0}


def test_closed_loop_arrivals_release_on_completion(tiny):
    wl, params = tiny["tti"]
    ticks = ArrivalTrace("closed-loop", concurrency=2).ticks(4)
    results, eng = _serve(wl, params, _prompts(wl), "cascade", arrivals=ticks,
                          arrival_flush_wait=1)
    assert sorted(results) == [0, 1, 2, 3]
    assert eng._arrival_tick[0] == eng._arrival_tick[1] == 0
    assert all(eng._arrival_tick[r] > 0 for r in (2, 3))


def test_clock_calibration_configured_and_measured(tiny):
    wl, params = tiny["tti"]
    _, eng = _serve(wl, params, _prompts(wl, 3), "cascade", tick_seconds=0.25)
    s = eng.stats
    assert s["clock"]["tick_seconds"] == 0.25 and s["clock"]["source"] == "configured"
    assert s["clock"]["ticks"] == eng._tick and s["clock"]["busy_ticks"] >= 1
    for k, v in s["request_latency_ticks"].items():
        assert s["request_latency_s"][k] == pytest.approx(v * 0.25)
    assert s["requests_per_s"] == pytest.approx(3 / (eng._tick * 0.25))
    _, eng = _serve(wl, params, _prompts(wl, 3), "cascade")
    assert eng.stats["clock"]["source"] == "calibrated"
    assert eng.tick_seconds() == eng.stats["clock"]["tick_seconds"] > 0.0


# ---------------------------------------------------------------------------
# Route parity inside the port, sampling, preemption
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tti", "ttv", "lm"])
def test_routes_agree_with_generate(tiny, name):
    """pod / lm route == cascade route == ``generate`` of the same pods:
    images within 1e-5, tokens equal."""
    wl, params = tiny[name]
    prompts = _prompts(wl)
    max_new = 5 if name == "lm" else 0
    native, _ = _serve(wl, params, prompts, "auto", max_new)
    cascade, eng = _serve(wl, params, prompts, "cascade", max_new)
    assert eng.stats["cascade"]["concurrency"]["max"] >= 2  # stages overlapped
    direct = {}
    for lo in range(0, N_REQ, POD):
        rids = list(range(lo, lo + POD))
        direct.update(zip(rids, wl.generate_requests(
            params, np.stack([prompts[r] for r in rids]), 0, device="cpu", rids=rids,
            max_new_tokens=max_new)))
    assert sorted(native) == sorted(cascade) == list(range(N_REQ))
    for rid in range(N_REQ):
        if name == "lm":
            assert native[rid] == cascade[rid].tolist() == direct[rid].tolist()
        else:
            torch.testing.assert_close(native[rid], cascade[rid], **ROUTE_TOL)
            torch.testing.assert_close(native[rid], direct[rid], **ROUTE_TOL)


def test_lm_sampling_is_seeded_route_and_batch_invariant(tiny):
    wl, params = tiny["lm"]
    prompts = _prompts(wl)

    def tokens(route, seed=0, prompts=prompts, rids=None, **kw):
        out, _ = _serve(wl, params, prompts, route, 6, temperature=0.8, seed=seed, **kw)
        return {r: list(map(int, v)) for r, v in out.items()}

    sampled = tokens("auto")
    assert sampled == tokens("auto") == tokens("cascade")
    assert sampled != tokens("auto", seed=1)
    greedy, _ = _serve(wl, params, prompts, "auto", 6)
    assert sampled != greedy
    # request 3 alone (rid 3) draws what it drew inside a batch of 2
    alone = wl.generate_requests(params, prompts[3][None], 0, device="cpu", rids=[3],
                                 max_new_tokens=6, temperature=0.8)
    assert alone[0].tolist() == sampled[3]
    # a smaller budget is the prefix of a larger one (draws are sequential)
    short = wl.generate_requests(params, prompts[3][None], 0, device="cpu", rids=[3],
                                 max_new_tokens=3, temperature=0.8)
    assert short[0].tolist() == sampled[3][:3]


def test_gumbel_max_sampling_matches_softmax_distribution():
    """10,000 draws of one (V = 6) row, one generator a draw: the counts pass
    a chi-square test (5 degrees of freedom, p = 0.001) against
    softmax(logits / T)."""
    logits = torch.tensor([[1.0, 0.2, -0.5, 2.0, 0.0, 1.2]])
    T, n = 0.7, 10_000
    gens = [stage_generator(11, rid, 1) for rid in range(n)]
    gumbel = LMWorkload._gumbel(gens, 1, 6, "cpu")[:, 0]
    toks = LMWorkload._next_token(logits.expand(n, -1), T, gumbel)[:, 0]
    counts = torch.bincount(toks, minlength=6).double()
    expected = torch.softmax(logits[0].double() / T, -1) * n
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 20.52  # the 0.999 quantile of chi-square with 5 dof
    # the greedy rule takes the first maximum
    assert LMWorkload._next_token(logits)[0, 0] == 3


def test_preempt_on_one_engine_resume_on_another(tiny):
    wl, params = tiny["tti"]
    prompts = _prompts(wl)
    baseline, _ = _serve(wl, params, prompts, "cascade")
    a = _engine(wl, params, "cascade")
    for rid, p in enumerate(prompts):
        a.submit(rid, p)
    a.step()  # one round: every request now waits between stages
    assert sorted(a.parked_rids()) == list(range(N_REQ))
    parked = a.preempt(a.parked_rids())
    assert a.pending() == 0 and max(p.stage_index for p in parked) > 0
    b = _engine(wl, params, "cascade")
    b.resume(parked)
    results = b.run()
    assert b.pipeline.resumed == N_REQ and sorted(results) == list(range(N_REQ))
    for rid in results:
        assert torch.equal(results[rid], baseline[rid])
    with pytest.raises(ValueError, match="cascade route"):
        _engine(wl, params).preempt([0])


def test_lm_serve_engine_alias_and_prompt_limit(tiny):
    wl, params = tiny["lm"]
    eng = LMServeEngine(wl, params, ServeConfig(buckets=(8,)))
    assert eng.route == "lm"
    with pytest.raises(ValueError, match="largest configured bucket"):
        eng.submit(0, np.arange(9))
    assert wl.prepare_request(0, np.arange(9)).prompt_len == 9


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_launcher_serves_stable_diffusion_on_the_cascade_route(capsys, tmp_path):
    stats = tmp_path / "stats.json"
    results = launcher.main(["--arch", "stable-diffusion", "--reduced", "--device", "cpu",
                             "--requests", "4", "--route", "cascade", "--arrivals", "poisson",
                             "--stats-json", str(stats), "--trace-out",
                             str(tmp_path / "trace.json")])
    out = capsys.readouterr().out
    assert sorted(results) == [0, 1, 2, 3]
    for line in ("arch stable-diffusion-reduced | route cascade | stages text_encoderx1 -> "
                 "denoisex3 -> vaex1", "device cpu", "arrivals poisson: ticks [1, 3, 3, 3] | "
                 "admission continuous", "served 4 requests in", "clock [calibrated]: tick = ",
                 "pipeline: ", "admission [continuous]: wait ticks", "stage denoise [auto->kernel]",
                 "tier kernel: stages text_encoder,denoise,vae", "modeled stage-batched vs lockstep",
                 "req 0: output shape (8, 8, 3)", "chrome trace (", "stats json -> "):
        assert line in out, line
    validate_engine_stats(json.loads(stats.read_text()), "cascade")


def test_launcher_serves_llama_on_the_lm_route(capsys):
    results = launcher.main(["--arch", "llama2-7b", "--reduced", "--device", "cpu",
                             "--requests", "3", "--max-new", "4", "--temperature", "0.8"])
    out = capsys.readouterr().out
    assert sorted(results) == [0, 1, 2] and all(len(v) == 4 for v in results.values())
    for line in ("arch llama2-7b-reduced | route lm | stages prefillx1 -> decodex64",
                 "stage prefill: 3 items / 1 dispatches", "prefill ", "tokens 12",
                 "padding_waste per batch: [", f"req 0: {results[0][:8]}..."):
        assert line in out, line


def test_launcher_draws_the_references_prompts():
    """Lengths 4-30 and ids from one seeded generator, in the reference's
    order (length, then ids, request by request)."""
    wl = reduced_workload(get_config("llama2-7b"))
    rng = np.random.default_rng(5)
    for p in launcher.draw_prompts(wl, 3, 5):
        plen = int(rng.integers(4, 31))
        np.testing.assert_array_equal(p, rng.integers(0, wl.prompt_vocab, size=plen))


@pytest.mark.parametrize("flags,match", [
    (["--mesh", "2x1"], "multi-GPU"),
    (["--replicas", "2", "--arrivals", "closed-loop", "--requests", "3"], "fleet"),
    (["--router", "slo", "--autoscale", "3:2"], "fleet"), (["--autoscale", "1"], "fleet"),
    (["--arrival-rps", "2"], "tick-seconds"), (["--stage-impl", "sr"], "name=tier")])
def test_launcher_refuses_what_is_not_ported_or_malformed(flags, match):
    """Sharded serving is not ported; a fleet needs timed arrivals and a
    MIN:MAX autoscale range; the other flags need their partners."""
    with pytest.raises(SystemExit, match=match):
        launcher.main(["--arch", "imagen", "--reduced", "--device", "cpu", "--requests", "1",
                       "--arrivals", "poisson"] + flags)


def test_launcher_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--arch", "stable-diffusion", "--reduced", "--requests", "1"])
