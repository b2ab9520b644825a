"""Serving entry point of the port: any registered arch through its
``ServeEngine``, the port of ``repro.launch.serve`` (single engine).

The LM serves through the bucketed prefill + decode route; diffusion,
AR-image and TTV archs through the staggered denoise-pod route.  ``--route
cascade`` serves the workload's stage cascade through the stage-level
pipeline (cross-request per-stage batching, paper §IV-C / §V-A);
``--arrivals`` drives it as an online simulation (requests arrive over
scheduling ticks and join partially drained stage queues), and
``--stage-impl`` pins stages to kernel tiers.  It runs on the card unless
``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stable-diffusion \\
        --requests 4 --route cascade --arrivals poisson
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b --reduced \\
        --device cpu --requests 4

``--replicas``, ``--router``, ``--autoscale`` or ``--preempt`` serve in
fleet mode: one pool of the arch behind a ``fleet.FleetRouter`` (cascade
route forced), with a seeded ``--slo-mix`` of interactive and batch
requests and the fleet summary (``stats["fleet"]``) reported:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stable-diffusion --reduced \
        --device cpu --replicas 2 --router slo --preempt --requests 4

``--mesh DxM`` serves SPMD over a (data, model) mesh of ``D * M`` ranks:
under ``torchrun --nproc_per_node D*M`` (one process a card), or a world of
one in-process for ``1x1``.  Params shard once at startup under the
serving TP rules, batches shard over ``data``, and the cascade route gives
each stage a slice of the ranks; rank 0 prints the report and writes the
files:

    torchrun --nproc_per_node 4 -m repro_torch.launch.serve --arch stable-diffusion \
        --reduced --device cpu --mesh 2x2 --requests 4
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import time

import numpy as np

from repro_torch.configs import get_config, list_configs
from repro_torch.fleet import PLACEMENT_POLICIES, AutoscalePolicy, FleetRouter
from repro_torch.serving import PATTERNS, ArrivalTrace
from repro_torch.serving.engine import ServeConfig, ServeEngine
from repro_torch.telemetry import json_ready
from repro_torch.workload import reduced_workload, workload_for
from repro_torch.workload.base import params_device


def dump_stats_json(path: str, stats: dict) -> None:
    """Write a stats dict as JSON (numpy scalars sanitized)."""
    with open(path, "w") as f:
        json.dump(json_ready(stats), f, indent=2)
    print(f"stats json -> {path}")


def parse_stage_impl(spec: str | None) -> dict | None:
    """``"sr=torch,text_encoder=kernel"`` -> {"sr": "torch", ...}."""
    if not spec:
        return None
    out = {}
    for part in spec.split(","):
        if "=" not in part:
            raise SystemExit(f"--stage-impl entry {part!r} is not name=tier")
        name, tier = part.split("=", 1)
        out[name.strip()] = tier.strip()
    return out


def parse_autoscale(spec: str | None) -> AutoscalePolicy | None:
    """``"1:3"`` -> AutoscalePolicy(min_replicas=1, max_replicas=3)."""
    if not spec:
        return None
    try:
        lo, hi = (int(x) for x in spec.split(":", 1))
        return AutoscalePolicy(min_replicas=lo, max_replicas=hi)
    except ValueError as e:
        raise SystemExit(f"--autoscale expects MIN:MAX fleet replicas: {e}")


def run_fleet(args, workload, params, serve_cfg, arrivals) -> dict:
    """Fleet serving (``--replicas/--router/--autoscale/--preempt``): one
    pool of the arch behind a ``FleetRouter``, a seeded ``--slo-mix`` tier
    for each request, and the per-tier deadline-attainment report.  Returns
    ``{rid: output}``."""
    policy = args.router or "round-robin"
    autoscale = parse_autoscale(args.autoscale)
    fleet = FleetRouter({args.arch: (workload, params)}, serve_cfg, n_replicas=args.replicas,
                        policy=policy, preempt=args.preempt, autoscale=autoscale)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        tick = arrivals[rid]
        if tick is None:
            raise SystemExit("fleet serving needs timed arrivals (closed-loop is a "
                             "single-engine mode)")
        plen = int(rng.integers(4, min(workload.max_prompt_len, 30) + 1))
        prompt = rng.integers(0, workload.prompt_vocab, size=plen)
        interactive = bool(rng.random() < args.slo_mix)
        fleet.submit(args.arch, rid, prompt, arrival_tick=tick, max_new_tokens=args.max_new,
                     slo_tier="interactive" if interactive else "batch",
                     deadline_ticks=args.deadline_ticks if interactive else None)
    t0 = time.perf_counter()
    results = fleet.run()
    dt = time.perf_counter() - t0
    s = fleet.summary()
    scale = f" | autoscale {autoscale.min_replicas}:{autoscale.max_replicas}" if autoscale else ""
    print(f"fleet [{policy}{', preempt' if args.preempt else ''}{scale}]: served "
          f"{len(results)} requests in {dt:.2f}s over {s['replicas']['configured']} replicas, "
          f"{s['ticks']} ticks")
    for tier, t in s["tiers"].items():
        lat = t["latency_ticks"]
        print(f"  tier {tier}: {t['requests']} reqs | latency ticks p50 {lat['p50']:.0f} p95 "
              f"{lat['p95']:.0f} | deadline attainment {t['deadline_attainment']:.0%} "
              f"({t['deadline_misses']} misses / {t['deadline_requests']} deadlined)")
    print(f"  preemption: {s['preempted_ticks']} preempted ticks, {s['preemptions']} events, "
          f"{s['parked']} parked / {s['resumed']} resumed, {s['migrations']} migrations")
    util = ", ".join(f"r{i}={u:.0%}" for i, u in enumerate(s["replicas"]["utilization"]))
    print(f"  replicas: {util} | mean active {s['replicas']['mean_active']:.2f} | replica-ticks "
          f"{s['replicas']['replica_ticks']}")
    if s["autoscale"] is not None:
        print(f"  autoscale events: {s['autoscale']['scale_events']}")
    if args.trace_out:
        n = fleet.export_chrome_trace(args.trace_out)
        print(f"chrome trace ({n} events, per-replica tracks) -> {args.trace_out}")
    if args.stats_json:
        dump_stats_json(args.stats_json, s)
    return results


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b", choices=list_configs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the params live and the engine runs (cpu: the kernels' "
                         "plain versions)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--pod-size", type=int, default=0)
    ap.add_argument("--route", default="auto", choices=("auto", "cascade"),
                    help="cascade = stage-level pipeline serving")
    ap.add_argument("--impl", default="auto",
                    help="kernel tier threaded to generate/run_stage")
    ap.add_argument("--stage-impl", default=None, metavar="NAME=TIER,...",
                    help="per-cascade-stage tier overrides, matched by exact stage name or "
                         "prefix (e.g. sr=torch puts every SR stage on the torch tier)")
    ap.add_argument("--arrivals", default="none", choices=("none",) + PATTERNS,
                    help="online arrival pattern (none = all at tick 0)")
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="poisson: mean arrivals per scheduling tick")
    ap.add_argument("--arrival-rps", type=float, default=None,
                    help="poisson/burst rate in requests per SECOND instead of per tick "
                         "(requires --tick-seconds to map the tick clock to wall time)")
    ap.add_argument("--tick-seconds", type=float, default=None,
                    help="wall-clock seconds per scheduling tick; default auto-calibrates "
                         "from the measured busy-tick service time (stats['clock'])")
    ap.add_argument("--admission", default="continuous", choices=("continuous", "pod"),
                    help="continuous = arrival-pressure pod flush; pod = hold partial pods "
                         "until arrivals fill them")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="LM sampling temperature (0 = greedy)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve over a (data, model) mesh of D*M ranks, e.g. 2x2: params "
                         "TP-sharded on model, batches sharded on data")
    ap.add_argument("--seed", type=int, default=0)
    # -- fleet serving ---------------------------------------------------------
    ap.add_argument("--replicas", type=int, default=1,
                    help="fleet mode: serve across N engine replicas (cascade route forced)")
    ap.add_argument("--router", default=None, choices=PLACEMENT_POLICIES,
                    help="fleet placement policy (implies fleet mode)")
    ap.add_argument("--slo-mix", type=float, default=0.5,
                    help="fleet: fraction of requests in the interactive SLO tier (seeded "
                         "per-request assignment; the rest are batch tier)")
    ap.add_argument("--deadline-ticks", type=int, default=25,
                    help="fleet: end-to-end deadline of interactive-tier requests, in fleet "
                         "ticks (batch tier is best-effort)")
    ap.add_argument("--preempt", action="store_true",
                    help="fleet: migrate batch-tier work parked at stage boundaries off "
                         "replicas with interactive backlog (requires --router slo)")
    ap.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                    help="fleet: queue-depth autoscaling between MIN and MAX active replicas "
                         "(overrides --replicas)")
    # -- telemetry export --------------------------------------------------------
    ap.add_argument("--stats-json", default=None, metavar="PATH",
                    help="dump the final engine.stats (fleet mode: the fleet summary) as JSON")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export the request-lifecycle span timeline as Chrome "
                         "trace-event JSON (open in Perfetto; fleet mode: one track per "
                         "replica engine)")
    return ap.parse_args(argv)


def draw_prompts(workload, n: int, seed: int) -> list:
    """The launcher's seeded prompts: ``n`` id arrays of 4-30 tokens (at most
    the workload's prompt length), ids below its prompt vocab."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        plen = int(rng.integers(4, min(workload.max_prompt_len, 30) + 1))
        out.append(rng.integers(0, workload.prompt_vocab, size=plen))
    return out


def arrival_ticks(args) -> list:
    """Each request's arrival tick (``None``: on a completion) from the
    ``--arrivals`` flags."""
    if args.arrival_rps is not None:
        if args.tick_seconds is None:
            raise SystemExit("--arrival-rps needs --tick-seconds to map req/s onto the "
                             "scheduling-tick clock")
        if args.arrivals == "none":
            raise SystemExit("--arrival-rps needs an --arrivals pattern")
        try:
            trace = ArrivalTrace.from_rps(args.arrivals, args.arrival_rps, args.tick_seconds,
                                          seed=args.seed)
        except ValueError as e:  # rate-less pattern (closed-loop)
            raise SystemExit(str(e))
    else:
        trace = (ArrivalTrace(args.arrivals, rate=args.arrival_rate, seed=args.seed)
                 if args.arrivals != "none" else None)
    return [0] * args.requests if trace is None else trace.ticks(args.requests)


def main(argv=None) -> dict:
    """Serve ``--requests`` seeded prompts and print the report; returns
    ``{rid: output}``."""
    args = parse_args(argv)
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_debug_mesh, parse_mesh

        try:
            mesh = make_debug_mesh(*parse_mesh(args.mesh), device=args.device)
        except ValueError as e:
            raise SystemExit(f"--mesh {args.mesh}: {e}")
        import torch.distributed as dist

        if dist.get_rank() != 0:  # rank 0 reports and writes the files
            args.trace_out = args.stats_json = None
            with contextlib.redirect_stdout(io.StringIO()):
                return _serve(args, mesh)
    return _serve(args, mesh)


def _serve(args, mesh) -> dict:
    cfg = get_config(args.arch)
    workload = reduced_workload(cfg) if args.reduced else workload_for(cfg)
    cfg = workload.cfg
    params = workload.init(args.seed, args.device)
    fleet_mode = (args.replicas > 1 or args.router is not None or args.autoscale is not None
                  or args.preempt)
    serve_cfg = ServeConfig(pod_size=args.pod_size, route=args.route, impl=args.impl,
                            stage_impl=parse_stage_impl(args.stage_impl),
                            admission=args.admission, temperature=args.temperature,
                            tick_seconds=args.tick_seconds, seed=args.seed, mesh=mesh)
    engine = None if fleet_mode else ServeEngine(workload, params, serve_cfg)
    cd = workload.cost_descriptor()
    print(f"arch {cfg.name} | route {'cascade' if fleet_mode else engine.route} | stages "
          + " -> ".join(f"{s.name}x{s.steps}" for s in cd.stages))
    print(f"device {params_device(params)}")
    if engine is not None and mesh is not None:
        ms = engine.stats["mesh"]
        print(f"mesh {ms['axes']} ({ms['devices']} devices) | TP coverage "
              f"{ms['params']['tp_coverage']:.1%} ({ms['params']['sharded_bytes']}/"
              f"{ms['params']['total_bytes']} bytes sharded, "
              f"{ms['params']['replication_fallbacks']:.0f} replication fallbacks)")

    arrivals = arrival_ticks(args)
    if args.arrivals != "none":
        print(f"arrivals {args.arrivals}: ticks "
              f"{[t if t is not None else 'on-completion' for t in arrivals]}"
              f" | admission {args.admission}")
    if fleet_mode:
        return run_fleet(args, workload, params, serve_cfg, arrivals)

    t0 = time.perf_counter()
    for rid, prompt in enumerate(draw_prompts(workload, args.requests, args.seed)):
        engine.submit(rid, prompt, args.max_new, arrival_tick=arrivals[rid])
    results = engine.run()
    dt = time.perf_counter() - t0

    s = engine.stats
    print(f"served {len(results)} requests in {dt:.2f}s")
    clock = s.get("clock", {})
    if clock.get("tick_seconds"):
        lat = s["request_latency_s"]
        print(f"  clock [{clock['source']}]: tick = {clock['tick_seconds'] * 1e3:.1f}ms | "
              f"{s['requests_per_s']:.2f} req/s | e2e p50 {lat['p50'] * 1e3:.0f}ms p95 "
              f"{lat['p95'] * 1e3:.0f}ms (ticks: p50 {s['request_latency_ticks']['p50']:.0f} "
              f"p95 {s['request_latency_ticks']['p95']:.0f})")
    for tier, t in s["tier_throughput"].items():
        print(f"  tier {tier}: {t['requests']} reqs, {t['rps']:.2f} req/s")
    for name, st in s.get("stages", {}).items():
        print(f"  stage {name}: {st['items']} items / {st['dispatches']} dispatches, "
              f"{st['exec_s']:.2f}s")
    if engine.route == "cascade":
        c = s["cascade"]
        print(f"  pipeline: {c['ticks']} ticks, stage concurrency max "
              f"{c['concurrency']['max']} mean {c['concurrency']['mean']:.2f}")
        if "mesh" in c:
            cm = c["mesh"]
            sd = ", ".join(f"{n}={k}" for n, k in cm["stage_devices"].items())
            print(f"  stage meshes: {sd} | {cm['reshard_events']} reshards, "
                  f"{cm['reshard_bytes']} bytes moved")
        adm = c["admission"]
        print(f"  admission [{adm['policy']}]: wait ticks p50 {adm['wait_ticks']['p50']:.0f} "
              f"p95 {adm['wait_ticks']['p95']:.0f} | request e2e ticks p50 "
              f"{c['request_latency_ticks']['p50']:.0f} p95 "
              f"{c['request_latency_ticks']['p95']:.0f}")
        for name, st in c["stages"].items():
            q, w = st["queue"], st["queue_wait_ticks"]
            tier = (st["impl"] if st["impl"] == st["effective_impl"]
                    else f"{st['impl']}->{st['effective_impl']}")
            print(f"  stage {name} [{tier}]: {st['items']} items / {st['batches']} batches "
                  f"(mean {st['mean_batch']:.1f}, cap {st['max_batch']}) {st['exec_s']:.2f}s | "
                  f"queue wait p50 {w['p50']:.0f} p95 {w['p95']:.0f} ticks, occ max "
                  f"{q['max_occupancy']}")
        for tier, t in c["tiers"].items():
            print(f"  tier {tier}: stages {','.join(t['stages'])} | {t['items']} items, "
                  f"{t['rps']:.2f} items/s")
        h = c["hbm"]
        print(f"  modeled stage-batched vs lockstep: {h['throughput_gain']:.2f}x throughput, "
              f"HBM flatness {h['lockstep']['flatness']:.2f} -> "
              f"{h['pipelined']['flatness']:.2f}")
        for rid in sorted(results)[:3]:
            print(f"  req {rid}: output shape {tuple(results[rid].shape)}")
    elif workload.route == "lm":
        waste = s["padding_waste"]
        print(f"  prefill {s['prefill_s']:.2f}s decode {s['decode_s']:.2f}s "
              f"tokens {s['tokens']}")
        print(f"  padding_waste per batch: {[round(w, 3) for w in waste]} "
              f"(mean {np.mean(waste):.1%})" if waste else "  padding_waste: no batches served")
        for rid in sorted(results)[:3]:
            print(f"  req {rid}: {results[rid][:8]}...")
    else:
        print(f"  generate {s['generate_s']:.2f}s over {s['pods']} pod(s)")
        if s["bandwidth_profile"]:
            prof = s["bandwidth_profile"][-1]
            print(f"  stagger bandwidth profile: aligned peak {prof['aligned_peak']:.0f} -> "
                  f"staggered {prof['staggered_peak']:.0f} "
                  f"({prof['peak_reduction']:.2f}x peak reduction)")
        for rid in sorted(results)[:3]:
            print(f"  req {rid}: output shape {tuple(results[rid].shape)}")

    if args.trace_out:
        n = engine.export_chrome_trace(args.trace_out)
        print(f"chrome trace ({n} events) -> {args.trace_out}")
    if args.stats_json:
        dump_stats_json(args.stats_json, s)
    return results


if __name__ == "__main__":
    main()
