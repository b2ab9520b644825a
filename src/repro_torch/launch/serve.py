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

Sharded serving (``--mesh``) and fleet serving (``--replicas``, ``--router``,
``--autoscale``, ``--preempt``) are not ported yet; those flags exit with a
message.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs import get_config, list_configs
from repro_torch.serving import PATTERNS, ArrivalTrace
from repro_torch.serving.engine import ServeConfig, ServeEngine
from repro_torch.telemetry import json_ready
from repro_torch.workload import reduced_workload, workload_for

PLACEMENT_POLICIES = ("round-robin", "least-queue", "slo")  # the reference's fleet routers


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
                    help="sharded serving over a device mesh: not ported yet")
    ap.add_argument("--seed", type=int, default=0)
    # -- fleet serving: not ported yet -----------------------------------------
    ap.add_argument("--replicas", type=int, default=1, help="fleet mode: not ported yet")
    ap.add_argument("--router", default=None, choices=PLACEMENT_POLICIES,
                    help="fleet placement policy: not ported yet")
    ap.add_argument("--preempt", action="store_true", help="fleet preemption: not ported yet")
    ap.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                    help="fleet autoscaling: not ported yet")
    # -- telemetry export --------------------------------------------------------
    ap.add_argument("--stats-json", default=None, metavar="PATH",
                    help="dump the final engine.stats as JSON")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export the request-lifecycle span timeline as Chrome "
                         "trace-event JSON (open in Perfetto)")
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
    if args.mesh:
        raise SystemExit("--mesh: sharded serving is not ported yet "
                         "(ROADMAP.md, open items 1.7: multi-GPU)")
    if (args.replicas > 1 or args.router is not None or args.autoscale is not None
            or args.preempt):
        raise SystemExit("--replicas/--router/--autoscale/--preempt: fleet serving is not "
                         "ported yet (ROADMAP.md, open items 1.5: fleet)")

    cfg = get_config(args.arch)
    workload = reduced_workload(cfg) if args.reduced else workload_for(cfg)
    cfg = workload.cfg
    params = workload.init(args.seed, args.device)
    serve_cfg = ServeConfig(pod_size=args.pod_size, route=args.route, impl=args.impl,
                            stage_impl=parse_stage_impl(args.stage_impl),
                            admission=args.admission, temperature=args.temperature,
                            tick_seconds=args.tick_seconds, seed=args.seed)
    engine = ServeEngine(workload, params, serve_cfg)
    cd = workload.cost_descriptor()
    print(f"arch {cfg.name} | route {engine.route} | stages "
          + " -> ".join(f"{s.name}x{s.steps}" for s in cd.stages))
    print(f"device {engine.device}")

    arrivals = arrival_ticks(args)
    if args.arrivals != "none":
        print(f"arrivals {args.arrivals}: ticks "
              f"{[t if t is not None else 'on-completion' for t in arrivals]}"
              f" | admission {args.admission}")

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
