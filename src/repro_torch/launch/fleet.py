"""Fleet serving driver: N `ServeEngine` replicas behind the prefix-aware
router, under a trace-driven load (DESIGN.md § Fleet tier).

    python -m repro_torch.launch.fleet --arch qwen3-1.7b --replicas 2 \
        --policy prefix --compare --profile --objects
    python -m repro_torch.launch.fleet --arch qwen3-1.7b --check-single \
        --dtype float32

serves qwen3-1.7b at its published width from random weights (seeded)
on the CUDA device, every replica in one process over one shared
parameter tree (each with its own paged f32 KV pool); ``--device cpu``
runs on the CPU (with ``--smoke``, the reduced config). Without CUDA and
without ``--device cpu`` it raises.

Port of src/repro/launch/fleet.py. Reports p50/p99 TTFT and TPOT,
per-replica queue depth, prefix-hit fraction, eviction/preemption/
backpressure counts, and the fleet-level ``fleet_silent_prefix_load``
Def.-3 bytes the routing policy did (or did not) avoid. ``--compare``
replays the SAME trace under random routing; ``--check-single`` replays
it through one big single engine and asserts greedy outputs are
bit-identical to the fleet's. ``--profile`` attaches per-replica serve
detectors and merges every member's `WasteProfile` into one fleet
profile (`core.findings.merge_fleet`) for ``--profile-out`` /
``--sarif-out``. ``--objects`` attaches the object registry (the shared
parameter tree registered once per replica, every KV page, core/
objects.py) to the measured fleet and runs the replica scan (core/
replicas.py) after the trace drains; ``--dedup`` turns on the router's
and the engines' content-addressed dedup of same-burst duplicate
prefixes.

``--dtype float32`` computes in float32 (the config's bfloat16
otherwise): at full width the fleet's greedy tokens equal one engine's
in float32, while in bfloat16 some differ (PERF.md § 6), so
``--check-single`` at full width wants float32.

Every fleet in one invocation shares a `serve.decode.StepCache`, so
replicas (and compared policies) run the same step functions. Each
measured policy runs the trace twice on fresh fleets and reports the
second (warm) run.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import numpy as np

from repro_torch.configs import registry
from repro_torch.configs.base import ProfilerConfig
from repro_torch.core.detectors import ServingDetectors
from repro_torch.core.findings import merge_fleet
from repro_torch.core.objects import ObjectRegistry, register_tree
from repro_torch.core.replicas import ReplicaDetector, cross_replica_bytes
from repro_torch.core.report import dump_json
from repro_torch.core.sarif import write_sarif
from repro_torch.launch.serve import resolve_device
from repro_torch.models.zoo import build_model
from repro_torch.serve.decode import StepCache
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.router import FleetRouter
from repro_torch.serve.workload import Trace, make_trace

# Default workload: spaced poisson arrivals with a long shared prefix.
# Spacing keeps owner-side queueing out of the picture, so the
# comparison isolates what routing controls: who re-pays the prefix.
DEF = dict(replicas=2, slots=2, page_size=8, requests=12,
           prompt_len=48, prefix_len=40, gen=4, dup_rate=0.8,
           arrival="poisson", rate=0.3, burst_size=2, burst_gap=2)


def _build_fleet(model, params, *, replicas, slots, max_len, page_size,
                 num_pages, policy, seed, step_cache, profile,
                 obj_registry=None, content_dedup=False):
    if num_pages is None:
        # the engine's own default (slots x max pages) leaves zero
        # headroom for prefix pins: every admission would immediately
        # evict what the last one published. Two extra slots' worth
        # keeps hot prefixes resident.
        num_pages = (slots + 2) * (-(-max_len // page_size))
    engines, dets = [], []
    for i in range(replicas):
        det = ServingDetectors(ProfilerConfig(enabled=True, seed=seed + i)) \
            if profile else None
        dets.append(det)
        if obj_registry is not None:
            # one logical weight copy per replica: the layout a
            # multi-host fleet materializes, and what the replica
            # detector reports as dedupable cross-replica params
            register_tree(obj_registry, f"replica{i}/params", params)
        engines.append(ServeEngine(
            model, params, num_slots=slots, max_len=max_len,
            kv_layout="paged", page_size=page_size, num_pages=num_pages,
            detectors=det, step_cache=step_cache,
            registry=obj_registry, owner=f"replica{i}",
            content_dedup=content_dedup))
    return FleetRouter(engines, policy=policy, seed=seed,
                       content_dedup=content_dedup), dets


def _run_policy(model, params, trace, *, policy, replicas, slots, max_len,
                page_size, num_pages, seed, step_cache, profile=False,
                obj_registry=None, content_dedup=False):
    """Warm-up pass + measured pass on fresh fleets (shared steps).

    The object registry only attaches to the MEASURED fleet: a warm-up
    fleet's registered pages would put a dead fleet's objects into the
    replica scan."""
    for measured in (False, True):
        fleet, dets = _build_fleet(
            model, params, replicas=replicas, slots=slots, max_len=max_len,
            page_size=page_size, num_pages=num_pages, policy=policy,
            seed=seed, step_cache=step_cache,
            profile=profile and measured,
            obj_registry=obj_registry if measured else None,
            content_dedup=content_dedup)
        fleet.submit_trace(trace)
        fleet.run()
        fleet.check()
    return fleet, dets


def _single_engine_outputs(model, params, trace, *, slots, max_len,
                           page_size, step_cache):
    """The whole trace through ONE engine (arrival order preserved): the
    bit-identity oracle for the fleet's greedy outputs."""
    eng = ServeEngine(model, params, num_slots=slots, max_len=max_len,
                      kv_layout="paged", page_size=page_size,
                      step_cache=step_cache)
    for treq in sorted(trace.requests, key=lambda r: r.arrival):
        eng.submit(Request(rid=treq.rid, tokens=np.asarray(treq.tokens),
                           max_new_tokens=treq.max_new_tokens))
    eng.run()
    return {rid: list(r.generated) for rid, r in eng.finished.items()}


def _print_summary(tag, fleet):
    lat = fleet.latency_summary()
    ms = lambda k: lat.get(k, 0.0) * 1e3  # noqa: E731
    print(f"[fleet:{tag}] TTFT p50 {ms('ttft_p50'):.1f} ms / "
          f"p99 {ms('ttft_p99'):.1f} ms | TPOT p50 {ms('tpot_p50'):.2f} ms "
          f"/ p99 {ms('tpot_p99'):.2f} ms")
    q = ", ".join(f"r{d['replica']}: mean {d['mean_depth']:.1f} "
                  f"max {d['max_depth']}" for d in fleet.queue_summary())
    print(f"[fleet:{tag}] queue depth {q}")
    s = fleet.stats
    print(f"[fleet:{tag}] dispatched {s['dispatched']} | "
          f"prefix routes {s['prefix_routes']} "
          f"(cross-replica prefix routes: "
          f"{s['cross_replica_prefix_routes']}) | "
          f"fallback {s['fallback_routes']} | "
          f"backpressure ticks {s['backpressure_ticks']}")
    print(f"[fleet:{tag}] prefix-hit fraction "
          f"{fleet.prefix_hit_fraction():.2f} | global evictions "
          f"{s['global_evictions']} | preemption-evicted pages "
          f"{s['preemption_evicted_pages']} | fleet silent-prefix-load "
          f"{fleet.fleet_waste_bytes():.0f} bytes")
    return lat


def run(arch: str, *, smoke: bool = False, replicas: int = DEF["replicas"],
        slots: int = DEF["slots"], policy: str = "prefix",
        page_size: int = DEF["page_size"], num_pages: Optional[int] = None,
        requests: int = DEF["requests"],
        prompt_len: int = DEF["prompt_len"],
        prefix_len: int = DEF["prefix_len"], gen: int = DEF["gen"],
        dup_rate: float = DEF["dup_rate"], arrival: str = DEF["arrival"],
        rate: float = DEF["rate"], burst_size: int = DEF["burst_size"],
        burst_gap: int = DEF["burst_gap"], seed: int = 0,
        trace_in: Optional[str] = None, trace_out: Optional[str] = None,
        compare: bool = False, check_single: bool = False,
        profile: bool = False, profile_out: Optional[str] = None,
        sarif_out: Optional[str] = None, objects: bool = False,
        dedup: bool = False, device: str = "cuda",
        dtype: Optional[str] = None):
    """Serve one trace over the fleet (see the module docstring).
    ``dtype`` overrides the config's compute dtype (the pools stay
    float32).

    Returns ``(fleet, merged profile or None, info)``: the measured
    `FleetRouter`, the merged fleet profile with ``profile``, and a dict
    holding the ``trace``, the object ``scan`` and its seconds
    (``scan_s``) with ``objects``, the ``compared`` fleet with
    ``compare``, and the ``single`` outputs with ``check_single``."""
    dev = resolve_device(device)
    cfg = registry.get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = build_model(cfg)
    params = model.init(seed, device=dev)

    if trace_in:
        trace = Trace.load(trace_in)
        print(f"[fleet] replaying trace {trace_in} "
              f"({len(trace)} requests, dup {trace.dup_fraction():.2f})")
    else:
        trace = make_trace(
            n_requests=requests, vocab_size=cfg.vocab_size, seed=seed,
            arrival=arrival, rate=rate, burst_size=burst_size,
            burst_gap=burst_gap, prompt_len=(prompt_len, prompt_len),
            gen_len=(gen, gen), dup_rate=dup_rate, n_prefixes=1,
            prefix_len=prefix_len)
    if trace_out:
        trace.save(trace_out)
        print(f"[fleet] trace written to {trace_out}")
    info = {"trace": trace}

    max_len = trace.max_prompt_len + trace.max_new_tokens + 1
    step_cache = StepCache(model)
    kw = dict(replicas=replicas, slots=slots, max_len=max_len,
              page_size=page_size, num_pages=num_pages, seed=seed,
              step_cache=step_cache)

    obj_registry = ObjectRegistry() if objects else None
    fleet, dets = _run_policy(model, params, trace, policy=policy,
                              profile=profile, obj_registry=obj_registry,
                              content_dedup=dedup, **kw)
    name = f"{dev.type}, {cfg.dtype}"
    print(f"[fleet] {arch}: {len(trace)} requests over {replicas} "
          f"replicas x {slots} slots [policy={policy}] [{name}]"
          + (" [content-dedup]" if dedup else ""))
    lat = _print_summary(policy, fleet)

    scan = None
    if objects:
        t0 = time.perf_counter()
        scan = ReplicaDetector(obj_registry).scan()
        info.update(scan=scan, scan_s=time.perf_counter() - t0,
                    registry=obj_registry)
        dup_bytes = sum(f.bytes for f in scan.findings)
        kv_x = cross_replica_bytes(scan, "replica_kv_page")
        deferrals = sum(e.stats["dedup_deferred"] for e in fleet.engines)
        print(f"[fleet] object registry: {len(obj_registry)} live objects"
              f" ({obj_registry.nbytes_live():.0f} bytes)")
        print(f"[fleet] replica findings: {len(scan.findings)} groups, "
              f"{dup_bytes:.0f} duplicate bytes | cross-replica kv "
              f"replica bytes: {kv_x:.0f}")
        print(f"[fleet] dedup deferrals: {deferrals} | content-dedup "
              f"routes: {fleet.stats['content_dedup_routes']}")
        print(scan.render(top_k=5, by="object"))

    if compare:
        other = "random" if policy != "random" else "prefix"
        fleet2, _ = _run_policy(model, params, trace, policy=other, **kw)
        info["compared"] = fleet2
        lat2 = _print_summary(other, fleet2)
        better_ttft = lat.get("ttft_p99", 0) < lat2.get("ttft_p99", 0)
        better_waste = fleet.fleet_waste_bytes() < fleet2.fleet_waste_bytes()
        print(f"[fleet] {policy} beats {other} on p99 TTFT: {better_ttft} "
              f"({lat.get('ttft_p99', 0)*1e3:.1f} vs "
              f"{lat2.get('ttft_p99', 0)*1e3:.1f} ms) | on fleet "
              f"silent-prefix-load bytes: {better_waste} "
              f"({fleet.fleet_waste_bytes():.0f} vs "
              f"{fleet2.fleet_waste_bytes():.0f})")

    if check_single:
        single = _single_engine_outputs(
            model, params, trace, slots=replicas * slots, max_len=max_len,
            page_size=page_size, step_cache=step_cache)
        info["single"] = single
        ours = {rid: list(r.generated) for rid, r in fleet.finished.items()}
        identical = ours == single
        print(f"[fleet] bit-identical to single-engine: {identical}")
        assert identical, \
            "fleet greedy outputs diverged from the single-engine run"

    merged = None
    if profile:
        members = {f"replica{i}": d.combined()
                   for i, d in enumerate(dets) if d is not None}
        members["router"] = fleet.profile
        if scan is not None:
            members["objects"] = scan
        merged = merge_fleet(members)
        print(merged.render(top_k=3))
        if profile_out:
            dump_json(merged, profile_out)
            print(f"[fleet] waste profile written to {profile_out}")
        if sarif_out:
            write_sarif(merged, sarif_out, src_root=os.getcwd())
            print(f"[fleet] SARIF findings written to {sarif_out}")
    return fleet, merged, info


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--replicas", type=int, default=DEF["replicas"])
    ap.add_argument("--slots", type=int, default=DEF["slots"],
                    help="decode slots per replica")
    ap.add_argument("--policy", default="prefix",
                    choices=("prefix", "least", "random"))
    ap.add_argument("--page-size", type=int, default=DEF["page_size"])
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pages per replica pool (default: slots + 2 "
                         "slots' worth of pages)")
    ap.add_argument("--requests", type=int, default=DEF["requests"])
    ap.add_argument("--prompt-len", type=int, default=DEF["prompt_len"])
    ap.add_argument("--prefix-len", type=int, default=DEF["prefix_len"])
    ap.add_argument("--gen", type=int, default=DEF["gen"])
    ap.add_argument("--dup-rate", type=float, default=DEF["dup_rate"])
    ap.add_argument("--arrival", default=DEF["arrival"],
                    choices=("poisson", "bursty", "uniform"))
    ap.add_argument("--rate", type=float, default=DEF["rate"],
                    help="poisson/uniform arrivals per scheduler tick")
    ap.add_argument("--burst-size", type=int, default=DEF["burst_size"])
    ap.add_argument("--burst-gap", type=int, default=DEF["burst_gap"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-in", default=None,
                    help="replay a saved trace JSON instead of generating")
    ap.add_argument("--trace-out", default=None,
                    help="save the generated trace JSON")
    ap.add_argument("--compare", action="store_true",
                    help="replay the same trace under the opposite "
                         "routing policy and print the comparison")
    ap.add_argument("--check-single", action="store_true",
                    help="assert greedy outputs are bit-identical to a "
                         "single-engine run of the same trace")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--profile-out", default=None)
    ap.add_argument("--sarif-out", default=None)
    ap.add_argument("--objects", action="store_true",
                    help="attach the object registry and run the "
                         "OJXPerf replica scan after the trace drains")
    ap.add_argument("--dedup", action="store_true",
                    help="content-addressed dedup of same-burst "
                         "duplicate prefixes (router + engine)")
    ap.add_argument("--dtype", default=None,
                    choices=("bfloat16", "float32"),
                    help="compute dtype (default: the config's); the KV "
                         "pools are float32 either way")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    a = ap.parse_args()
    run(a.arch, smoke=a.smoke, replicas=a.replicas, slots=a.slots,
        policy=a.policy, page_size=a.page_size, num_pages=a.num_pages,
        requests=a.requests, prompt_len=a.prompt_len,
        prefix_len=a.prefix_len, gen=a.gen, dup_rate=a.dup_rate,
        arrival=a.arrival, rate=a.rate, burst_size=a.burst_size,
        burst_gap=a.burst_gap, seed=a.seed, trace_in=a.trace_in,
        trace_out=a.trace_out, compare=a.compare,
        check_single=a.check_single, profile=a.profile,
        profile_out=a.profile_out, sarif_out=a.sarif_out,
        objects=a.objects, dedup=a.dedup, device=a.device, dtype=a.dtype)


if __name__ == "__main__":
    main()
