"""Zoo-wide waste matrix: profile every registry config, rank by
redundancy fraction (port of src/repro/launch/matrix.py).

For each ``configs/registry.all_cells()`` cell (arch x assigned shape,
gated by ``cell_applicable``) the driver runs the profiler stack the
cell's kind calls for and merges the per-cell profiles via the paper's
§5.6 associative merge:

  train cells   — tier-0 static lint of the train step + tier-3
                  ``TrainingDetectors`` over real (toy-sized) train
                  steps + the MoE dead-expert-store probe
                  (``models.moe.dispatch_stats``) for MoE families;
  prefill cells — tier-0 prefill lint + the serve run's padding
                  accounting (prompt-bucket padding on the engine
                  families, encoder-frame padding on encoder-decoder);
  decode cells  — tier-0 decode lint + tier-3 ``ServingDetectors`` from
                  the same serve run (long_500k decode cells rerun the
                  serve loop at a longer toy extent).

The report (``--out matrix_report.json``) ranks ⟨config, tier, site⟩
by redundancy fraction (Eq. 1: flagged/checked — the *Redundant Loads*
cross-workload indicator) then waste bytes; ``--sarif-out`` exports the
merged findings and ``--leaderboard-out`` writes the markdown table.
Everything is seeded and wall-clock-free, so two runs of the same tree
produce byte-identical rankings. The cells run on ``--device`` (default
cuda; the tier-0 lints on fake tensors there).

CI gate (zoo-matrix job):

    python -m repro_torch.launch.matrix --toy \\
        --configs granite-moe-3b-a800m,zamba2-1.2b,whisper-large-v3 \\
        --out matrix_report.json --sarif-out matrix.sarif \\
        --max-moe-dead-expert-fraction 0.0

exits nonzero if any applicable cell errors or an MoE cell's
dead-expert-store fraction regresses above the post-fix value (the
scatter dispatch stores only routed rows, so the fraction is 0).
"""
from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ProfilerConfig, TrainConfig
from repro_torch.core.detectors import ServingDetectors, TrainingDetectors
from repro_torch.core.findings import Finding, WasteProfile, merge_profiles
from repro_torch.core.sarif import write_sarif
from repro_torch.data.synthetic import batch_at
from repro_torch.launch import lint as lint_mod
from repro_torch.launch import serve as serve_mod
from repro_torch.models import moe as MOE
from repro_torch.models.params import tree_map
from repro_torch.models.zoo import build_model
from repro_torch.serve.engine import ENGINE_FAMILIES, Request, ServeEngine
from repro_torch.train import state as TS
from repro_torch.train.step import make_train_step

SCHEMA = 1

# Toy dims per shape kind: the assigned shapes (4k train, 32k prefill,
# 500k decode) scaled to CI-runnable extents while keeping every cell
# distinct. "long" is the long_500k decode cell's longer toy extent.
_DIMS = {
    True: {   # --toy
        "train": dict(batch=2, seq=32, steps=2),
        "serve": dict(batch=4, prompt=16, gen=8),
        "long": dict(batch=2, prompt=8, gen=16),
    },
    False: {  # full-ish (still smoke configs; real shapes need real HW)
        "train": dict(batch=4, seq=64, steps=3),
        "serve": dict(batch=4, prompt=32, gen=16),
        "long": dict(batch=2, prompt=16, gen=32),
    },
}


def _site(f: Finding) -> str:
    """file.py:line when provenance carries it, else the C1 tail."""
    if "file" in f.meta:
        return (f"{os.path.basename(str(f.meta['file']))}:"
                f"{int(f.meta.get('line', 0) or 0)}")
    path = f.meta.get("path")
    if path:
        return str(path)
    return "|".join(f.c1[-2:]) if f.c1 else f.kind


def _moe_probe(arch: str, cfg, params, *, batch: int, seq: int,
               seed: int) -> WasteProfile:
    """Tier-3 dead-expert-store accounting of the MoE dispatch buffer.

    Routes the embedded token batch through layer 0's router (the
    routing front-end is dispatch-independent) and bills the (E, C)
    buffer rows the configured dispatch stores but no token was routed
    to — the full buffer under "einsum", exactly the routed rows under
    "scatter" (dead fraction 0 by construction)."""
    def find_moe(tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                if k == "moe":
                    return v
                r = find_moe(v)
                if r is not None:
                    return r
        return None

    prof = WasteProfile(tier=3)
    stacked = find_moe(params)
    if stacked is None:
        return prof
    pm = tree_map(lambda a: a[0], stacked)
    data = batch_at(cfg, batch, seq, seed=seed, step=0)
    embed = params["embed"]
    tokens = torch.as_tensor(np.asarray(data["tokens"]), device=embed.device)
    with torch.no_grad():
        x = embed[tokens.long()].to(torch.float32)
        st = MOE.dispatch_stats(pm, cfg, x)
    prof.checked["dead_expert_store"] = int(st["rows_stored"])
    prof.flagged["dead_expert_store"] = int(st["dead_rows"])
    if st["dead_rows"]:
        prof.add(Finding(
            kind="dead_expert_store", tier=3,
            c1=("models.moe:apply_moe",), c2=(f"{arch}:train_step",),
            count=int(st["dead_rows"]), bytes=float(st["dead_bytes"]),
            fraction=float(st["dead_fraction"]),
            meta={"file": inspect.getsourcefile(MOE),
                  "line": inspect.getsourcelines(MOE.apply_moe)[1],
                  "dispatch": st["dispatch"],
                  "rows_total": int(st["rows_total"]),
                  "rows_routed": int(st["rows_routed"]),
                  "rule": "unrouted rows of the (B,E,C,d) dispatch "
                          "buffer are stored and never read (Def. 1); "
                          "fix: moe.dispatch='scatter'"}))
    return prof


def _train_profiles(arch: str, cfg, model, *, seed: int,
                    dims: Dict[str, int], device) -> List[WasteProfile]:
    tc = TrainConfig(learning_rate=1e-3, total_steps=dims["steps"],
                     warmup_steps=1, seed=seed)
    step_fn = make_train_step(model, tc)
    state = TS.create(model, seed, device=device)
    det = TrainingDetectors(ProfilerConfig(enabled=True, seed=seed))
    for step in range(dims["steps"]):
        b = batch_at(cfg, dims["batch"], dims["seq"], seed=seed, step=step)
        det.on_batch(step, b)
        params_before = state.params
        state, _ = step_fn(state, {k: torch.from_numpy(v).to(device)
                                   for k, v in b.items()})
        det.on_step(step, params_before, state.params)
    profs = [det.report]
    if cfg.moe is not None:
        profs.append(_moe_probe(arch, cfg, state.params,
                                batch=dims["batch"], seq=dims["seq"],
                                seed=seed))
    return profs


def _serve_profiles(arch: str, cfg, model, params, *, seed: int,
                    dims: Dict[str, int], bucket_frames: bool,
                    device) -> Dict[str, WasteProfile]:
    """One serve run -> {"prefill": padding profile, "decode": tier-3}."""
    batch, prompt, gen = dims["batch"], dims["prompt"], dims["gen"]
    data = batch_at(cfg, batch, prompt, seed=seed, step=0)
    prompts = np.asarray(data["tokens"])
    if cfg.family in ENGINE_FAMILIES:
        det = ServingDetectors(ProfilerConfig(enabled=True, seed=seed))
        eng = ServeEngine(model, params, num_slots=batch,
                          max_len=prompt + gen + 1, detectors=det,
                          kv_dtype=torch.float32)
        # varied true prompt lengths so the engine's pow2 bucketing has
        # real padding to account (uniform lengths would hide it)
        rng = np.random.Generator(np.random.Philox(
            key=seed, counter=[0, 0, 2, 0]))
        lens = rng.integers(max(2, prompt // 2), prompt + 1, size=batch)
        for b in range(batch):
            eng.submit(Request(rid=f"r{b}",
                               tokens=prompts[b][:int(lens[b])],
                               max_new_tokens=gen))
        eng.run()
        return {"prefill": serve_mod.padding_waste_profile(eng.stats),
                "decode": det.report}
    cache_kw, _, enc_stats = serve_mod.legacy_cache_inputs(
        cfg, model, data, seed=seed, bucket_frames=bucket_frames,
        device=device)
    serve_mod._run_legacy(model, params,
                          torch.as_tensor(prompts, device=device), gen,
                          cache_kw)
    out = {"prefill": WasteProfile(tier=2), "decode": WasteProfile(tier=3)}
    if enc_stats is not None:
        out["prefill"] = serve_mod.encoder_padding_profile(enc_stats)
    return out


def _finding_row(arch: str, shape: str, f: Finding) -> Dict[str, Any]:
    return {"arch": arch, "shape": shape, "tier": f.tier, "kind": f.kind,
            "site": _site(f), "fraction": round(float(f.fraction), 6),
            "bytes": float(f.bytes), "count": int(f.count)}


def run_cells(configs: List[str], *, toy: bool = True, seed: int = 0,
              moe_dispatch: Optional[str] = None,
              bucket_frames: bool = True,
              shapes: Optional[List[str]] = None,
              verbose: bool = True, device: str = "cuda") -> Dict[str, Any]:
    """Profile every applicable (config x shape) cell; build the report."""
    dev = serve_mod.resolve_device(device)
    dims = _DIMS[toy]
    shape_list = [s for s in registry.SHAPES
                  if shapes is None or s.name in shapes]
    cells: List[Dict[str, Any]] = []
    profiles: List[WasteProfile] = []
    for arch in configs:
        cfg = registry.get_config(arch)
        # smoke-reduce for runnability; cell applicability is decided on
        # the FULL config (subquadratic-ness etc. is an arch property)
        full_cfg = cfg
        cfg = cfg.smoke()
        if moe_dispatch is not None and cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, dispatch=moe_dispatch))
        model = None
        params = None
        lint_by_subject: Dict[str, WasteProfile] = {}
        serve_cache: Dict[str, Dict[str, WasteProfile]] = {}

        def ensure_model():
            nonlocal model, params
            if model is None:
                model = build_model(cfg)
                params = model.init(seed, device=dev)
            return model, params

        def tier0(subject: str) -> WasteProfile:
            if subject not in lint_by_subject:
                (prof,) = lint_mod.lint_config(arch, smoke=True,
                                               subjects=(subject,),
                                               device=str(dev))
                lint_by_subject[subject] = prof
            return lint_by_subject[subject]

        for shape in shape_list:
            ok, why = registry.cell_applicable(full_cfg, shape)
            cell: Dict[str, Any] = {
                "arch": arch, "shape": shape.name, "kind": shape.kind,
                "applicable": ok, "reason": why, "error": None,
                "fractions": {}, "waste_bytes": 0.0, "findings": [],
            }
            if not ok:
                cells.append(cell)
                continue
            if verbose:
                print(f"[matrix] {arch} x {shape.name} ...", flush=True)
            try:
                if shape.kind == "train":
                    ensure_model()
                    profs = [tier0("train")] + _train_profiles(
                        arch, cfg, model, seed=seed, dims=dims["train"],
                        device=dev)
                elif shape.kind == "prefill":
                    ensure_model()
                    key = "serve"
                    if key not in serve_cache:
                        serve_cache[key] = _serve_profiles(
                            arch, cfg, model, params, seed=seed,
                            dims=dims["serve"],
                            bucket_frames=bucket_frames, device=dev)
                    profs = [tier0("prefill"), serve_cache[key]["prefill"]]
                else:  # decode
                    ensure_model()
                    key = "long" if shape.name == "long_500k" else "serve"
                    if key not in serve_cache:
                        serve_cache[key] = _serve_profiles(
                            arch, cfg, model, params, seed=seed,
                            dims=dims[key], bucket_frames=bucket_frames,
                            device=dev)
                    profs = [tier0("decode"), serve_cache[key]["decode"]]
                merged = merge_profiles(profs)
            except Exception as e:  # noqa: BLE001 — cell isolation
                cell["error"] = f"{type(e).__name__}: {e}"
                cells.append(cell)
                continue
            cell["fractions"] = {k: round(float(v), 6)
                                 for k, v in sorted(merged.fractions().items())}
            cell["waste_bytes"] = float(sum(f.bytes
                                            for f in merged.findings))
            cell["findings"] = sorted(
                (_finding_row(arch, shape.name, f)
                 for f in merged.findings),
                key=lambda r: (-r["fraction"], -r["bytes"], r["kind"],
                               r["tier"], r["site"]))
            profiles.append(merged)
            cells.append(cell)

    ranking = sorted(
        (row for c in cells for row in c["findings"]),
        key=lambda r: (-r["fraction"], -r["bytes"], r["arch"], r["shape"],
                       r["kind"], r["tier"], r["site"]))
    report = {
        "schema": SCHEMA, "seed": seed, "toy": toy,
        "moe_dispatch": moe_dispatch or "config-default",
        "bucket_frames": bucket_frames,
        "configs": list(configs),
        "cells": cells,
        "ranking": ranking,
    }
    merged_all = merge_profiles(profiles) if profiles else WasteProfile()
    return {"report": report, "profile": merged_all}


def leaderboard(report: Dict[str, Any], top_k: int = 15) -> str:
    lines = [
        "| # | config | shape | tier | kind | site | fraction | waste |",
        "|---|--------|-------|------|------|------|----------|-------|",
    ]
    for i, r in enumerate(report["ranking"][:top_k], 1):
        waste = (f"{r['bytes'] / 1e6:.2f} MB" if r["bytes"] >= 1e6
                 else f"{r['bytes'] / 1e3:.1f} KB" if r["bytes"] >= 1e3
                 else f"{r['bytes']:.0f} B")
        lines.append(f"| {i} | {r['arch']} | {r['shape']} | {r['tier']} | "
                     f"{r['kind']} | {r['site']} | {r['fraction']:.3f} | "
                     f"{waste} |")
    if not report["ranking"]:
        lines.append("| - | (no findings) | | | | | | |")
    return "\n".join(lines)


def _gate_failures(report: Dict[str, Any],
                   max_moe_dead: Optional[float]) -> List[str]:
    fails = []
    for c in report["cells"]:
        if c["applicable"] and c["error"]:
            fails.append(f"{c['arch']} x {c['shape']}: {c['error']}")
    if max_moe_dead is not None:
        for c in report["cells"]:
            frac = c["fractions"].get("dead_expert_store")
            if frac is not None and frac > max_moe_dead:
                fails.append(
                    f"{c['arch']} x {c['shape']}: dead_expert_store "
                    f"fraction {frac} > {max_moe_dead} (MoE dispatch "
                    f"regression — scatter mode stores no dead rows)")
    return fails


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Zoo-wide waste matrix: profile every registry "
                    "config cell and rank by redundancy fraction")
    ap.add_argument("--toy", action="store_true",
                    help="CI-sized cell dims (smoke configs either way)")
    ap.add_argument("--configs", default=None,
                    help="comma list of arch ids (default: whole registry)")
    ap.add_argument("--shapes", default=None,
                    help="comma list of shape names (default: all four)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="matrix_report.json",
                    help="machine-readable matrix report")
    ap.add_argument("--sarif-out", default=None,
                    help="merged findings as SARIF 2.1.0")
    ap.add_argument("--leaderboard-out", default=None,
                    help="write the markdown leaderboard to a file")
    ap.add_argument("--moe-dispatch", default=None,
                    choices=("scatter", "einsum"),
                    help="override MoE dispatch for before/after cells "
                         "(default: config default = scatter)")
    ap.add_argument("--bucket-frames", default="on", choices=("on", "off"),
                    help="audio serving: bucketed encoder extent (the "
                         "fix) vs capacity padding (the baseline)")
    ap.add_argument("--max-moe-dead-expert-fraction", type=float,
                    default=None,
                    help="fail if any cell's dead_expert_store fraction "
                         "exceeds this (CI regression gate; post-fix "
                         "value is 0.0)")
    ap.add_argument("--top-k", type=int, default=15)
    ap.add_argument("--device", default="cuda",
                    help="torch device the cells run on (default: cuda)")
    a = ap.parse_args(argv)

    configs = ([s for s in a.configs.split(",") if s] if a.configs
               else list(registry.ARCH_IDS))
    for arch in configs:
        if arch not in registry.ARCH_IDS:
            ap.error(f"unknown config {arch!r}")

    shapes = [s for s in a.shapes.split(",") if s] if a.shapes else None
    if shapes:
        known = {s.name for s in registry.SHAPES}
        for s in shapes:
            if s not in known:
                ap.error(f"unknown shape {s!r} (known: {sorted(known)})")
    res = run_cells(configs, toy=a.toy, seed=a.seed,
                    moe_dispatch=a.moe_dispatch,
                    bucket_frames=a.bucket_frames == "on",
                    shapes=shapes, device=a.device)
    report = res["report"]

    with open(a.out, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)
        fh.write("\n")
    print(f"[matrix] report written to {a.out}")
    if a.sarif_out:
        write_sarif(res["profile"], a.sarif_out, src_root=os.getcwd())
        print(f"[matrix] SARIF written to {a.sarif_out}")

    ran = sum(1 for c in report["cells"]
              if c["applicable"] and not c["error"])
    skipped = sum(1 for c in report["cells"] if not c["applicable"])
    errored = sum(1 for c in report["cells"]
                  if c["applicable"] and c["error"])
    print(f"[matrix] {len(report['cells'])} cells: {ran} profiled, "
          f"{skipped} skipped (inapplicable), {errored} errored")
    board = leaderboard(report, a.top_k)
    print(board)
    if a.leaderboard_out:
        with open(a.leaderboard_out, "w") as fh:
            fh.write(f"# Zoo waste matrix leaderboard\n\n{board}\n")
        print(f"[matrix] leaderboard written to {a.leaderboard_out}")

    fails = _gate_failures(report, a.max_moe_dead_expert_fraction)
    for msg in fails:
        print(f"[matrix] FAIL: {msg}", file=sys.stderr)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
