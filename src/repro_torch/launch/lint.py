"""Static waste lint driver: tier-0 graph analysis over the model zoo
(port of src/repro/launch/lint.py).

Traces the train step, the decode step or engine tick, and the prefill of
each config in ``configs/registry.py`` ABSTRACTLY — fake tensors in
(``LM.abstract_params``, ``train/state.py:abstract``, an ``init_cache``
made under the same fake-tensor mode), graph out: no parameter
allocation, no kernel build, no launch — and runs ``core/graph_lint.py``
over the graphs. Findings merge into one tier-0 :class:`WasteProfile`
and export as SARIF for CI annotation.

    # fail only on NEW findings against the committed waiver baseline
    python -m repro_torch.launch.lint --all-configs --full-size \\
        --baseline lint_baseline_torch.json --sarif-out lint.sarif

    # intentionally accept the current findings (reviewed!)
    python -m repro_torch.launch.lint --all-configs --full-size \\
        --baseline lint_baseline_torch.json --update-baseline

The fake tensors live on ``--device`` (default cuda; ``--device cpu``
on a machine without one, where fake CUDA tensors cannot be indexed).
A waiver entry records the finding's stable fingerprint (sha over the
§5.6 key kind|tier|C1|C2 — contexts use file BASENAMES, so baselines
are machine-portable) plus human-readable provenance and a note field
for the review rationale. ``lint_baseline_torch.json`` is the port's;
the reference's ``lint_baseline.json`` waives the JAX package's jaxprs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.core.findings import WasteProfile, merge_profiles
from repro_torch.core.graph_lint import lint_fn
from repro_torch.core.graph_trace import abstract_mode
from repro_torch.core.report import dump_json
from repro_torch.core.sarif import finding_fingerprint, write_sarif
from repro_torch.launch.serve import resolve_device
from repro_torch.models.zoo import build_model
from repro_torch.serve.decode import (make_engine_prefill, make_engine_tick,
                                      make_serve_step)
from repro_torch.serve.engine import ENGINE_FAMILIES
from repro_torch.train import state as TS
from repro_torch.train.step import make_train_step

BASELINE_VERSION = 1


def _fake(mode, shape, dtype, device) -> torch.Tensor:
    with mode:
        return torch.empty(tuple(shape), dtype=dtype, device=device)


def _train_batch(cfg, batch: int, seq: int, *, mode,
                 device) -> Dict[str, Any]:
    """Abstract batch matching data/synthetic.batch_at's leaves."""
    out = {"tokens": _fake(mode, (batch, seq), torch.int32, device),
           "labels": _fake(mode, (batch, seq), torch.int32, device)}
    if cfg.family == "vlm":
        out["img"] = _fake(mode, (batch, cfg.num_image_tokens, cfg.d_model),
                           torch.float32, device)
    if cfg.family == "audio":
        out["frames"] = _fake(mode, (batch, min(seq, cfg.encoder_frames),
                                     cfg.d_model), torch.float32, device)
    return out


def _abstract_cache(model, params, batch: int, max_len: int, *, mode,
                    device):
    """Decode cache of fake tensors (``init_cache`` under the fake-tensor
    mode; the cross-K/V families get fake image tokens or frames, whose
    encoder runs as fake kernel nodes)."""
    cfg = model.cfg
    kw: Dict[str, Any] = {}
    if cfg.family == "vlm":
        kw["img"] = _fake(mode, (batch, cfg.num_image_tokens, cfg.d_model),
                          torch.float32, device)
    if cfg.family == "audio":
        kw["frames"] = _fake(mode, (batch, cfg.encoder_frames, cfg.d_model),
                             torch.float32, device)
    with mode:
        return model.init_cache(params, batch, max_len, **kw)


def lint_config(arch: str, *, smoke: bool = True, batch: int = 2,
                seq: int = 32, max_len: int = 48,
                subjects: Tuple[str, ...] = ("train", "decode", "prefill"),
                device: str = "cuda",
                verbose: bool = False) -> List[WasteProfile]:
    """Lint one zoo config's step functions; one profile per subject
    (``meta``: ``trace_s``, ``nodes``)."""
    dev = torch.device(device)
    cfg = registry.get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    model = build_model(cfg)
    mode = abstract_mode()
    profiles: List[WasteProfile] = []

    def note(msg):
        if verbose:
            print(f"[lint]   {msg}", flush=True)

    def i32(*shape):
        return _fake(mode, shape, torch.int32, dev)

    def flags(*shape):
        return _fake(mode, shape, torch.bool, dev)

    if "train" in subjects:
        tc = TrainConfig(learning_rate=1e-3, total_steps=10, warmup_steps=1)
        step_fn = make_train_step(model, tc)
        state = TS.abstract(model, device=dev, mode=mode)
        profiles.append(lint_fn(step_fn, state,
                                _train_batch(cfg, batch, seq, mode=mode,
                                             device=dev),
                                subject=f"{arch}:train_step"))
        note(f"train_step: {len(profiles[-1].findings)} findings")

    params = model.abstract_params(device=dev, mode=mode)
    # decode subjects get the decode-path param view: encoder/cross-KV
    # leaves only feed init_cache, and as decode inputs they'd lint as
    # dead_param (they ARE dead there — the fix is to not pass them)
    dparams = model.decode_params(params)
    engine = cfg.family in ENGINE_FAMILIES

    if "decode" in subjects:
        cache = _abstract_cache(model, params, batch, max_len, mode=mode,
                                device=dev)
        if engine:
            prof = lint_fn(make_engine_tick(model), dparams, cache,
                           i32(batch, 1), flags(batch),
                           subject=f"{arch}:engine_tick")
        else:
            prof = lint_fn(make_serve_step(model), dparams, cache,
                           i32(batch, 1), subject=f"{arch}:decode_step")
        profiles.append(prof)
        note(f"decode: {len(prof.findings)} findings")

    if "prefill" in subjects:
        P = min(16, max_len - 1)
        cache = _abstract_cache(model, params, batch, max_len, mode=mode,
                                device=dev)
        if engine:
            prof = lint_fn(make_engine_prefill(model), dparams, cache,
                           i32(batch, P), flags(batch), i32(batch),
                           i32(batch), i32(batch, 1),
                           subject=f"{arch}:engine_prefill")
        else:
            def prefill(p, c, t):
                with torch.no_grad():
                    return model.prefill(p, c, t)
            prof = lint_fn(prefill, dparams, cache, i32(batch, P),
                           subject=f"{arch}:prefill")
        profiles.append(prof)
        note(f"prefill: {len(prof.findings)} findings")
    return profiles


# ---------------------------------------------------------------------
# waiver baseline
# ---------------------------------------------------------------------
def load_baseline(path: str) -> Dict[str, Dict[str, Any]]:
    """fingerprint -> waiver entry. Missing file = empty baseline."""
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        doc = json.load(fh)
    return {w["fingerprint"]: w for w in doc.get("waivers", [])}


def baseline_doc(profile: WasteProfile) -> Dict[str, Any]:
    waivers = []
    for f in sorted(profile.findings,
                    key=lambda f: (f.kind, f.tier, f.c1, f.c2)):
        waivers.append({
            "fingerprint": finding_fingerprint(f),
            "kind": f.kind,
            "tier": f.tier,
            "subject": f.meta.get("subject", ""),
            "c1": list(f.c1),
            "c2": list(f.c2),
            "bytes": f.bytes,
            "note": f.meta.get("rule", ""),
        })
    return {"version": BASELINE_VERSION, "waivers": waivers}


def split_new(profile: WasteProfile, waived: Dict[str, Dict[str, Any]]):
    """Partition findings into (new, waived-hit) by stable fingerprint."""
    new, hit = [], []
    for f in profile.findings:
        (hit if finding_fingerprint(f) in waived else new).append(f)
    return new, hit


# ---------------------------------------------------------------------
def run(archs: List[str], *, smoke: bool = True,
        subjects: Tuple[str, ...] = ("train", "decode", "prefill"),
        sarif_out: Optional[str] = None,
        profile_out: Optional[str] = None,
        baseline: Optional[str] = None,
        update_baseline: bool = False,
        device: str = "cuda",
        verbose: bool = False) -> Tuple[WasteProfile, int]:
    """Lint archs; returns (merged tier-0 profile, exit code). Each
    config's line gives its trace seconds, nodes and findings."""
    dev = resolve_device(device)
    profiles: List[WasteProfile] = []
    for arch in archs:
        t0 = time.perf_counter()
        try:
            profs = lint_config(arch, smoke=smoke, subjects=subjects,
                                device=str(dev), verbose=verbose)
        except Exception as e:                      # pragma: no cover
            print(f"[lint] {arch} FAILED to trace: {e!r}", file=sys.stderr)
            raise
        profiles.extend(profs)
        print(f"[lint] {arch}: {time.perf_counter() - t0:.2f} s, "
              f"{sum(p.meta.get('nodes', 0) for p in profs)} nodes "
              f"(trace {sum(p.meta.get('trace_s', 0.0) for p in profs):.2f}"
              f" s), {sum(len(p.findings) for p in profs)} findings",
              flush=True)
    merged = merge_profiles(profiles)
    merged.meta["subjects"] = ",".join(subjects)

    print(f"[lint] {len(archs)} configs, {len(merged.findings)} findings, "
          f"fractions {merged.fractions()}")
    for f in merged.top(20):
        where = (f"{os.path.basename(str(f.meta.get('file', '?')))}:"
                 f"{f.meta.get('line', 0)}" if "file" in f.meta
                 else f.meta.get("path", "-"))
        print(f"  {f.kind:16s} {f.bytes / 1e3:10.1f} KB x{f.count:<4d} "
              f"{f.meta.get('subject', '?'):40s} {where}")

    if sarif_out:
        write_sarif(merged, sarif_out, src_root=os.getcwd())
        print(f"[lint] SARIF written to {sarif_out}")
    if profile_out:
        dump_json(merged, profile_out)
        print(f"[lint] waste profile written to {profile_out}")

    code = 0
    if baseline and update_baseline:
        with open(baseline, "w") as fh:
            json.dump(baseline_doc(merged), fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"[lint] baseline updated: {baseline} "
              f"({len(merged.findings)} waivers)")
    elif baseline:
        waived = load_baseline(baseline)
        new, hit = split_new(merged, waived)
        print(f"[lint] baseline {baseline}: {len(hit)} waived, "
              f"{len(new)} NEW")
        if new:
            print("[lint] new findings (fail):")
            for f in sorted(new, key=lambda f: -f.bytes):
                print(f"  {finding_fingerprint(f)[:12]} {f.kind:16s} "
                      f"{f.meta.get('subject', '?')} :: "
                      f"{f.meta.get('rule', f.meta.get('path', ''))}")
            code = 1
    return merged, code


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Tier-0 static graph waste lint over the model zoo")
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--config", choices=registry.ARCH_IDS,
                   help="lint one zoo config")
    g.add_argument("--all-configs", action="store_true",
                   help="lint every config in the registry")
    ap.add_argument("--full-size", action="store_true",
                    help="lint at full config size (default: .smoke())")
    ap.add_argument("--subjects", default="train,decode,prefill",
                    help="comma list from {train,decode,prefill}")
    ap.add_argument("--sarif-out", default=None,
                    help="write findings as SARIF 2.1.0")
    ap.add_argument("--profile-out", default=None,
                    help="write the tier-0 WasteProfile as JSON")
    ap.add_argument("--baseline", default=None,
                    help="waiver baseline JSON; NEW findings exit 1")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite --baseline from current findings")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (default: cuda)")
    ap.add_argument("-v", "--verbose", action="store_true")
    a = ap.parse_args(argv)
    archs = registry.ARCH_IDS if a.all_configs else [a.config]
    subjects = tuple(s for s in a.subjects.split(",") if s)
    _, code = run(archs, smoke=not a.full_size, subjects=subjects,
                  sarif_out=a.sarif_out, profile_out=a.profile_out,
                  baseline=a.baseline, update_baseline=a.update_baseline,
                  device=a.device, verbose=a.verbose)
    return code


if __name__ == "__main__":
    sys.exit(main())
