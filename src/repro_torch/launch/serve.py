"""Serving driver: the continuous-batching engine with batched prefill,
KV-cache waste detectors and prefill-vs-decode accounting, on the card.

    python -m repro_torch.launch.serve --arch qwen3-1.7b --kv paged --profile

runs qwen3-1.7b at its published width from random weights (seeded) on
the CUDA device; ``--arch granite-moe-3b-a800m`` serves the MoE family
the same way. The vlm, hybrid, ssm and audio families (``--arch
llama-3.2-vision-90b``, ``zamba2-1.2b``, ``xlstm-1.3b``,
``whisper-large-v3``) have no indexed KV cache in every block, so they
are served by the token-loop driver (``_run_legacy``: one greedy
one-token step at a time over a dense f32 cache, the prompt pushed token
by token), as the reference serves every family outside the engine. The
vlm family's image tokens (seeded stubbed patch embeddings) go into the
run's ``init_cache`` and tier 1's, whose cross K/V they fill once. The
audio family's encoder runs once, in ``init_cache``,
over the seeded frames right-padded to the power-of-two bucket of the
batch's longest true length (``--bucket-frames on``, the default) or to
the frames' full extent (``off``); its padding is accounted as the
reference accounts it (``encoder_padding_profile``). ``--device cpu``
runs on the CPU (with ``--smoke``, the reduced config). Without CUDA and
without ``--device cpu`` it raises.

``--kv paged`` switches the engine to the block-paged KV heap
(serve/kv_cache.py): refcounted pages + copy-on-write prefix reuse,
eliminating the waste the detectors flag in dense mode. ``--profile``
merges the tier-3 serving detectors, the tier-4 in-kernel store
counters (paged layout), the prefill padding accounting, tier 2 (the
waste analysis of an abstract trace of one decode tick, or of the token
loop's decode step: ``core/graph_waste.py``) and tier 1 (the
concrete-run recorder, trace→replay, period 5000, 2 epochs) on one
single-token decode microstep over a dense f32 cache into one
``WasteProfile``, as the reference does. A ``[serve] tier 2`` line gives
the trace's nodes, its kernel nodes and seconds.

``--spec on`` adds speculative decoding (serve/spec.py): a host-side
drafter proposes up to ``--spec-k`` tokens per tick and ONE width-(k+1)
verify forward accepts the greedy-consistent prefix, so the outputs are
plain greedy decode's while live slots emit up to k+1 tokens a tick.
Rejected drafts are Def.-1 dead KV stores, measured at the
``rejected_draft_store`` site and, in the paged layout, eliminated by
``--spec-rollback on`` (only the accepted prefix is stored). ``--draft
oracle`` runs a plain pass first, replays its continuations (accept rate
1.0) and asserts that the speculative outputs equal it.

``--objects`` registers the parameter tree (``serve/params``) and the
measured engine's KV pages and draft window in an object registry
(core/objects.py), runs the replica scan (core/replicas.py) after
serving, prints the ``[serve] object scan:`` line and the top objects,
and merges the scan into the ``--profile`` report.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ProfilerConfig
from repro_torch.core.detectors import ServingDetectors
from repro_torch.core.findings import Finding, WasteProfile, merge_profiles
from repro_torch.core.graph_trace import abstract_mode, trace_step
from repro_torch.core.graph_waste import analyze_waste
from repro_torch.core.interpreter import JxInterpreter
from repro_torch.core.objects import ObjectRegistry, register_tree
from repro_torch.core.replicas import ReplicaDetector
from repro_torch.core.report import dump_json
from repro_torch.core.sarif import write_sarif
from repro_torch.data.synthetic import batch_at, frame_lengths
from repro_torch.models.params import tree_map
from repro_torch.models.zoo import build_model
from repro_torch.serve.decode import make_serve_step
from repro_torch.serve.engine import ENGINE_FAMILIES, Request, ServeEngine
from repro_torch.serve.spec import make_drafter

# families served by the token-loop driver (every family outside the
# engine's)
LEGACY_FAMILIES = ("vlm", "hybrid", "ssm", "audio")


def padding_waste_profile(stats) -> WasteProfile:
    """Padding-waste finding from the engine's accounting: `_bucket`'s
    power-of-two prompt padding burns prefill compute on garbage
    positions (checked = all prefill positions swept, flagged = the
    padded ones)."""
    prof = WasteProfile(tier=2)
    padded = int(stats.get("padded_prefill_tokens", 0))
    useful = int(stats.get("prefill_computed_tokens", 0))
    prof.checked["prefill_padding"] = padded + useful
    prof.flagged["prefill_padding"] = padded
    if padded:
        prof.add(Finding(
            kind="prefill_padding", tier=2,
            c1=("serve.engine:_bucket",), c2=("serve.engine:prefill",),
            count=int(stats.get("prefills", 0)),
            fraction=padded / max(padded + useful, 1),
            meta={"padded_tokens": padded, "computed_tokens": useful}))
    return prof


def _bucket_pow2(n: int, cap: int, lo: int = 8) -> int:
    """Smallest power of two >= n (the engine's ``_bucket`` policy),
    capped."""
    b = lo
    while b < n:
        b *= 2
    return min(b, cap)


def encoder_padding_profile(stats) -> WasteProfile:
    """Padding-waste finding of encoder-decoder serving: frames padded to
    the run extent burn encoder compute and cross-K/V bytes on garbage
    rows (checked = all frame rows swept, flagged = the padded ones).
    Bucketing the extent (``--bucket-frames``) is the fix this finding's
    bytes measure."""
    prof = WasteProfile(tier=2)
    padded = int(stats.get("padded_frames", 0))
    true = int(stats.get("true_frames", 0))
    prof.checked["prefill_padding"] = padded + true
    prof.flagged["prefill_padding"] = padded
    if padded:
        prof.add(Finding(
            kind="prefill_padding", tier=2,
            c1=("launch.serve:_run_legacy",), c2=("models.lm:encode",),
            count=1, bytes=float(stats.get("padded_bytes", 0)),
            fraction=padded / max(padded + true, 1),
            meta={"padded_frames": padded, "true_frames": true,
                  "frames_run": int(stats.get("frames_run", 0)),
                  "frames_capacity": int(stats.get("frames_capacity", 0))}))
    return prof


def _prep_frames(cfg, model, frames, lengths, bucket_frames: bool):
    """Right-pad audio frames to the run extent and account the padding.

    ``frames`` (B, cap, d) and ``lengths`` (B,) on the host. The extent is
    the frames' full extent ``cap``, or with ``bucket_frames`` the
    power-of-two bucket of the batch's longest true length. Rows past
    each true length are zeroed (and masked by the encoder and the cross
    attention), so greedy outputs are the same either way; only the
    padded bytes differ. Returns (frames (B, extent, d), lengths clipped
    to cap, stats)."""
    frames = np.asarray(frames)
    B, cap = frames.shape[:2]
    lens = np.minimum(np.asarray(lengths, np.int32), cap)
    F_run = _bucket_pow2(int(lens.max()), cap) if bucket_frames else cap
    mask = np.arange(cap)[None, :] < lens[:, None]
    frames = np.where(mask[..., None], frames, np.float32(0.0))[:, :F_run]
    true = int(lens.sum())
    padded = B * F_run - true
    itemsize = 4                  # float32 frames and cross K/V
    # a padded frame row costs its embedding row and the per-layer cross
    # K/V rows computed from it
    row = cfg.d_model * itemsize
    kv_row = model.sched.n_super * 2 * cfg.num_kv_heads * cfg.head_dim \
        * itemsize
    stats = {"frames_capacity": cap, "frames_run": F_run,
             "true_frames": true, "padded_frames": padded,
             "padded_bytes": padded * (row + kv_row)}
    return frames, lens, stats


def frame_inputs(cfg, model, frames, *, seed: int, bucket_frames: bool,
                 device):
    """The audio family's cache arguments for a token-loop run over the
    seeded ``frames`` (B, cap, d): the run's (the frames right-padded to
    the run extent with their seeded lengths, ``_prep_frames``), tier
    1's (the frames as drawn, unmasked, as the reference driver builds
    its tier-1 cache), and the encoder-frames stats."""
    padded, lens, stats = _prep_frames(
        cfg, model, frames, frame_lengths(cfg, len(frames), seed=seed),
        bucket_frames)
    return ({"frames": torch.as_tensor(padded, device=device),
             "frame_lengths": torch.as_tensor(lens, device=device)},
            {"frames": torch.as_tensor(np.asarray(frames), device=device)},
            stats)


def legacy_cache_inputs(cfg, model, data, *, seed: int, bucket_frames: bool,
                        device):
    """The token-loop driver's cache arguments for ``data`` (a
    ``batch_at`` batch): ``(cache_kw, tier1_kw, enc_stats)``, the run's
    and tier 1's ``init_cache`` arguments and the audio family's
    encoder-frames stats (``frame_inputs``). The vlm family's image
    tokens go to both caches as drawn; the other families take none."""
    if cfg.family == "audio":
        return frame_inputs(cfg, model, data["frames"], seed=seed,
                            bucket_frames=bucket_frames, device=device)
    if cfg.family == "vlm":
        kw = {"img": torch.as_tensor(np.asarray(data["img"]), device=device)}
        return kw, kw, None
    return None, None, None


def tier1_decode_subject(model, params, batch: int, max_len: int,
                         cache_kw=None):
    """Tier 1's serving subject, the reference driver's: the greedy next
    token of one cached forward of (batch, 1) tokens over a fresh dense
    f32 cache of `max_len` positions (built with ``cache_kw``: the audio
    family's frames, the vlm family's image tokens)."""
    cache1 = model.init_cache(params, batch, max_len, kv_dtype=torch.float32,
                              **(cache_kw or {}))
    dparams = model.decode_params(params)

    @torch.no_grad()
    def decode(tok):
        logits, _ = model.decode_step(dparams, cache1, tok)
        return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    return decode


def tier1_decode_profile(model, params, tokens: torch.Tensor, max_len: int,
                         seed: int, cache_kw=None):
    """Tier 1 on the decode microstep (``tier1_decode_subject``) of
    `tokens`, as the reference's serving driver runs it: period 5000, 2
    epochs (the second replays the first's trace). Returns ``(profile,
    interpreter)``; the interpreter's ``stats`` hold the recording's
    counts and times."""
    interp = JxInterpreter(ProfilerConfig(enabled=True, period=5000,
                                          seed=seed))
    decode = tier1_decode_subject(model, params, tokens.shape[0], max_len,
                                  cache_kw)
    return interp.profile(decode, tokens, epochs=2), interp


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run_legacy(model, params, prompts: torch.Tensor, gen: int,
                cache_kw=None):
    """Token-loop driver for families without an indexed KV cache: the
    prompt pushed through the greedy one-token step token by token, then
    ``gen - 1`` more greedy steps, over a dense f32 cache (built with
    ``cache_kw``: the audio family's frames and frame lengths, whose
    encoder runs in ``init_cache``, outside the timed loops, or the vlm
    family's image tokens, whose cross K/V it fills there). Returns
    ``(tokens (B, gen) int32, stats)``: prefill and decode tok/s (the
    reference's definition: prompt tokens over the prompt loop's time,
    generated tokens over the decode loop's), each timed span ending in
    a device synchronization, and the steps taken."""
    batch, prompt_len = prompts.shape
    dev = prompts.device
    cache = model.init_cache(params, batch, prompt_len + gen + 1,
                             kv_dtype=torch.float32, **(cache_kw or {}))
    params = model.decode_params(params)
    serve_step = make_serve_step(model)

    _sync(dev)
    t0 = time.perf_counter()
    for t in range(prompt_len):
        nxt, cache = serve_step(params, cache, prompts[:, t:t + 1])
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    generated = [nxt]
    for _ in range(gen - 1):
        nxt, cache = serve_step(params, cache, generated[-1])
        generated.append(nxt)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    out = torch.cat(generated, dim=1).cpu().numpy()
    return out, {"prefill_tok_s": batch * prompt_len / max(t_prefill, 1e-9),
                 "decode_tok_s": batch * gen / max(t_decode, 1e-9),
                 "steps": prompt_len + gen - 1}


def resolve_device(device: str) -> torch.device:
    """The device to serve on; CUDA must be present unless the caller
    asked for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "run on the CPU")
    return dev


def run(arch: str, *, smoke: bool = False, batch: int = 4,
        prompt_len: int = 32, gen: int = 16, seed: int = 0,
        profile: bool = False, profile_out: Optional[str] = None,
        sarif_out: Optional[str] = None, kv: str = "dense",
        page_size: int = 16, spec: bool = False, spec_k: int = 4,
        draft: str = "ngram", spec_rollback: bool = True,
        bucket_frames: bool = True, objects: bool = False,
        device: str = "cuda"):
    """Serve `batch` seeded synthetic prompts through the engine (or,
    for the vlm, hybrid, ssm and audio families, the token-loop driver).

    Returns ``(tokens, merged profile or None, stats)``: the greedy
    continuations (batch, gen) int32 on the host, the merged waste
    profile when ``profile``, and the engine's counters with its
    prefill/decode (and, with ``spec``, draft/verify) throughput (the
    token loop's: its throughput and the steps it took, and for the
    audio family the encoder-frames stats of ``_prep_frames``)."""
    dev = resolve_device(device)
    cfg = registry.get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    model = build_model(cfg)
    params = model.init(seed, device=dev)
    obj_registry = None
    if objects:
        obj_registry = ObjectRegistry()
        register_tree(obj_registry, "serve/params", params)
    data = batch_at(cfg, batch, prompt_len, seed=seed, step=0)
    prompts = data["tokens"]
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    if cfg.family in LEGACY_FAMILIES:
        if kv != "dense":
            raise ValueError(f"--kv paged needs the engine families "
                             f"{ENGINE_FAMILIES}, not {cfg.family!r}")
        if spec:
            raise ValueError(f"--spec needs the engine families "
                             f"{ENGINE_FAMILIES}, not {cfg.family!r}")
        cache_kw, tier1_kw, enc_stats = legacy_cache_inputs(
            cfg, model, data, seed=seed, bucket_frames=bucket_frames,
            device=dev)
        out, stats = _run_legacy(
            model, params, torch.as_tensor(np.asarray(prompts), device=dev),
            gen, cache_kw)
        if enc_stats is not None:
            stats.update(enc_stats)
            print(f"[serve] encoder frames: extent {enc_stats['frames_run']}"
                  f"/{enc_stats['frames_capacity']} "
                  f"({'bucketed' if bucket_frames else 'capacity'}), "
                  f"{enc_stats['true_frames']} true + "
                  f"{enc_stats['padded_frames']} padded rows "
                  f"({enc_stats['padded_bytes']} padded bytes)")
        print(f"[serve] {arch}: {batch} seqs, prompt {prompt_len} + gen "
              f"{gen} [kv={kv}, token loop, {name}] | prefill "
              f"{stats['prefill_tok_s']:.0f} tok/s, decode "
              f"{stats['decode_tok_s']:.0f} tok/s (live slots)")
        print("[serve] sample continuation:", out[0][:12])
        obj_scan = _object_scan(obj_registry)
        merged = None
        if profile:
            tier1 = _tier1(model, params, out, prompt_len + gen + 1, seed,
                           dev, stats, tier1_kw)
            tier2 = _tier2("decode step", legacy_tier2_subject(
                model, params, batch, prompt_len + gen + 1, cache_kw), stats)
            profs = [tier1, tier2] + ([encoder_padding_profile(enc_stats)]
                               if enc_stats is not None else [])
            if obj_scan is not None:
                profs.append(obj_scan)
            merged = _finish_profile(profs, profile_out, sarif_out)
        return out, merged, stats

    def build_and_run(drafter, det, reg=None):
        eng = ServeEngine(model, params, num_slots=batch,
                          max_len=prompt_len + gen + 1, detectors=det,
                          kv_dtype=torch.float32, kv_layout=kv,
                          page_size=page_size, drafter=drafter,
                          spec_k=spec_k, spec_rollback=spec_rollback,
                          kernel_counters=det is not None and kv == "paged",
                          registry=reg, owner="serve")
        for b in range(batch):
            eng.submit(Request(rid=f"r{b}", tokens=np.asarray(prompts[b]),
                               max_new_tokens=gen))
        eng.run()
        return eng, np.stack(
            [np.asarray(eng.finished[f"r{b}"].generated[:gen], np.int32)
             for b in range(batch)])

    drafter = None
    plain_out = None
    if spec:
        if draft == "oracle":
            # harvest the plain greedy continuations first; the replay
            # drafter proposes exactly them (accept rate 1.0), and the
            # speculative run must reproduce them
            _, plain_out = build_and_run(None, None)
            drafter = make_drafter("oracle", sequences=[
                np.concatenate([np.asarray(prompts[b]), plain_out[b]])
                for b in range(batch)])
        else:
            drafter = make_drafter(draft, model=model, params=params)
    det = ServingDetectors(ProfilerConfig(enabled=True, seed=seed)) \
        if profile else None
    # only the measured engine registers objects: the oracle's plain
    # pre-pass would otherwise leave a dead engine's pages in the scan
    eng, out = build_and_run(drafter, det, obj_registry)
    if plain_out is not None and not np.array_equal(out, plain_out):
        diff = out != plain_out
        first = np.where(diff.any(axis=1), diff.argmax(axis=1), gen)
        b = int(first.argmin())
        raise AssertionError(
            f"speculative outputs diverged from plain greedy decode: "
            f"first at generated token {int(first[b])} of slot {b} "
            f"({int(diff.any(axis=1).sum())} of {batch} slots differ; "
            f"first diverging token per slot {first.tolist()}, {gen} = "
            f"none)")
    tp = eng.throughput()
    stats = {**eng.stats, **tp}

    # prompt tokens are NOT generated tokens: report the two rates apart
    print(f"[serve] {arch}: {batch} seqs, prompt {prompt_len} + gen {gen} "
          f"[kv={kv}, {name}] | prefill {tp['prefill_tok_s']:.0f} tok/s, "
          f"decode {tp['decode_tok_s']:.0f} tok/s (live slots)")
    print(f"[serve] prefix hits: {stats['prefix_hits']} "
          f"({stats['prefix_hit_tokens']} tokens served from cache), "
          f"computed {stats['prefill_computed_tokens']} of "
          f"{stats['prefill_tokens']} prompt tokens, "
          f"padded waste {stats['padded_prefill_tokens']} tokens, "
          f"pages freed {stats['pages_freed']}")
    if spec:
        mode = "rollback" if eng.spec_rollback else "overwrite"
        print(f"[serve] spec[{draft},{mode}]: accepted drafts: "
              f"{stats['draft_accepted']} of {stats['draft_proposed']} "
              f"proposed (accept rate {tp['accept_rate']:.2f}) | "
              f"draft {tp['draft_tok_s']:.0f} tok/s, "
              f"verify {tp['verify_tok_s']:.0f} tok/s over "
              f"{stats['spec_ticks']} verify ticks")
    print("[serve] sample continuation:", out[0][:12])
    obj_scan = _object_scan(obj_registry)

    merged = None
    if profile:
        tier1 = _tier1(model, params, out, prompt_len + gen + 1, seed, dev,
                       stats)
        tier2 = _tier2("decode tick", eng.traced_tick(), stats)
        merged = _finish_profile([tier1, tier2, det.combined(),
                                  padding_waste_profile(stats)]
                                 + ([obj_scan] if obj_scan is not None
                                    else []),
                                 profile_out, sarif_out)
    return out, merged, stats


def _object_scan(obj_registry) -> Optional[WasteProfile]:
    """The replica scan of the run's live objects (``--objects``); None
    without a registry."""
    if obj_registry is None:
        return None
    scan = ReplicaDetector(obj_registry).scan()
    print(f"[serve] object scan: {len(obj_registry)} live objects, "
          f"{len(scan.findings)} replica groups, "
          f"{sum(f.bytes for f in scan.findings):.0f} duplicate bytes")
    print(scan.render(top_k=5, by="object"))
    return scan


def legacy_tier2_subject(model, params, batch: int, max_len: int,
                         cache_kw=None):
    """Abstract trace of the token loop's decode step (the reference
    lowers the jitted step at its last cache): ``make_serve_step`` over
    a dense f32 cache of `max_len` positions made under a fake-tensor
    mode from ``params`` and ``cache_kw`` (no storage; the audio
    family's encoder runs as fake kernel nodes)."""
    mode = abstract_mode()
    fake = tree_map(mode.from_tensor, params)
    kw = {k: mode.from_tensor(v) for k, v in (cache_kw or {}).items()}
    dev = params["embed"].device
    with mode:
        cache = model.init_cache(fake, batch, max_len,
                                 kv_dtype=torch.float32, **kw)
        tokens = torch.empty((batch, 1), dtype=torch.int32, device=dev)
    return trace_step(make_serve_step(model), model.decode_params(fake),
                      cache, tokens)


def _tier2(what: str, traced, stats) -> WasteProfile:
    """Tier 2 of an abstract trace; its nodes, kernel nodes and seconds
    go into ``stats``."""
    t0 = time.perf_counter()
    rep = analyze_waste(traced)
    kernels = dict(sorted(traced.kernel_nodes().items()))
    stats["tier2_trace_s"] = traced.seconds
    stats["tier2_s"] = traced.seconds + time.perf_counter() - t0
    stats["tier2_nodes"] = traced.nodes
    stats["tier2_kernel_nodes"] = kernels
    print(f"[serve] tier 2 ({what}): {traced.nodes} nodes, kernel nodes "
          f"{kernels}; traced in {traced.seconds:.2f} s, "
          f"{stats['tier2_s']:.2f} s in all; "
          f"{len(rep.profile.findings)} findings")
    print(rep.summary())
    return rep.profile


def _tier1(model, params, out, max_len: int, seed: int, dev, stats,
           cache_kw=None):
    """Tier 1 on the decode microstep of the run's last tokens; its
    seconds go into ``stats``."""
    t0 = time.perf_counter()
    tier1, interp = tier1_decode_profile(
        model, params, torch.as_tensor(out[:, -1:], device=dev), max_len,
        seed, cache_kw)
    ts = interp.stats
    stats["tier1_s"] = time.perf_counter() - t0
    stats["tier1_record_s"] = ts["record_s"]
    stats["tier1_epoch_s"] = ts["epoch_s"]
    print(f"[serve] tier 1 (decode microstep): {ts['ops']} ops "
          f"({ts['kernel_ops']} kernel), {ts['events']} events, "
          f"{ts['element_events']:,} element-events, "
          f"{ts['snapshot_bytes']:,} bytes snapshotted; recording "
          f"{ts['record_s']:.2f} s, epochs "
          + " / ".join(f"{t:.2f}" for t in ts["epoch_s"])
          + f" s, {stats['tier1_s']:.2f} s in all")
    return tier1


def _finish_profile(profiles, profile_out, sarif_out) -> WasteProfile:
    """Merge, print and write the serving profile."""
    merged = merge_profiles(profiles)
    print(merged.render(top_k=3))
    if profile_out:
        dump_json(merged, profile_out)
        print(f"[serve] waste profile written to {profile_out}")
    if sarif_out:
        write_sarif(merged, sarif_out, src_root=os.getcwd())
        print(f"[serve] SARIF findings written to {sarif_out}")
    return merged


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--kv", default="dense", choices=("dense", "paged"))
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--spec", default="off", choices=("on", "off"),
                    help="speculative decoding (draft + width-k verify)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max draft tokens per verify window")
    ap.add_argument("--draft", default="ngram",
                    choices=("ngram", "oracle", "lm"),
                    help="drafter: self-speculative n-gram lookup, the "
                         "replay oracle (runs a plain pass first; accept "
                         "rate 1.0), or the model drafting for itself")
    ap.add_argument("--spec-rollback", default="on", choices=("on", "off"),
                    help="paged only: store only the accepted prefix "
                         "instead of every draft row")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--profile-out", default=None)
    ap.add_argument("--sarif-out", default=None,
                    help="write the merged waste profile as SARIF 2.1.0")
    ap.add_argument("--bucket-frames", default="on", choices=("on", "off"),
                    help="audio family: run the encoder at the power-of-two "
                         "bucket of the batch's longest true frame length "
                         "instead of the frames' full extent (the same "
                         "outputs; fewer padded bytes)")
    ap.add_argument("--objects", action="store_true",
                    help="register params, KV pages and draft window in "
                         "the object registry and run the replica scan")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    a = ap.parse_args()
    run(a.arch, smoke=a.smoke, batch=a.batch, prompt_len=a.prompt_len,
        gen=a.gen, profile=a.profile, profile_out=a.profile_out,
        sarif_out=a.sarif_out, kv=a.kv, page_size=a.page_size,
        spec=a.spec == "on", spec_k=a.spec_k, draft=a.draft,
        spec_rollback=a.spec_rollback == "on",
        bucket_frames=a.bucket_frames == "on", objects=a.objects,
        device=a.device)


if __name__ == "__main__":
    main()
