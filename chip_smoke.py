#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one
NVIDIA GPU: the serving path, the speculative-verify serving path and
the training path.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit), the torch, CUDA
   and nvcc versions, and builds the hand-written CUDA kernels from
   ``src/repro_torch/csrc`` (timed; ptxas registers and spills per
   kernel, and the HMMA instructions of the flash attention and paged
   window kernels from cuobjdump);
2. holds every kernel of the serving path against its plain PyTorch
   version on the card, at the main path's shapes (qwen3-1.7b: Hq 16,
   Hkv 8, D 128, page 16, 8 slots, windows of 2, 3, 8, 9, 32, 33 and
   128: both sides of each route threshold of the window kernel) on a hostile
   page table (out-of-order pages, partial last pages, unmapped holes
   and tails, an idle slot, a write past the table; decode positions
   whose histories span 1 to 6 history splits; verify windows of 5 that
   cross page boundaries or run past the mapped extent), for float32
   and bfloat16 pools: pools and counters must be equal, outputs and lse
   within 1e-4 (float32 activations) or 2e-2 (bfloat16) on rows that
   attend something, and two calls on the same inputs bit-identical in
   outputs, lse, pools and counters; times kernel, plain version and a
   PyTorch library call (SDPA over the gathered view, a yardstick the
   port never calls) on the main path's inputs by device time (CUPTI, L2
   flushed before every call) with CUDA-event times beside, and reads
   each call's launches and grids from the profiler's trace (one launch
   a call, history splits); then the same at a 2048-position history,
   and the window kernel's split and tensor-core routes side by side at
   windows of 1 to 32 rows (the measurement behind its route choice);
   then the RMSNorm forward and backward (Triton) against their plain
   versions at every norm shape of the three paths, in each x/scale
   dtype pair, with rows read by stride (out within 1e-5 relative at
   float32 and 2e-2 at bfloat16; dx and dscale within 2e-4 / 3e-2 of
   the plain gradient's largest magnitude), timed at the training norms
   beside ``torch.nn.functional.rms_norm`` (the library yardstick) by
   device time from CUPTI, CUDA-event times printed beside it;
3. runs the main path at full width: ``repro_torch.launch.serve.run``
   for qwen3-1.7b with the paged KV heap and the profiler on (random
   weights from seed 0, 28 layers), with the kernels' launch counts set
   to 0 just before and read just after; then one engine with kernel
   counters on duplicated-prefix traffic (prefix hits, copy-on-write,
   slot recycling, history in the window kernel); and checks the
   results: launches per layer and step (RMSNorm: 113 a forward),
   finite tokens in range, a merged profile with tier-3 and tier-4
   entries, and, on the smoke config in float32, the same greedy tokens
   and store counts from the kernels on the card as from the plain
   versions on the CPU; and traces one admission step and one decode
   tick at full width with torch.profiler (device time by kernel kind,
   device busy share);
3b. runs the speculative-verify path at full width:
   ``repro_torch.launch.serve.run`` with ``spec=True, spec_k=4,
   draft="ngram"``, once with rollback and once without, launch counts
   set to 0 before each: 28 window-kernel and 113 RMSNorm launches per
   verify tick, ``kernel_rejected_draft_store`` flagged 0 under rollback
   and equal to the rejected drafts under overwrite; traces one verify
   tick; and, on the smoke config in float32, checks that the replayed
   plain continuations (``--draft oracle``) give plain decode's tokens on
   the card, in every mode, and that the n-gram runs give the CPU's
   tokens and spec counters;
4. holds the training kernels against their plain versions on the card:
   flash attention forward and backward at the training path's shapes
   (B 4, S 1024, Hq 16, Hkv 8, D 128) in bfloat16 (tensor-core kernels)
   and float32 (CUDA-core kernels), and at a ragged length, Sq != Skv
   and without the causal mask; in bfloat16 also at D 64 and 32, one
   query row, a row past a 128-row tile, a key past a 64-key tile, the
   strided views of a fused projection and views that take the
   wrapper's counted alignment copy (out and lse within 1e-4 / 2e-2,
   dq, dk, dv within 2e-4 / 3e-2 of the plain gradient's largest
   magnitude, at float32 / bfloat16); two backward calls give
   bit-identical gradients; the silent compare on a bfloat16 tensor the
   size of the embedding leaf, on an f32 leaf and on edge cases (counts
   equal exactly); and times them as in 2, flash attention and its
   yardsticks (SDPA forward, SDPA's backward alone, SDPA forward +
   backward) by device time with CUDA-event times beside it (none for
   the silent compare);
5. runs the training path at full width: ``repro_torch.launch.train.run``
   for qwen3-1.7b, 4 steps of batch 4 x 1024 tokens with the training
   detectors on (random weights from seed 0, 28 layers), with the
   kernels' launch counts set to 0 just before and read just after, and
   checks the launches (28 forward and 28 backward flash launches and
   no alignment copy, 113 forward and 113 backward RMSNorm launches per
   step, one silent
   compare per checked parameter store), finite losses
   starting near ln(vocab) and a tier-3 training profile; then times
   train steps with the detectors on (tokens/s) and traces one with
   torch.profiler; and, on the smoke config in float32, checks that 4
   train steps with the kernels on the card give the losses, grad norms
   and detector findings of the plain versions on the CPU.

The line before the last lists the card; the last line is the JSON
result. Any failure exits non-zero; without CUDA, or without the rest of
the repository beside it, it exits non-zero and prints no result.
"""
import json
import os
import subprocess
import sys
import time

NEG_INF = -1e30
HBM_BYTES_S = 3.35e12          # H100 SXM device memory rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no tensor-core TF32
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# flash attention: (out and lse, gradients relative to their largest value)
FLASH_TOL = {"float32": (1e-4, 2e-4), "bfloat16": (2e-2, 3e-2)}
ZERO_GRAD_ATOL = 1e-5          # gradients that are zero in exact arithmetic


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------
class Timer:
    """Mean time of one call in ms from CUDA events around each call,
    with the 50 MB L2 flushed before every call (each layer's pool is
    cold on the main path: 27 other layers run between two visits)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        self.flush_names = set()      # the flush's own kernels (device())

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters

    def device(self, fn, iters: int = 20, warmup: int = 3) -> float:
        """Mean device time of one call in ms: the summed durations of the
        kernels and memsets the call launches, read from CUPTI through
        torch.profiler, L2 flushed before every call (the flush's own
        kernels left out). Unlike ``__call__`` it leaves out the host's
        launch path, which for a Triton kernel (tens of microseconds)
        exceeds a norm's device time."""
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        cuda = torch.autograd.DeviceType.CUDA

        def kernels(prof):
            return [e for e in prof.events() if e.device_type == cuda]
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        # A trace can miss the first kernel of its window: the flush's
        # names come from a trace of three flushes, and each timed trace
        # opens with an untimed flush. A trace in which fewer flushes than
        # calls were seen is retaken.
        for _ in range(5):
            if not self.flush_names:
                with profile(activities=acts) as prof:
                    for _ in range(3):
                        self.flush.zero_()
                    torch.cuda.synchronize()
                self.flush_names = {e.name for e in kernels(prof)}
            with profile(activities=acts) as prof:
                self.flush.zero_()
                torch.cuda.synchronize()
                for _ in range(iters):
                    self.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            evs = kernels(prof)
            flushes = sum(e.name in self.flush_names for e in evs)
            us = sum(e.time_range.elapsed_us() for e in evs
                     if e.name not in self.flush_names)
            if us > 0 and flushes >= iters:
                return us / iters / 1e3
            print(f"[timer] retaking a trace: {flushes} flushes of "
                  f"{iters} seen, {len(evs)} kernels", flush=True)
            self.flush_names = set()
        return float("nan")     # not measured


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------
B, HQ, HKV, D, PS = 8, 16, 8, 128, 16
MAX_LEN = 128 + 32 + 1                    # the main path's cache extent
M = -(-MAX_LEN // PS)                     # pages per slot (11)
P = B * M                                 # pool pages (88)


def hostile_table(np, rng, idx, S):
    """(B, M) page table over a shuffled pool: every slot maps its own
    pages out of order, for positions [0, idx+S) and a random budget
    beyond, with holes; some slots leave the end unmapped."""
    perm = rng.permutation(P)
    pt = np.full((B, M), -1, np.int32)
    for b in range(B):
        if idx[b] < 0:
            continue                      # idle slot: nothing mapped
        need = min(M, -(-(int(idx[b]) + S) // PS) + int(rng.integers(0, 2)))
        pt[b, :need] = perm[b * M:b * M + need]
    pt[1, 1] = -1                         # a hole in the history
    pt[2, -(-(int(idx[2]) + S) // PS) - 1:] = -1   # the window's end unmapped
    return pt


def kernel_cases(np):
    """(name, S, idx, store) cases at the main path's shapes."""
    # decode: page boundaries, a row past the table (idx >= M*PS, drop),
    # a row on an unmapped page, an idle slot
    dec = np.array([140, 37, 15, 16, 100, 159, M * PS, -1], np.int32)
    # windows: a fresh prefill (idx 0), prefix hits (history), an idle
    # slot (sentinel -(S+1))
    cases = [("decode", 1, dec, True)]
    # verify windows of W = 5 (spec_k 4) through the verify wrapper: page
    # crossings (14, 45), the window's end unmapped (slot 2 at 30), the
    # cache's end (156), an idle slot at -(W+1)
    w5 = np.array([0, 72, 30, 14, 156, 45, 9, -6], np.int32)
    cases += [("verify W=5 overwrite", 5, w5, True),
              ("verify W=5 defer", 5, w5, False)]
    # windows on both sides of the routes' thresholds: the split and the
    # tensor cores for bf16 (S * G = 4, 6), the split and the CUDA-core
    # kernel for f32 (S * G = 16, 18), the tensor-core kernel with and
    # without history splits (S * G = 64, 66)
    for S in (2, 3, 8, 9, 32, 33, 128):
        w = np.array([0, 72, 32, 140, 17, 0, 9, -(S + 1)], np.int32)
        w = np.minimum(w, MAX_LEN - S)
        w[-1] = -(S + 1)
        cases += [(f"window S={S} store", S, w, True),
                  (f"window S={S} defer", S, w, False)]
    return cases


def bytes_flops(np, name, S, idx, pt, store, act_isz, pool_isz):
    """Least bytes moved and flops done by one call on these inputs: each
    input read once, each output written once, history counted as the
    mapped rows the call attends, stores as the rows that land."""
    m = pt.shape[1]
    row = 2 * HKV * D * pool_isz                       # one K+V pool row
    nbytes = (B * S * HQ * D * act_isz * 2             # q in, out
              + 2 * B * S * HKV * D * act_isz          # new/window K, V
              + B * HQ * S * 4 + B * 3 * 4 + pt.size * 4 + idx.size * 4)
    flops = 0
    for b in range(B):
        i0 = int(idx[b])
        mapped = [pt[b, p // PS] >= 0 if 0 <= p < m * PS else False
                  for p in range(max(i0, 0) + S)]
        hist = sum(mapped[:max(i0, 0)])
        nbytes += hist * row
        win_ok = [(0 <= i0 + c < m * PS) and (not store or mapped[i0 + c])
                  for c in range(S)] if i0 + S > 0 else [False] * S
        if store:
            nbytes += 2 * row * sum(win_ok)             # old read + new write
        for r in range(S):
            if i0 + r < 0:
                continue
            keys = hist + sum(win_ok[:r + 1])
            flops += HQ * keys * 4 * D
    return nbytes, flops


def main_path_table(np, rng):
    """(B, M) page table of the main path's cache: every slot maps its
    own 11 pages of the pool, in shuffled order."""
    return rng.permutation(P).reshape(B, M).astype(np.int32)


def run_case(torch, act, pool_dt, name, S, idx_np, pt_np, store, seed,
             pages=P, route=None):
    """Build one case's inputs on the card (a pool of ``pages`` pages), run
    the kernel twice and its plain version once on copies of the pools,
    check the two kernel calls bit for bit against each other and the
    kernel against the plain version, and print the result. ``route``
    forces a route of the window kernel (``flash_prefill.ROUTES``).
    Returns (max |err|, kernel, plain, inputs)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.paged_verify import paged_verify_attention

    adt, pdt = getattr(torch, act), getattr(torch, pool_dt)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    q = randn(B, S, HQ, D, dtype=adt)
    kn = randn(B, S, HKV, D, dtype=adt)
    vn = randn(B, S, HKV, D, dtype=adt)
    pool_k = randn(pages, PS, HKV, D, dtype=pdt)
    pool_v = randn(pages, PS, HKV, D, dtype=pdt)
    pt = torch.as_tensor(pt_np, device="cuda")
    idx = torch.as_tensor(idx_np, device="cuda")
    if store:
        # every other window row re-stores what the pool holds (K only):
        # silent stores
        half = torch.zeros_like(kn)
        half[:, ::2] = kn[:, ::2]
        ref.paged_update(pool_k, pool_v, half, half, pt, idx)
    args = (q, kn, vn)
    if name == "decode":
        def kernel(pk, pv):
            return paged_decode_attention(*args, pk, pv, pt, idx)

        def plain(pk, pv):
            out, lse, _, _, cnt = ref.paged_decode_ref(*args, pk, pv, pt, idx)
            return out, lse, cnt
    else:
        if route is not None:
            def call(pk, pv):
                return fp.paged_window_on_route(route, *args, pk, pv, pt,
                                                idx, store=store)
        elif name.startswith("verify"):
            def call(pk, pv):
                return paged_verify_attention(
                    *args, pk, pv, pt, idx,
                    mode="overwrite" if store else "defer")
        else:
            def call(pk, pv):
                return fp.paged_window_attention(*args, pk, pv, pt, idx,
                                                 store=store)

        def kernel(pk, pv):
            out, lse, cnt, _, _ = call(pk, pv)
            return out, lse, cnt

        def plain(pk, pv):
            out, lse, _, _, cnt = ref.paged_window_ref(
                *args, pk, pv, pt, idx, store=store)
            return out, lse, cnt
    kk, kv = pool_k.clone(), pool_v.clone()
    kk2, kv2 = pool_k.clone(), pool_v.clone()
    pk_, pv_ = pool_k.clone(), pool_v.clone()
    o_k, l_k, c_k = kernel(kk, kv)
    again = kernel(kk2, kv2)
    o_p, l_p, c_p = plain(pk_, pv_)
    torch.cuda.synchronize()
    twice = (all(torch.equal(x, y) for x, y in zip((o_k, l_k, c_k), again))
             and torch.equal(kk, kk2) and torch.equal(kv, kv2))
    lse_k = l_k.reshape(B, HQ, S)
    lse_p = l_p.reshape(B, HQ, S)
    live = (lse_p > NEG_INF / 2)                     # (B, Hq, S)
    live_o = live.permute(0, 2, 1)[..., None]        # (B, S, Hq, 1)
    zero = torch.zeros((), device="cuda")
    err_o = torch.where(live_o, (o_k.float() - o_p.float()).abs(), zero)
    err_l = torch.where(live, (lse_k - lse_p).abs(), zero)
    err = max(float(err_o.max()), float(err_l.max()))
    dead_ok = bool(torch.where(live_o, zero, o_k.float().abs()).max()
                   == 0) and bool((lse_k[~live] == NEG_INF).all())
    same = (torch.equal(kk, pk_) and torch.equal(kv, pv_)
            and torch.equal(c_k, c_p))
    label = name if route is None else f"{name} route {route}"
    print(f"[kernels] {label:21s} act {act:8s} pool {pool_dt:8s} "
          f"pools+counters equal {same} | max |err| {err:.3e} "
          f"(tol {TOL[act]}) | idle rows 0 {dead_ok} | two calls "
          f"bit-identical {twice} | counters {c_k.sum(0).tolist()}",
          flush=True)
    if not (same and err <= TOL[act] and dead_ok and twice):
        raise AssertionError(f"{label} ({act}/{pool_dt}) disagrees with its "
                             f"plain version or with itself")
    return err, kernel, plain, (q, kn, vn, pool_k, pool_v, pt, idx)


def check_hostile(torch, np):
    """Phase 2, hostile tables in every dtype pair."""
    rng = np.random.default_rng(0)
    seed = 0
    for act, pool_dt in (("bfloat16", "float32"), ("bfloat16", "bfloat16"),
                         ("float32", "float32")):
        for name, S, idx_np, store in kernel_cases(np):
            seed += 1
            run_case(torch, act, pool_dt, name, S, idx_np,
                     hostile_table(np, rng, idx_np, S), store, seed)


# the main path's kernel calls: (JSON key, case, S, position)
MAIN_CALLS = (("paged_decode", "decode", 1, 144),
              ("paged_window", "window S=128 store", 128, 0),
              ("paged_verify", "verify W=5 defer", 5, 144),
              ("paged_verify", "verify W=5 overwrite", 5, 144))


def time_paged(torch, np, timer, name, S, pos, pt_np, pages, seed):
    """Check one call on the main path's dtypes (bf16 activations, f32
    pool) with every slot at ``pos``, then time kernel, plain version and
    SDPA over the gathered view by device time (CUPTI, L2 flushed before
    each call), kernel and SDPA also by CUDA events. Returns (max |err|,
    device ms by call, event ms by call, bytes, flops)."""
    idx_np = np.full(B, pos, np.int32)
    store = not name.endswith("defer")
    err, kernel, plain, inputs = run_case(
        torch, "bfloat16", "float32", name, S, idx_np, pt_np, store,
        seed=seed, pages=pages)
    q, kn, vn, pool_k, pool_v, pt, idx = inputs
    # store mode rewrites the same rows on every call
    kk, kv = pool_k.clone(), pool_v.clone()
    pk_, pv_ = pool_k.clone(), pool_v.clone()
    calls = {"kernel": lambda: kernel(kk, kv),
             "plain": lambda: plain(pk_, pv_),
             "sdpa": library_call(torch, q, kn, vn, pool_k, pool_v, pt, idx,
                                  S)}
    dev = {k: timer.device(fn) for k, fn in calls.items()}
    ev = {k: timer(calls[k]) for k in ("kernel", "sdpa")}
    dev["launches"] = launch_grids(torch, calls["kernel"])
    nbytes, flops = bytes_flops(np, name, S, idx_np, pt_np, store,
                                q.element_size(), pool_k.element_size())
    return err, dev, ev, nbytes, flops


def launch_grids(torch, fn):
    """The paged kernels one call of fn launches, with their grids, from
    the profiler's trace: [(kernel, (x, y, z))]."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")   # a trace can miss its first kernel
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [(kernel_label_demangled(e["name"]),
             tuple(e.get("args", {}).get("grid", ())))
            for e in events if e.get("cat") == "kernel"
            and _kernel_kind(e["name"]) in ("paged_decode", "paged_window")]


def kernel_label_demangled(name: str) -> str:
    """``window_tc_kernel<float, 128>`` from a demangled kernel name."""
    import re
    m = re.search(r"([a-z_]+_kernel<[^(]*>)", name)
    return m.group(1) if m else name


def check_kernels(torch, np, timer):
    """Phase 2. Hostile tables in every dtype pair, then the main path's
    own inputs (bf16 activations, f32 pool; decode with every slot at
    position 144, prefill of 128 tokens at 0, verify windows of 5 at 144
    in both modes), timed. Returns the kernels' JSON entries (all but
    launches)."""
    check_hostile(torch, np)
    rng = np.random.default_rng(1)
    entries = {}
    for key, name, S, pos in MAIN_CALLS:
        err, dev, ev, nbytes, flops = time_paged(
            torch, np, timer, name, S, pos, main_path_table(np, rng), P,
            seed=100 + S)
        b_ms, by = bound(nbytes, flops, PEAK_FLOPS["bfloat16"])
        ms = dev["kernel"]
        grids = dev.pop("launches")
        print(f"[kernels] {key} on the main path's inputs ({name}): "
              f"launches per call {grids}", flush=True)
        # one launch a call (the store rides it); the decode and the
        # verify windows split the history (grid x: splits of the split
        # kernel, grid z: of the tensor-core kernel's one row tile)
        assert len(grids) == 1, grids
        kern, grid = grids[0]
        if S < 128 and grid:
            splits = grid[0] if "split" in kern else grid[2]
            assert splits >= 2, grids
        print(f"[kernels] {key} on the main path's inputs ({name}, B {B}, "
              f"position {pos}, bf16 act, f32 pool), device time: kernel "
              f"{ms:.4f} ms | plain {dev['plain']:.4f} ms | SDPA over the "
              f"gathered view {dev['sdpa']:.4f} ms (kernel / SDPA "
              f"{ms / dev['sdpa']:.2f}) | bound {b_ms:.4f} ms ({by}: "
              f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP; kernel at "
              f"{b_ms / ms:.3f} of it) | CUDA events: kernel "
              f"{ev['kernel']:.4f} ms, SDPA {ev['sdpa']:.4f} ms", flush=True)
        if key == "paged_verify":
            continue          # a mode of paged_window, printed only
        entries[key] = {
            "name": key, "route": "cuda",
            "source": f"src/repro_torch/csrc/{key}.cu",
            "replaces": ("src/repro/kernels/paged_attention.py:120"
                         if key == "paged_decode" else
                         "src/repro/kernels/flash_prefill.py:171"),
            "max_abs_err": err, "ms": ms, "plain_ms": dev["plain"],
            "bound_ms": b_ms, "bound_by": by, "library_ms": dev["sdpa"],
            "event_ms": ev["kernel"]}
    long_history(torch, np, timer)
    crossover(torch, np, timer)
    return entries


def crossover(torch, np, timer):
    """B2 through its split and tensor-core routes on the same inputs
    (bf16 activations, f32 pool, store mode), windows of S rows at
    positions 0 and 144, checked against the plain version and timed by
    device time: the measurement behind the kernel's choice of the
    tensor cores for bf16 activations."""
    rng = np.random.default_rng(4)
    for pos in (0, 144):
        times = []
        for S in (1, 2, 4, 5, 8, 16, 32):
            pt_np = main_path_table(np, rng)
            row = []
            for route in ("split", "tensor_core"):
                _, kernel, _, inputs = run_case(
                    torch, "bfloat16", "float32", f"window S={S} store", S,
                    np.full(B, pos, np.int32), pt_np, True, seed=300 + S,
                    route=route)
                kk, kv = inputs[3].clone(), inputs[4].clone()
                row.append(timer.device(lambda: kernel(kk, kv)))
            times.append(f"S {S}: split {row[0]:.4f}, tensor cores "
                         f"{row[1]:.4f}")
        print(f"[kernels] B2 routes at position {pos} (bf16 act, f32 pool, "
              f"store), device ms: " + "; ".join(times), flush=True)


LONG_M = 128                              # pages per slot: 2048 positions


def long_history(torch, np, timer):
    """B1 and B2 at W = 5 (both modes) with every slot at the end of a
    2048-position history (128 pages a slot, shuffled), checked and timed
    as on the main path's inputs: where long-context users feel the
    split of the history."""
    rng = np.random.default_rng(3)
    pages = B * LONG_M
    pt_np = rng.permutation(pages).reshape(B, LONG_M).astype(np.int32)
    for name, S in (("decode", 1), ("verify W=5 defer", 5),
                    ("verify W=5 overwrite", 5)):
        pos = LONG_M * PS - S
        err, dev, ev, nbytes, flops = time_paged(
            torch, np, timer, name, S, pos, pt_np, pages, seed=200 + S)
        b_ms, by = bound(nbytes, flops, PEAK_FLOPS["bfloat16"])
        print(f"[kernels] long history ({name}, B {B}, position {pos} of "
              f"{LONG_M * PS}, M {LONG_M}), device time: kernel "
              f"{dev['kernel']:.4f} ms | plain {dev['plain']:.4f} ms | SDPA "
              f"over the gathered view {dev['sdpa']:.4f} ms (kernel / SDPA "
              f"{dev['kernel'] / dev['sdpa']:.2f}) | bound {b_ms:.4f} ms "
              f"({by}: {nbytes / 1e6:.2f} MB) | max |err| {err:.3e} | CUDA "
              f"events: kernel {ev['kernel']:.4f} ms, SDPA "
              f"{ev['sdpa']:.4f} ms", flush=True)


def library_call(torch, q, kn, vn, pool_k, pool_v, pt, idx, S):
    """One SDPA call on the gathered, masked view of the same inputs (the
    gather and the mask are built outside the call)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    dt = q.dtype
    pk, pv = pool_k.clone(), pool_v.clone()
    ref.paged_update(pk, pv, kn, vn, pt, idx)
    gk, valid = ref.paged_gather(pk, pt)
    gv, _ = ref.paged_gather(pv, pt)
    L = gk.shape[1]
    G = HQ // HKV
    k = gk.to(dt).repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    v = gv.to(dt).repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    qpos = idx.long()[:, None] + torch.arange(S, device="cuda")[None]
    mask = ((torch.arange(L, device="cuda")[None, None] <= qpos[..., None])
            & valid[:, None, :])[:, None]                # (B,1,S,L)
    qt = q.transpose(1, 2).contiguous()
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask)


# ----------------------------------------------------------------------
# phase 2b: RMSNorm forward and backward against their plain versions
# ----------------------------------------------------------------------
RMS_TOL = {"float32": (1e-5, 2e-4), "bfloat16": (2e-2, 3e-2)}
RMS_EPS = 1e-6                            # qwen3's norm_eps
NORMS_PER_FORWARD = 4                     # per layer: ln1, ln2, q, k


def rmsnorm_case(torch, rows, width, x_dtype, s_dtype, strided, seed):
    """Forward (with rstd) and backward kernels against their plain
    versions on one set of inputs. Returns (max |err| of y, max |err| of
    dx and dscale, relative errors, inputs)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_backward, rmsnorm_forward
    g = torch.Generator(device="cuda").manual_seed(seed)
    xdt, sdt = getattr(torch, x_dtype), getattr(torch, s_dtype)
    if strided:       # rows of a wider buffer: read by stride, no copy
        x = (3 * torch.randn((rows, 3 * width), generator=g,
                             device="cuda")).to(xdt)[:, width:2 * width]
    else:
        x = (3 * torch.randn((rows, width), generator=g,
                             device="cuda")).to(xdt)
    scale = torch.randn(width, generator=g, device="cuda").to(sdt)
    dy = torch.randn((rows, width), generator=g, device="cuda").to(xdt)
    y, rstd = rmsnorm_forward(x, scale, RMS_EPS, want_rstd=True)
    dx, ds = rmsnorm_backward(x, scale, rstd, dy, RMS_EPS)
    want = ref.rmsnorm_ref(x, scale, RMS_EPS)
    want_dx, want_ds = ref.rmsnorm_bwd_ref(x, scale, dy, RMS_EPS)
    torch.cuda.synchronize()
    err = float((y.float() - want.float()).abs().max())
    rel = float(((y.float() - want.float()).abs()
                 / want.float().abs().clamp_min(1e-3)).max())
    err_g = max(float((a.float() - b.float()).abs().max())
                for a, b in ((dx, want_dx), (ds, want_ds)))
    rel_g = max(float((a.float() - b.float()).abs().max())
                / max(float(b.float().abs().max()), 1e-30)
                for a, b in ((dx, want_dx), (ds, want_ds)))
    tol, tol_g = RMS_TOL["float32" if x_dtype == s_dtype == "float32"
                         else "bfloat16"]
    print(f"[kernels] rmsnorm {rows:6d} x {width:4d} x {x_dtype:8s} scale "
          f"{s_dtype:8s}{' strided' if strided else '        '} | out max "
          f"rel err {rel:.3e} (tol {tol}) | dx/dscale max rel err "
          f"{rel_g:.3e} (tol {tol_g})", flush=True)
    if not (rel <= tol and rel_g <= tol_g):
        raise AssertionError(f"rmsnorm ({rows}x{width}, {x_dtype}/"
                             f"{s_dtype}) disagrees with its plain version")
    return err, err_g, (x, scale, dy, rstd)


def check_rmsnorm(torch, timer):
    """Phase 2b. Every norm shape of the three main paths (decode tick,
    verify tick, prefill, training block/q/k norms) in each x/scale dtype
    pair, strided rows and a ragged width; timed at the training block
    norm (4096 x 2048 bf16, bf16 scale, rstd written). Returns the
    forward and backward JSON entries."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_backward, rmsnorm_forward
    seed = 0
    for x_dtype, s_dtype in (("float32", "float32"), ("bfloat16", "float32"),
                             ("bfloat16", "bfloat16")):
        for rows, width, strided in (
                (8, 2048, False), (40, 2048, False), (1024, 2048, False),
                (128, 128, False), (16384, 128, False),
                (TB * TSEQ, 2048, False), (TB * TSEQ * HQ, 128, False),
                (TB * TSEQ * HKV, 128, False), (131, 2048, True),
                (517, 128, True), (33, 1000, False)):
            seed += 1
            rmsnorm_case(torch, rows, width, x_dtype, s_dtype, strided, seed)

    entries = {}
    for label, rows, width in (("block", TB * TSEQ, 2048),
                               ("q-norm", TB * TSEQ * HQ, 128),
                               ("k-norm", TB * TSEQ * HKV, 128)):
        err, err_g, (x, scale, dy, rstd) = rmsnorm_case(
            torch, rows, width, "bfloat16", "bfloat16", False, seed=rows)
        xl = x.detach().requires_grad_(True)
        sl = scale.detach().requires_grad_(True)
        calls = {
            "fwd": lambda: rmsnorm_forward(x, scale, RMS_EPS,
                                           want_rstd=True),
            "bwd": lambda: rmsnorm_backward(x, scale, rstd, dy, RMS_EPS),
            "fwd_plain": lambda: ref.rmsnorm_ref(x, scale, RMS_EPS),
            "bwd_plain": lambda: ref.rmsnorm_bwd_ref(x, scale, dy, RMS_EPS),
            "fwd_lib": lambda: F.rms_norm(x, (width,), scale, RMS_EPS),
            "bwd_lib": lambda: torch.autograd.backward(
                F.rms_norm(xl, (width,), sl, RMS_EPS), dy)}
        dev = {k: timer.device(fn) for k, fn in calls.items()}
        ev = {k: timer(fn) for k, fn in calls.items()}
        fwd, bwd, fwd_plain, bwd_plain, fwd_lib, bwd_lib = (
            dev[k] for k in ("fwd", "bwd", "fwd_plain", "bwd_plain",
                             "fwd_lib", "bwd_lib"))
        isz = x.element_size()
        # forward: x, scale in; y, rstd out. backward: x, dy, rstd, scale
        # in; dx, dscale out. ~4 f32 operations an element forward, ~8
        # backward, on the CUDA cores
        n = rows * width
        fwd_b = bound(2 * n * isz + width * isz + rows * 4, 4 * n,
                      PEAK_FLOPS["float32"])
        bwd_b = bound(3 * n * isz + rows * 4 + 2 * width * isz, 8 * n,
                      PEAK_FLOPS["float32"])
        print(f"[kernels] rmsnorm {label} on the training inputs ({rows} x "
              f"{width} bf16, bf16 scale), device time: forward kernel "
              f"{fwd:.4f} ms | plain {fwd_plain:.4f} ms | F.rms_norm "
              f"{fwd_lib:.4f} ms | bound {fwd_b[0]:.4f} ms ({fwd_b[1]}); "
              f"backward kernel {bwd:.4f} ms | plain {bwd_plain:.4f} ms | "
              f"F.rms_norm fwd+bwd {bwd_lib:.4f} ms | bound "
              f"{bwd_b[0]:.4f} ms ({bwd_b[1]})", flush=True)
        print(f"[kernels] rmsnorm {label}, CUDA events around each call "
              f"(host launch path included): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ev.items()),
              flush=True)
        if label != "block":
            continue
        for key, ms, plain_ms, lib_ms, e, (b_ms, by) in (
                ("rmsnorm_fwd", fwd, fwd_plain, fwd_lib, err, fwd_b),
                ("rmsnorm_bwd", bwd, bwd_plain, bwd_lib, err_g, bwd_b)):
            entries[key] = {
                "name": key, "route": "triton",
                "source": "src/repro_torch/kernels/rmsnorm.py",
                "replaces": "src/repro/kernels/rmsnorm.py:23",
                "max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms}
    return entries


# ----------------------------------------------------------------------
# phase 4: the training kernels against their plain versions
# ----------------------------------------------------------------------
TB, TSEQ = 4, 1024                        # the training path's batch


def flash_case(torch, dtype, sq, skv, causal, seed, d=D, layout="plain"):
    """Forward and backward kernels against their plain versions on one
    set of inputs (the backward versions both get the kernel's out and
    lse). ``layout``: "plain" (contiguous q, k, v), "fused" (views of
    one fused (B, S, Hq + 2 Hkv, d) projection, Sq == Skv) or
    "misaligned" (views one element into a wider buffer, which the
    bfloat16 kernels take only through the wrapper's counted copy).
    Returns (out/lse error, relative gradient error, inputs)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_forward)
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dt)
    if layout == "fused":
        qkv = randn(TB, sq, HQ + 2 * HKV, d)
        q, k, v = qkv[:, :, :HQ], qkv[:, :, HQ:HQ + HKV], qkv[:, :, HQ + HKV:]
    elif layout == "misaligned":
        q, k, v = (randn(TB, s, h, d + 2)[..., 1:d + 1]
                   for s, h in ((sq, HQ), (skv, HKV), (skv, HKV)))
    else:
        q, k, v = (randn(TB, sq, HQ, d), randn(TB, skv, HKV, d),
                   randn(TB, skv, HKV, d))
    dout = randn(TB, sq, HQ, d)
    copies = (flash_attention_forward.copies,
              flash_attention_backward.copies)
    out, lse = flash_attention_forward(q, k, v, causal)
    grads = flash_attention_backward(q, k, v, out, lse, dout, causal)
    copies = (flash_attention_forward.copies - copies[0],
              flash_attention_backward.copies - copies[1])
    want_out, want_lse = ref.flash_attention_ref(q, k, v, causal)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal)
    torch.cuda.synchronize()
    err = max(float((out.float() - want_out.float()).abs().max()),
              float((lse - want_lse).abs().max()))
    tol, tol_g = FLASH_TOL[dtype]
    diffs = [(float((a.float() - b.float()).abs().max()),
              float(b.float().abs().max())) for a, b in zip(grads, want)]
    err_g = max(e / max(m, 1e-30) for e, m in diffs)
    # a gradient that is zero in exact arithmetic (dq and dk where a row
    # sees a single key) is rounding noise on both sides: held within
    # ZERO_GRAD_ATOL, as in tests/test_torch_cuda_kernels.py
    ok_g = all(e <= max(tol_g * m, ZERO_GRAD_ATOL) for e, m in diffs)
    print(f"[kernels] flash attention {dtype:8s} Sq {sq:4d} Skv {skv:4d} "
          f"D {d:3d} causal {causal!s:5s} {layout:10s} | out/lse max |err| "
          f"{err:.3e} (tol {tol}) | dq/dk/dv max rel err {err_g:.3e} (tol "
          f"{tol_g}; max |err| {max(e for e, _ in diffs):.3e}, largest "
          f"|grad| {min(m for _, m in diffs):.3e} to "
          f"{max(m for _, m in diffs):.3e}) | alignment copies fwd/bwd "
          f"{copies}", flush=True)
    if not (err <= tol and ok_g):
        raise AssertionError(f"flash attention ({dtype}, {sq}x{skv}, D {d}, "
                             f"causal {causal}, {layout}) disagrees with "
                             f"its plain version")
    want_copies = ((3, 3) if layout == "misaligned" and dtype == "bfloat16"
                   else (0, 0))
    assert copies == want_copies, (layout, dtype, copies)
    return err, err_g, (q, k, v, out, lse, dout)


def flash_bytes_flops(sq, skv, isz, causal, backward):
    """Least bytes and flops of one call: inputs read once, outputs
    written once; 4 D flops per visible (query, key) pair forward (two
    products), 10 D backward (the scores again, dP, dV, dK, dQ)."""
    pairs = TB * HQ * (sum(min(r + 1, skv) for r in range(sq)) if causal
                       else sq * skv)
    qo = TB * sq * HQ * D * isz
    kv = TB * skv * HKV * D * isz
    lse = TB * HQ * sq * 4
    if backward:       # q k v out dout lse in; dq dk dv out
        return 3 * qo + 2 * kv + lse + qo + 2 * kv, 10 * D * pairs
    return 2 * qo + 2 * kv + lse, 4 * D * pairs


def bound(nbytes, flops, peak):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def check_flash(torch, timer):
    """Phase 4a. The training shapes in both dtypes, then ragged, unequal
    and non-causal cases; in bfloat16 also D 64, one query row, one row
    past a 128-row tile, one key past a 64-key tile, a fused projection's
    strided views and views that take the alignment copy. Two backward
    calls on the same inputs must give bit-identical gradients. Timed at
    the training path's own inputs (bfloat16, causal) by device time
    (CUPTI), CUDA-event times beside it. Returns the forward and backward
    JSON entries."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_forward)
    for dtype in ("float32", "bfloat16"):
        for sq, skv, causal in ((TSEQ, TSEQ, True), (1000, 1000, True),
                                (1000, TSEQ, True), (TSEQ, 1000, True),
                                (1000, TSEQ, False)):
            flash_case(torch, dtype, sq, skv, causal, seed=sq + skv)
    for sq, skv, causal, d, layout in (
            (TSEQ, TSEQ, True, 64, "plain"), (1, TSEQ, True, D, "plain"),
            (1, TSEQ, False, D, "plain"), (129, 129, True, D, "plain"),
            (129, 65, False, D, "plain"), (200, 65, True, D, "plain"),
            (65, 65, True, 32, "plain"), (TSEQ, TSEQ, True, D, "fused"),
            (300, 300, True, 64, "fused"), (300, 300, True, D, "misaligned"),
            (129, 65, False, 64, "misaligned")):
        flash_case(torch, "bfloat16", sq, skv, causal, seed=sq + 7 * skv + d,
                   d=d, layout=layout)
    err, err_g, (q, k, v, out, lse, dout) = flash_case(
        torch, "bfloat16", TSEQ, TSEQ, True, seed=1)
    first = flash_attention_backward(q, k, v, out, lse, dout, True)
    again = flash_attention_backward(q, k, v, out, lse, dout, True)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    print(f"[kernels] flash attention backward, two calls on the training "
          f"inputs: dq, dk, dv bit-identical {same}", flush=True)
    assert same, "flash attention backward is not deterministic"
    del first, again

    # SDPA on the (B, H, S, D) layout, transposed outside the timed call
    qt, kt, vt, dt_ = (x.transpose(1, 2).contiguous()
                       for x in (q, k, v, dout))

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(a, b, c, is_causal=True,
                                              enable_gqa=True)
    leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
    sdpa_out = sdpa(*leaves)           # the forward of "SDPA bwd", untimed
    calls = {
        "fwd": lambda: flash_attention_forward(q, k, v, True),
        "bwd": lambda: flash_attention_backward(q, k, v, out, lse, dout,
                                                True),
        "fwd_plain": lambda: ref.flash_attention_ref(q, k, v, True),
        "bwd_plain": lambda: ref.flash_attention_bwd_ref(
            q, k, v, out, lse, dout, True),
        "sdpa_fwd": lambda: sdpa(qt, kt, vt),
        # the backward alone: autograd.grad through the saved graph (no
        # accumulation into .grad)
        "sdpa_bwd": lambda: torch.autograd.grad(sdpa_out, leaves, dt_,
                                                retain_graph=True),
        "sdpa_fwd_bwd": lambda: torch.autograd.grad(sdpa(*leaves), leaves,
                                                    dt_)}
    dev = {k: timer.device(fn) for k, fn in calls.items()}
    ev = {k: timer(fn) for k, fn in calls.items()}
    print(f"[kernels] flash attention on the training inputs, CUDA events "
          f"around each call (host launch path and flush tail included): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in ev.items()), flush=True)
    isz = q.element_size()
    entries = {}
    for key, back, e in (("flash_attention_fwd", False, err),
                         ("flash_attention_bwd", True, err_g)):
        tag = "bwd" if back else "fwd"
        ms, plain_ms, lib_ms = dev[tag], dev[tag + "_plain"], dev["sdpa_" + tag]
        nbytes, flops = flash_bytes_flops(TSEQ, TSEQ, isz, True, back)
        b_ms, by = bound(nbytes, flops, PEAK_FLOPS["bfloat16"])
        entries[key] = {
            "name": key, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:93",
            "max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
            "event_ms": ev[tag]}
        extra = (f" | SDPA fwd+bwd {dev['sdpa_fwd_bwd']:.4f} ms" if back
                 else "")
        print(f"[kernels] {key} on the training inputs (B {TB}, S {TSEQ}, "
              f"Hq {HQ}, Hkv {HKV}, D {D}, bf16, causal), device time: "
              f"kernel {ms:.4f} ms = {flops / ms / 1e9:.1f} TFLOP/s at the "
              f"bound's flops, {b_ms / ms:.3f} of the bound | plain "
              f"{plain_ms:.4f} ms | {'SDPA bwd alone' if back else 'SDPA fwd'}"
              f" {lib_ms:.4f} ms (kernel / SDPA {ms / lib_ms:.2f}){extra} | "
              f"bound {b_ms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP)", flush=True)
    return entries


def check_silent(torch, timer):
    """Phase 4b. Counts equal exactly on the embedding leaf's size in
    bfloat16, an f32 leaf, and edge cases; timed on the embedding leaf at
    the detectors' tolerance. Returns the JSON entry."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.silent_compare import silent_compare
    g = torch.Generator(device="cuda").manual_seed(7)

    def pair(shape, dtype):
        """A leaf before and after a step that moves a third of the
        elements by ~1e-3 relative and redraws a seventh."""
        a = torch.randn(shape, generator=g, device="cuda") * 0.02
        b = a.clone().reshape(-1)
        b[::3] *= 1 + 1e-2 * torch.randn(b[::3].shape, generator=g,
                                         device="cuda")
        b[::7] = 0.02 * torch.randn(b[::7].shape, generator=g, device="cuda")
        return a.to(dtype), b.reshape(shape).to(dtype)
    special = torch.tensor([float("nan"), 0.0, -0.0, float("inf"),
                            -float("inf"), 1e-40, -1e-40, 3e-39, 1.0],
                           device="cuda")
    ea = torch.randn(4096 * 5 + 77, generator=g, device="cuda")
    eb = ea.clone()
    n = special.numel()
    ea[:n], eb[:n] = special, special.flip(0)
    ea[n:2 * n], eb[n:2 * n] = special, special
    ea[-n:], eb[-n:] = special, special * (1 + 1e-3)
    cases = [("embedding leaf bf16", *pair((152064, 2048), torch.bfloat16)),
             ("f32 leaf", *pair((28, 2048, 2048), torch.float32)),
             ("edge cases f32", ea, eb),
             ("edge cases bf16", ea.to(torch.bfloat16), eb.to(torch.bfloat16))]
    for name, a, b in cases:
        for tol in (0.0, 0.01):
            got = int(silent_compare(a, b, tol))
            want = int(ref.silent_compare_ref(a, b, tol))
            torch.cuda.synchronize()
            print(f"[kernels] silent_compare {name:20s} n {a.numel():10d} "
                  f"tol {tol}: kernel {got} plain {want}", flush=True)
            if got != want:
                raise AssertionError(f"silent_compare {name} tol {tol}: "
                                     f"{got} != {want}")
    _, a, b = cases[0]
    ms = timer(lambda: silent_compare(a, b, 0.01))
    plain_ms = timer(lambda: ref.silent_compare_ref(a, b, 0.01))
    nbytes = 2 * a.numel() * a.element_size()
    b_ms, by = bound(nbytes, 0, PEAK_FLOPS["bfloat16"])
    print(f"[kernels] silent_compare on the embedding leaf (152064 x 2048 "
          f"bf16, tol 0.01): kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
          f"no single PyTorch call computes this predicate (isclose has "
          f"another tolerance rule) | bound {b_ms:.4f} ms ({by}: "
          f"{nbytes / 1e6:.2f} MB)", flush=True)
    return {"name": "silent_compare", "route": "triton",
            "source": "src/repro_torch/kernels/silent_compare.py",
            "replaces": "src/repro/kernels/silent_compare.py:38",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


# ----------------------------------------------------------------------
# phase 5: the training path
# ----------------------------------------------------------------------
TRAIN_STEPS = 4


def train_path(torch, np):
    """``launch.train.run`` at full width with the detectors on; the
    training kernels' launch counts are set to 0 just before and read
    just after. Returns the launches."""
    import math
    import repro_torch.kernels.flash_attention as fa
    import repro_torch.kernels.rmsnorm as rn
    import repro_torch.kernels.silent_compare as sc
    from repro_torch.configs import registry
    from repro_torch.launch.train import run

    cfg = registry.get_config("qwen3-1.7b")
    counters = (fa.flash_attention_forward, fa.flash_attention_backward,
                sc.silent_compare, rn.rmsnorm_forward, rn.rmsnorm_backward)
    for c in counters:
        c.launches = 0
    fa.flash_attention_forward.copies = 0
    fa.flash_attention_backward.copies = 0
    t0 = time.perf_counter()
    losses, merged = run("qwen3-1.7b", smoke=False, steps=TRAIN_STEPS,
                         batch=TB, seq=TSEQ, profile=True, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fa.flash_attention_forward.launches,
                "flash_attention_bwd": fa.flash_attention_backward.launches,
                "silent_compare": sc.silent_compare.launches,
                "rmsnorm_fwd": rn.rmsnorm_forward.launches,
                "rmsnorm_bwd": rn.rmsnorm_backward.launches}
    copies = (fa.flash_attention_forward.copies,
              fa.flash_attention_backward.copies)
    checked = merged.checked.get("silent_param_store", 0)
    print(f"[train] flash attention alignment copies (forward, backward) "
          f"on the training path: {copies}", flush=True)
    print(f"[train] qwen3-1.7b full width, {TRAIN_STEPS} steps of {TB} x "
          f"{TSEQ} tokens, detectors on: {wall:.1f} s including set-up; "
          f"launches {launches}; losses {losses}; profile tiers "
          f"{merged.tiers}, checked {dict(sorted(merged.checked.items()))}, "
          f"flagged {dict(sorted(merged.flagged.items()))}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB",
          flush=True)
    layers = cfg.num_layers
    assert launches["flash_attention_fwd"] == layers * TRAIN_STEPS, launches
    assert launches["flash_attention_bwd"] == layers * TRAIN_STEPS, launches
    assert copies == (0, 0), copies
    norms = NORMS_PER_FORWARD * layers + 1
    assert launches["rmsnorm_fwd"] == norms * TRAIN_STEPS, launches
    assert launches["rmsnorm_bwd"] == norms * TRAIN_STEPS, launches
    assert launches["silent_compare"] == checked > 0, (launches, checked)
    assert all(math.isfinite(x) for x in losses), losses
    assert abs(losses[0] - math.log(cfg.padded_vocab)) < 3.0, losses
    assert merged.tiers == [3], merged.tiers
    assert merged.checked.get("silent_data_load") == 2 * TRAIN_STEPS
    return launches


def _train_loop(torch, state, step_fn, det, batches, dev):
    """One driver step, as ``launch.train.run`` takes it: host batch to
    the detectors, batch to the device, the step, the detectors on the
    params before and after. Returns (state, metrics)."""
    import itertools
    for step in itertools.count():
        b = next(batches)
        det.on_batch(step, b)
        before = state.params
        state, metrics = step_fn(
            state, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
        det.on_step(step, before, state.params)
        del before
        yield state, metrics


def train_timing_and_trace(torch, np):
    """Train tokens/s with the detectors on, full width: a first step
    (warm-up, untimed), then steps timed on the host clock, each ending
    in a device synchronization; then one step under torch.profiler
    (device time by kernel kind, device busy share)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import registry
    from repro_torch.configs.base import ProfilerConfig, TrainConfig
    from repro_torch.core.detectors import TrainingDetectors
    from repro_torch.data.synthetic import stream
    from repro_torch.models.zoo import build_model
    from repro_torch.train import state as TS
    from repro_torch.train.step import make_train_step

    cfg = registry.get_config("qwen3-1.7b")
    model = build_model(cfg)
    tc = TrainConfig(learning_rate=3e-4, total_steps=8, warmup_steps=1,
                     remat="none")
    state = TS.create(model, 0, device="cuda")
    det = TrainingDetectors(ProfilerConfig(enabled=True))
    loop = _train_loop(torch, state, make_train_step(model, tc), det,
                       stream(cfg, TB, TSEQ, seed=0), "cuda")
    state, m = next(loop)
    float(m["loss"])
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = next(loop)
        float(m["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    tok = TB * TSEQ
    print(f"[train] timed steps (detectors on): "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms = "
          f"{', '.join(f'{tok / t:.1f}' for t in times)} tok/s", flush=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = next(loop)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_trace(torch, prof, "train step", wall_ms)
    del loop, state, m
    torch.cuda.empty_cache()
    return times


def train_smoke_check(torch, np):
    """The smoke config in float32: 4 train steps with the detectors on,
    kernels on the card against plain versions on the CPU, from the same
    state and batches. Losses and grad norms within 1e-4 relative (the
    same f32 arithmetic in other summation orders, moved through 4 Adam
    steps), detector findings and counters equal."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.configs.base import ProfilerConfig, TrainConfig
    from repro_torch.core.detectors import TrainingDetectors
    from repro_torch.data.synthetic import stream
    from repro_torch.models.params import tree_map
    from repro_torch.models.zoo import build_model
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train import state as TS
    from repro_torch.train.step import make_train_step

    cfg = dataclasses.replace(registry.get_config("qwen3-1.7b").smoke(),
                              dtype="float32")
    model = build_model(cfg)
    tc = TrainConfig(learning_rate=3e-4, total_steps=TRAIN_STEPS,
                     warmup_steps=1, remat="none")
    s0 = TS.create(model, 0, compute_dtype=torch.float32, device="cpu")
    results = {}
    for dev in ("cpu", "cuda"):
        def move(tree):
            return tree_map(lambda t: t.to(dev, copy=True), tree)
        state = TS.TrainState(params=move(s0.params), master=move(s0.master),
                              opt=AdamWState(m=move(s0.opt.m),
                                             v=move(s0.opt.v)),
                              step=s0.step.to(dev))
        det = TrainingDetectors(ProfilerConfig(enabled=True))
        loop = _train_loop(torch, state, make_train_step(model, tc), det,
                           stream(cfg, 4, 64, seed=0), dev)
        rows = []
        for _ in range(TRAIN_STEPS):
            state, m = next(loop)
            rows.append((float(m["loss"]), float(m["grad_norm"])))
        rep = det.report
        results[dev] = (np.array(rows),
                        sorted((f.kind, f.c1, f.step) for f in rep.findings),
                        dict(rep.checked), dict(rep.flagged))
    (rc, fc, cc, gc), (rg, fg, cg, gg) = results["cpu"], results["cuda"]
    rel = float(np.max(np.abs(rg - rc) / np.abs(rc)))
    same = (fc, cc, gc) == (fg, cg, gg)
    print(f"[check] smoke f32 training, kernels on the card vs plain on the "
          f"CPU: losses {rg[:, 0].tolist()} vs {rc[:, 0].tolist()}, max "
          f"relative difference of loss and grad norm {rel:.3e} (tol 1e-4); "
          f"detector findings and counters equal {same} (checked {cg})",
          flush=True)
    assert rel <= 1e-4 and same, results


# ----------------------------------------------------------------------
# phase 3: the main path
# ----------------------------------------------------------------------
def dup_prefix_requests(np, vocab, Request, *, n, shared_len, tails,
                        gens):
    """More requests than slots, arriving in threes so that slots
    recycle. The first prompt is a prefix of `shared_len` tokens, the
    others extend it with random tails: reusing the whole first prompt
    maps a partial page, which is copied on write."""
    rng = np.random.default_rng(1)
    shared = rng.integers(0, vocab, size=shared_len).astype(np.int32)
    reqs = []
    for i in range(n):
        tail = rng.integers(1, vocab, size=int(rng.integers(*tails)) if i
                            else 0)
        reqs.append(Request(rid=f"d{i}",
                            tokens=np.concatenate([shared,
                                                   tail.astype(np.int32)]),
                            max_new_tokens=int(rng.integers(*gens)),
                            arrival=i // 3))
    return reqs


def main_path(torch, np):
    import repro_torch.kernels.flash_prefill as fp
    import repro_torch.kernels.paged_attention as pa
    import repro_torch.kernels.rmsnorm as rn
    from repro_torch.configs import registry
    from repro_torch.configs.base import ProfilerConfig
    from repro_torch.core.detectors import ServingDetectors
    from repro_torch.launch.serve import run
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = registry.get_config("qwen3-1.7b")
    layers = cfg.num_layers
    norms = NORMS_PER_FORWARD * layers + 1

    pa.paged_decode_attention.launches = 0
    fp.paged_window_attention.launches = 0
    rn.rmsnorm_forward.launches = 0
    t0 = time.perf_counter()
    out, merged, stats = run("qwen3-1.7b", smoke=False, kv="paged",
                             profile=True, batch=8, prompt_len=128, gen=32,
                             device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode": pa.paged_decode_attention.launches,
                "paged_window": fp.paged_window_attention.launches,
                "rmsnorm_fwd": rn.rmsnorm_forward.launches}
    print(f"[main] qwen3-1.7b full width, paged, profile: {wall:.1f} s; "
          f"launches {launches}; ticks {stats['ticks']}, prefills "
          f"{stats['prefills']}; prefill {stats['prefill_tok_s']:.1f} tok/s, "
          f"decode {stats['decode_tok_s']:.1f} tok/s", flush=True)
    assert launches["paged_decode"] == layers * stats["ticks"] > 0, launches
    assert launches["paged_window"] == layers * stats["prefills"] > 0, launches
    assert launches["rmsnorm_fwd"] == norms * (stats["ticks"]
                                               + stats["prefills"]), launches
    assert out.shape == (8, 32) and ((out >= 0) & (out < cfg.vocab_size)).all()
    assert 3 in merged.tiers and 4 in merged.tiers, merged.tiers
    assert merged.checked.get("kernel_dead_store", 0) > 0

    # duplicated-prefix traffic through one engine with kernel counters
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    det = ServingDetectors(ProfilerConfig(enabled=True, seed=0))
    eng = ServeEngine(model, params, num_slots=8, max_len=MAX_LEN,
                      detectors=det, kv_dtype=torch.float32,
                      kv_layout="paged", page_size=PS, kernel_counters=True)
    # the 72-token shared prefix is 4.5 pages
    for r in dup_prefix_requests(np, cfg.vocab_size, Request, n=12,
                                 shared_len=72, tails=(8, 40), gens=(4, 12)):
        eng.submit(r)
    pa.paged_decode_attention.launches = 0
    fp.paged_window_attention.launches = 0
    rn.rmsnorm_forward.launches = 0
    eng.run(max_steps=500)
    st = eng.stats
    prof = det.combined()
    print(f"[main] duplicated-prefix engine: {len(eng.finished)} requests, "
          f"prefix hits {st['prefix_hits']} ({st['prefix_hit_tokens']} "
          f"tokens), COW copies {st['cow_copies']}, pages freed "
          f"{st['pages_freed']}, ticks {st['ticks']}, prefills "
          f"{st['prefills']}, launches decode "
          f"{pa.paged_decode_attention.launches} window "
          f"{fp.paged_window_attention.launches}; profile tiers "
          f"{prof.tiers}, checked {dict(sorted(prof.checked.items()))}, "
          f"flagged {dict(sorted(prof.flagged.items()))}", flush=True)
    assert len(eng.finished) == 12
    assert st["prefix_hits"] >= 1 and st["cow_copies"] >= 1
    assert pa.paged_decode_attention.launches == layers * st["ticks"]
    assert fp.paged_window_attention.launches == layers * st["prefills"]
    assert rn.rmsnorm_forward.launches == norms * (st["ticks"]
                                                   + st["prefills"])
    assert prof.tiers == [3, 4] and prof.checked["kernel_dead_store"] > 0
    assert sum(prof.checked.get(k, 0) for k in
               ("dead_kv_store", "silent_kv_store", "silent_prefix_load")) > 0
    trace_steps(torch, np, eng, cfg.vocab_size, Request)
    del eng, params, model
    torch.cuda.empty_cache()
    return launches, stats


def _kernel_kind(name: str) -> str:
    if "paged_decode_split_kernel" in name:
        return "paged_decode"
    if any(k in name for k in ("window_split_kernel", "window_tc_kernel",
                               "window_attn_kernel")):
        return "paged_window"
    if "flash_fwd" in name:
        return "flash_attention_fwd"
    if "flash_bwd_" in name or "flash_delta" in name:
        return "flash_attention_bwd"
    if "silent_count_kernel" in name:
        return "silent_compare"
    if "rmsnorm_fwd_kernel" in name:
        return "rmsnorm_fwd"
    if "rmsnorm_bwd_kernel" in name:
        return "rmsnorm_bwd"
    if any(s in name for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul"
    if "copy" in name:
        return "cast/copy"
    return "other"


def trace_steps(torch, np, eng, vocab, Request):
    """Where a full-width engine step spends its time: torch.profiler over
    one admission step (prefill of 8 x 128 tokens and the first tick) and
    one decode tick of 8 live slots; device time by kernel kind, and the
    device's busy share of the step's wall time (profiled)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(2)
    for i in range(8):
        eng.submit(Request(rid=f"t{i}", max_new_tokens=8, tokens=rng.integers(
            0, vocab, size=128).astype(np.int32)))
    for label in ("admission step", "decode tick"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        report_trace(torch, prof, label, wall_ms)


def report_trace(torch, prof, label, wall_ms):
    """Device time by kernel kind, kernel count and the device's busy
    share of a profiled step's wall time."""
    kinds, others, n = {}, {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += 1
            k = _kernel_kind(e.name)
            ms = e.time_range.elapsed_us() / 1e3
            kinds[k] = kinds.get(k, 0.0) + ms
            if k == "other":
                others[e.name[:70]] = others.get(e.name[:70], 0.0) + ms
    if not n:
        print(f"[trace] {label}: the profiler saw no device kernels; "
              f"device time not measured (wall {wall_ms:.2f} ms)")
        return
    busy = sum(kinds.values())
    parts = ", ".join(f"{k} {v:.3f} ms" for k, v in
                      sorted(kinds.items(), key=lambda kv: -kv[1]))
    print(f"[trace] {label}: wall {wall_ms:.2f} ms (profiled), {n} "
          f"kernels, device busy {busy:.3f} ms = "
          f"{busy / wall_ms:.3f} of wall; {parts}", flush=True)
    top = sorted(others.items(), key=lambda kv: -kv[1])[:5]
    print(f"[trace] {label}: largest kernels of 'other': "
          + "; ".join(f"{name} {ms:.3f} ms" for name, ms in top), flush=True)


# ----------------------------------------------------------------------
# phase 3b: the speculative-verify path
# ----------------------------------------------------------------------
SPEC_K = 4


def spec_path(torch, np):
    """``launch.serve.run --spec on --draft ngram`` at full width, with
    rollback and with overwrite; the serving kernels' launch counts are
    set to 0 just before each run and read just after. Returns the
    launches per run."""
    import repro_torch.kernels.flash_prefill as fp
    import repro_torch.kernels.paged_attention as pa
    import repro_torch.kernels.rmsnorm as rn
    from repro_torch.configs import registry
    from repro_torch.launch.serve import run

    cfg = registry.get_config("qwen3-1.7b")
    layers = cfg.num_layers
    norms = NORMS_PER_FORWARD * layers + 1
    counters = {"paged_decode": pa.paged_decode_attention,
                "paged_window": fp.paged_window_attention,
                "rmsnorm_fwd": rn.rmsnorm_forward}
    by_run = {}
    for rollback in (True, False):
        mode = "rollback" if rollback else "overwrite"
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        out, merged, stats = run("qwen3-1.7b", smoke=False, kv="paged",
                                 profile=True, batch=8, prompt_len=128,
                                 gen=32, spec=True, spec_k=SPEC_K,
                                 draft="ngram", spec_rollback=rollback,
                                 device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        forwards = stats["prefills"] + stats["spec_ticks"]
        rejected = stats["draft_proposed"] - stats["draft_accepted"]
        checked = merged.checked.get("kernel_rejected_draft_store", 0)
        flagged = merged.flagged.get("kernel_rejected_draft_store", 0)
        print(f"[spec] qwen3-1.7b full width, paged, ngram drafts, {mode}: "
              f"{wall:.1f} s; launches {launches}; verify ticks "
              f"{stats['spec_ticks']}, prefills {stats['prefills']}; "
              f"drafts accepted {stats['draft_accepted']} of "
              f"{stats['draft_proposed']} (accept rate "
              f"{stats['accept_rate']:.4f}); verify "
              f"{stats['verify_tok_s']:.1f} tok/s over verified positions, "
              f"decode {stats['decode_tok_s']:.1f} tok/s over emitted "
              f"tokens, prefill {stats['prefill_tok_s']:.1f} tok/s; "
              f"kernel_rejected_draft_store {flagged} of {checked} "
              f"(rejected drafts {rejected}); tier-3 rejected_draft_store "
              f"{merged.flagged.get('rejected_draft_store', 0)} of "
              f"{merged.checked.get('rejected_draft_store', 0)}",
              flush=True)
        assert stats["ticks"] == stats["spec_ticks"] > 0, stats
        assert launches["paged_decode"] == 0, launches
        assert launches["paged_window"] == layers * forwards, launches
        assert launches["rmsnorm_fwd"] == norms * forwards, launches
        assert out.shape == (8, 32) and ((out >= 0)
                                         & (out < cfg.vocab_size)).all()
        assert checked == stats["draft_proposed"] > 0, (checked, stats)
        assert flagged == (0 if rollback else rejected), (flagged, rejected)
        by_run[f"spec {mode}"] = launches
    trace_verify_tick(torch, np, cfg)
    return by_run


def trace_verify_tick(torch, np, cfg):
    """torch.profiler over one verify tick at full width (8 live slots,
    n-gram drafts, rollback, detectors and kernel counters on, as the
    spec path runs), after an admission step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import ProfilerConfig
    from repro_torch.core.detectors import ServingDetectors
    from repro_torch.data.synthetic import batch_at
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.spec import NGramDrafter

    model = build_model(cfg)
    params = model.init(0, device="cuda")
    eng = ServeEngine(model, params, num_slots=8, max_len=MAX_LEN,
                      detectors=ServingDetectors(ProfilerConfig(
                          enabled=True, seed=0)),
                      kv_dtype=torch.float32, kv_layout="paged",
                      page_size=PS, kernel_counters=True,
                      drafter=NGramDrafter(), spec_k=SPEC_K)
    prompts = batch_at(cfg, 8, 128, seed=0, step=0)["tokens"]
    for b in range(8):
        eng.submit(Request(rid=f"v{b}", tokens=np.asarray(prompts[b]),
                           max_new_tokens=32))
    # admission and the first ticks: the continuations start to repeat,
    # so the n-gram drafter proposes in the traced tick
    for _ in range(4):
        eng.step()
    before = dict(eng.stats)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    delta = {k: eng.stats[k] - before[k] for k in
             ("prefills", "spec_ticks", "draft_proposed", "draft_accepted")}
    print(f"[trace] verify tick: {delta}", flush=True)
    assert delta["prefills"] == 0 and delta["spec_ticks"] == 1, delta
    report_trace(torch, prof, "verify tick", wall_ms)
    del eng, params, model
    torch.cuda.empty_cache()


def spec_smoke_check(torch, np):
    """The smoke config in float32 on the card and on the CPU, the same
    weights: in every spec mode (paged rollback, paged overwrite, dense)
    the replayed plain continuations are all accepted and give plain
    decode's tokens (a W-row verify window through the window kernel
    picks what one-row decode through the decode kernel picked), and the
    n-gram runs give plain decode's tokens with the same spec counters
    on the card as on the CPU."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models.params import tree_map
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.spec import NGramDrafter, ReplayDrafter

    cfg = dataclasses.replace(registry.get_config("qwen3-1.7b").smoke(),
                              dtype="float32")
    model = build_model(cfg)
    cpu_params = model.init(0, device="cpu")

    def serve(params, kv, drafter=None, rollback=True):
        eng = ServeEngine(model, params, num_slots=3, max_len=48,
                          kv_dtype=torch.float32, kv_layout=kv, page_size=4,
                          drafter=drafter, spec_k=SPEC_K,
                          spec_rollback=rollback)
        reqs = dup_prefix_requests(np, cfg.vocab_size, Request, n=7,
                                   shared_len=10, tails=(2, 12),
                                   gens=(4, 12))
        for r in reqs:
            eng.submit(r)
        eng.run(max_steps=300)
        return ({rid: r.generated for rid, r in eng.finished.items()},
                {r.rid: r.tokens for r in reqs}, eng.stats)

    results = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev), cpu_params)
        for kv, rollback in (("paged", True), ("paged", False),
                             ("dense", False)):
            plain, prompts, _ = serve(params, kv)
            oracle = ReplayDrafter([np.concatenate(
                [prompts[rid], np.asarray(toks, np.int32)])
                for rid, toks in plain.items()])
            got, _, st = serve(params, kv, oracle, rollback)
            assert got == plain, (dev, kv, rollback)
            assert st["draft_accepted"] == st["draft_proposed"] > 0, st
            got, _, st = serve(params, kv, NGramDrafter(), rollback)
            assert got == plain, (dev, kv, rollback)
            results[(dev, kv, rollback)] = (got, {
                k: st[k] for k in ("spec_ticks", "draft_proposed",
                                   "draft_accepted", "verified_positions")})
    same = all(results[("cpu",) + key[1:]] == results[key]
               for key in results if key[0] == "cuda")
    print(f"[check] smoke f32 spec: the oracle accepts every draft and "
          f"gives plain decode's tokens on the card and on the CPU in "
          f"paged rollback, paged overwrite and dense; n-gram tokens and "
          f"spec counters on the card equal the CPU's {same} ("
          + "; ".join(f"{kv}/{'rollback' if rb else 'overwrite'}: "
                      f"{st['draft_accepted']} of {st['draft_proposed']} "
                      f"accepted" for (dev, kv, rb), (_, st)
                      in results.items() if dev == "cuda") + ")",
          flush=True)
    assert same, results


def small_reference_check(torch, np):
    """The smoke config in float32 through the engine on the card
    (kernels) and on the CPU (plain versions), with the same weights:
    greedy tokens, stats and stored/dropped counts must be equal."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.configs.base import ProfilerConfig
    from repro_torch.core.detectors import ServingDetectors
    from repro_torch.models.params import tree_map
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(registry.get_config("qwen3-1.7b").smoke(),
                              dtype="float32")
    model = build_model(cfg)
    cpu_params = model.init(0, device="cpu")
    results = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev), cpu_params)
        det = ServingDetectors(ProfilerConfig(enabled=True, seed=0))
        eng = ServeEngine(model, params, num_slots=3, max_len=48,
                          detectors=det, kv_dtype=torch.float32,
                          kv_layout="paged", page_size=4,
                          kernel_counters=True)
        for r in dup_prefix_requests(np, cfg.vocab_size, Request, n=7,
                                     shared_len=10, tails=(2, 12),
                                     gens=(2, 8)):
            eng.submit(r)
        eng.run(max_steps=300)
        toks = {rid: r.generated for rid, r in eng.finished.items()}
        stats = {k: v for k, v in eng.stats.items() if not k.endswith("_s")}
        k = det.kernel
        counts = (k.checked["kernel_silent_store"],
                  k.flagged.get("kernel_dead_store", 0))
        results[dev] = (toks, stats, counts)
    same = results["cpu"] == results["cuda"]
    print(f"[check] smoke f32 engine, kernels on the card vs plain on the "
          f"CPU: tokens, stats, stored and dropped counts equal {same} "
          f"(stored {results['cuda'][2][0]}, dropped {results['cuda'][2][1]}, "
          f"prefix hits {results['cuda'][1]['prefix_hits']})", flush=True)
    assert same, (results["cpu"], results["cuda"])


def kernel_label(mangled: str) -> str:
    """A kernel's readable name and template arguments (element types,
    then numbers) from its mangled name: ``window_split_kernel<bf16,f32,4>``
    (activations bf16, pool f32, 4 elements a lane)."""
    import re
    m = re.search(r"([a-z_]+_kernel)I(.*)", mangled)
    if m is None:
        return mangled
    # a type, a substitution (S<n>_: a repeat of the type before, the only
    # repeated component of these names) or an integer
    tok = re.compile(r"f|13__nv_bfloat16|S\d*_|Li(\d+)E")
    args, rest = [], m.group(2)
    while rest and not rest.startswith("E"):
        t = tok.match(rest)
        if t is None:
            break
        w = t.group(0)
        args.append("f32" if w == "f" else "bf16" if w[0] == "1" else
                    args[-1] if w[0] == "S" else t.group(1))
        rest = rest[t.end():]
    return f"{m.group(1)}<{','.join(args)}>"


def sass_hmma(lib):
    """Tensor-core (HMMA) instructions per kernel of a built library, from
    ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts = {}
    for sec in sass.split("Function : ")[1:]:
        counts[kernel_label(sec.split("\n", 1)[0].strip())] = sec.count(
            "HMMA")
    return counts


def build_kernels():
    """Build the CUDA kernels (one nvcc per source, in parallel), printing
    the build time, each kernel's registers and spills (ptxas) and the
    tensor-core kernels' HMMA instructions (cuobjdump)."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build()
    print(f"[build] {len(logs)} CUDA sources compiled for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = kernel_label(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                print(f"[build] {name}: {fn}: {line.strip()}")
    for name in ("flash_attention", "paged_window"):
        hmma = sass_hmma(build.library_path(name))
        print(f"[build] {name} HMMA instructions per kernel (cuobjdump "
              f"-sass): " + ("not measured (no cuobjdump)" if hmma is None
                             else ", ".join(f"{k} {n}" for k, n
                                            in sorted(hmma.items()))),
              flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()
    nvcc_v = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                            text=True, check=True).stdout.strip().splitlines()
    print(f"[card] {card} | torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {nvcc_v[-1]}", flush=True)
    build_kernels()

    timer = Timer(torch)
    entries = check_kernels(torch, np, timer)
    entries.update(check_rmsnorm(torch, timer))
    entries.update(check_flash(torch, timer))
    entries["silent_compare"] = check_silent(torch, timer)
    # each main path is driven with the launch counts set to 0 just
    # before it and read just after
    by_path = {}
    by_path["serve"], stats = main_path(torch, np)
    small_reference_check(torch, np)
    by_path.update(spec_path(torch, np))
    spec_smoke_check(torch, np)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    by_path["train"] = train_path(torch, np)
    train_timing_and_trace(torch, np)
    train_smoke_check(torch, np)

    import math
    for key, e in entries.items():
        per = {path: n[key] for path, n in by_path.items() if key in n}
        e["launches"] = sum(per.values())
        e["launches_by_path"] = per
        bad = [k for k, v in e.items() if isinstance(v, float)
               and not math.isfinite(v)]
        assert not bad, f"{key}: not measured: {bad}"
    print(json.dumps({"kernels": [entries[k] for k in (
        "paged_decode", "paged_window", "flash_attention_fwd",
        "flash_attention_bwd", "silent_compare", "rmsnorm_fwd",
        "rmsnorm_bwd")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
