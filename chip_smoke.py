#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one
NVIDIA GPU: the serving path, the speculative-verify serving path and
the training path of qwen3-1.7b, granite-moe-3b-a800m's serving and
training, and the serving and training of zamba2-1.2b (the hybrid
family), xlstm-1.3b (the ssm family) and whisper-large-v3 (the audio
family).

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit), the torch, CUDA
   and nvcc versions, and builds the hand-written CUDA kernels from
   ``src/repro_torch/csrc`` (timed; ptxas registers and spills per
   kernel, the HMMA instructions of the flash attention and paged
   window kernels and the global stores of B5's forward kernels from
   cuobjdump);
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
   then the RMSNorm forward and backward (CUDA) against their plain
   versions at every norm shape of the three paths and on every route
   of both, in each x/scale dtype pair, with rows read by stride (out
   within 1e-5 relative at float32 and 2e-2 at bfloat16, rstd within
   1e-5; dx and dscale within 2e-4 / 3e-2 of the plain gradient's
   largest magnitude; two calls bit-identical each way, dscale equal bit
   for bit to the blocked plain version on the kernel's plan), timed at
   the three training norms beside ``torch.nn.functional.rms_norm`` (the
   library yardstick) by device time from CUPTI, CUDA-event times
   printed beside it, with one launch a call each way and its grid read
   from the trace, the backward's blocks an SM swept over 1-8 and the
   forward's rows a block over 1-64, an empty kernel's device time on
   the forward's grid (the launch floor), and the host's part of a call
   (the median of three loops of 1000 back-to-back calls: the forward,
   its ctypes launch and its allocation apart, the backward,
   ``F.rms_norm``);
   then B1 and B2 at granite-moe-3b-a800m's heads (Hq 24, Hkv 8, D 64:
   G 3, so a kv group's rows leave a slack row in the split kernel's
   4-row block and in the tensor-core route's 64 stacked rows) on the
   hostile tables in every dtype pair, B2 through the route it picks and
   through every route that takes the inputs, two calls bit-identical,
   and their main-path calls timed; and B5 at width 1536 (decode,
   verify and prefill rows, strided rows, every dtype pair), its
   forward timed beside ``F.rms_norm``; and B5's forward at qwen3's
   serving shapes (decode 8 x 2048, prefill 1024 x 2048, the q- and
   k-norms of both) timed beside ``F.rms_norm`` with its grid from the
   trace and the empty launch's floor, swept over rows a block at the
   prefill rows, its host path measured at the decode rows;
3. runs the main path at full width: ``repro_torch.launch.serve.run``
   for qwen3-1.7b with the paged KV heap and the profiler on (random
   weights from seed 0, 28 layers), with the kernels' launch counts set
   to 0 just before and read just after; then one engine with kernel
   counters on duplicated-prefix traffic (prefix hits, copy-on-write,
   slot recycling, history in the window kernel); and checks the
   results: launches per layer and step (RMSNorm: 113 a forward, and
   113 more in tier 1's recorded decode microstep), finite tokens in
   range, a merged profile of tiers 1-4 (tier 1's seconds printed for
   each run of phases 3-3c), and, on the smoke config in float32, the
   same greedy tokens
   and store counts from the kernels on the card as from the plain
   versions on the CPU; and traces one admission step, one decode tick
   and one verify tick at full width with torch.profiler (device time by
   kernel kind, device busy share), each trace opened by untimed spin
   kernels and its B1, B2 and B5 kernels equal to the launch counters;
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
3c. runs granite-moe-3b-a800m (the MoE family: 32 layers, d_model 1536,
   40 experts top-8) at full width through ``launch.serve.run``: paged,
   profile on, batch 8, prompt 128 + 32, twice (equal tokens; the second
   without the profiler), then with
   n-gram drafts under rollback and overwrite, launch counts set to 0
   before each run (32 B1 or B2 and 65 RMSNorm launches a forward); the
   dispatch buffer's dead rows of every MoE layer of an admission step,
   a decode tick and a verify tick (0 under scatter); one traced
   admission step, decode tick and verify tick (kernels by kind, read
   from the trace: the same launches); and granite's smoke config in
   float32, as is (G 2) and at Hq 6, Hkv 2 (G 3), the card against the
   CPU: tokens, stats, spec counters and tier-3/4 findings equal;
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
   and detector findings of the plain versions on the CPU; then one
   full-width train step under remat "none", "full" and "dots" from the
   same state, each mode run only when its reckoned bytes fit the card
   (``reckon_step_bytes``): loss and grad norm bit for bit equal, the
   recomputed forwards' launches counted (B4 28 + 28, B5 113 + 112 a
   step), peak device memory of each beside its reckoning; the traced
   train step's kernels equal to the launch counters;
6. runs tier 1 (``core/interpreter.py``, the concrete-run recorder) on
   the card: the tier-1 corpus programs (linear search, loop-invariant
   recompute, dead stores, the clean chain, FP drift) on CUDA tensors,
   each profile equal to the CPU's; the decode microstep of qwen3-1.7b's
   smoke config in float32, card against CPU (totals, samples and checked
   counts equal; flagged counts equal or each difference printed with
   its pair); and the decode microstep at full width (batch 8, cache
   161, period 5000, 2 epochs, as ``launch.serve --profile`` runs it):
   recorded operations, events and element-events, B5 launches in the
   recording (113) and in the engine's passes (0), bytes snapshotted,
   the seconds of the recording and of each pass, peak device memory
   with the trace held and after it is dropped, the top findings;
7. trains granite-moe-3b-a800m at full width (32 layers, 40 experts
   top-8): first B4 at its heads (Hq 24, Hkv 8, D 64: G 3) and B5 at
   4096 x 1536 against their plain versions and timed (phase 7a, run
   with 8a before the main paths); one step under each remat mode that
   fits (bit-equal, peaks beside the reckoning); ``launch.train.run``, 4
   steps of 4 x 1024 tokens with the detectors on (32 + 32 B4 and 65 +
   65 B5 launches a step, one B3 per checked store); timed steps and a
   traced step; the smoke config in float32, card against CPU;
8. runs zamba2-1.2b (38 Mamba2 blocks, one shared attention block used
   6 times) at full width: B4 at its heads (32, 32, 64: G 1) and B5 at
   4096 x 4096 (the gate norm, the backward's widest wide-route row)
   and 4104 against their plain versions (8a); ``launch.serve.run`` (the
   token-loop driver, profile on, batch 8, prompt 128 + 32) twice (the
   second without the profiler), equal
   tokens, 89 B5 launches a step, tier 1's line, prefill and decode
   tok/s, one decode step traced; the smoke config (8 layers) in float32,
   the card's tokens and tier-1 totals equal to the CPU's; then training
   as in 7 (6 + 6 B4 and 89 + 89 B5 launches a step);
9. runs xlstm-1.3b (42 mLSTM and 6 sLSTM blocks, d_model 2048) at full
   width: B5 at its decode and training rows at widths 2048 and 4096
   against its plain version and timed (9a, run with 10a before the
   main paths); ``launch.serve.run`` (token loop, profile on, batch 8,
   prompt 128 + 32) twice, equal tokens, 97 B5 launches a forward and
   none of B4, one decode step traced; tier 1 on its decode microstep
   as in 6c (the mLSTM states snapshotted before their in-place
   writes); the smoke config in float32, tokens and tier-1 totals card
   = CPU; training as in 7 (97 + 97 B5, no B4), last of all, with 2
   driver steps and one timed step (a step is ~22 s, host-bound by the
   sLSTM's token loop), the smoke check's card steps each from the
   CPU's state;
10. runs whisper-large-v3 (32 encoder and 32 decoder layers, d_model
   1280, 20 heads of 64) at full width: B4 at its heads (G 1, D 64)
   non-causal 1024 x 1024 and causal 1024 in both dtypes, two calls
   bit-identical, timed beside SDPA, and ragged non-causal cases (1024
   queries over 1500 frames, tier 1's one query over 128), B5 at 1280
   (10a); ``launch.serve.run`` twice as in 9 (65 B5 launches in the
   encoder, 97 a decode forward; B4 only in tier 1's cache and
   microstep, which the reference builds from unmasked frames); frames
   of (8, 1500, 1280) bucketed (extent 1024) against capacity (1500):
   equal greedy tokens, the largest logit difference printed; the smoke
   config in float32, card = CPU; training as in 7 (96 + 96 B4, 162 +
   162 B5, no alignment copy).

Each phase prints its seconds (``[phase]`` lines). The line before the
last lists the card; the last line is the JSON
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
        launch path, which can exceed a small kernel's device time."""
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
            timed = [e for e in evs if e.name not in self.flush_names]
            us = sum(e.time_range.elapsed_us() for e in timed)
            # every call launches the same kernels: a count that is not a
            # multiple of the calls means the trace missed some
            if us > 0 and flushes >= iters and len(timed) % iters == 0:
                return us / iters / 1e3
            print(f"[timer] retaking a trace: {flushes} flushes of "
                  f"{iters} seen, {len(timed)} other kernels for {iters} "
                  f"calls", flush=True)
            self.flush_names = set()
        return float("nan")     # not measured


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------
B, HQ, HKV, D, PS = 8, 16, 8, 128, 16
QWEN3_HEADS = (HQ, HKV, D)                # (Hq, Hkv, D) of qwen3-1.7b
GRANITE = "granite-moe-3b-a800m"
GRANITE_HEADS = (24, 8, 64)               # G 3, D 64
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


def kernel_cases(np, sizes=(2, 3, 8, 9, 32, 33, 128)):
    """(name, S, idx, store) cases at the main path's shapes; windows of
    ``sizes`` rows."""
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
    for S in sizes:
        w = np.array([0, 72, 32, 140, 17, 0, 9, -(S + 1)], np.int32)
        w = np.minimum(w, MAX_LEN - S)
        w[-1] = -(S + 1)
        cases += [(f"window S={S} store", S, w, True),
                  (f"window S={S} defer", S, w, False)]
    return cases


def bytes_flops(np, name, S, idx, pt, store, act_isz, pool_isz,
                heads=QWEN3_HEADS):
    """Least bytes moved and flops done by one call on these inputs: each
    input read once, each output written once, history counted as the
    mapped rows the call attends, stores as the rows that land."""
    HQ, HKV, D = heads
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
             pages=P, route=None, heads=QWEN3_HEADS):
    """Build one case's inputs on the card (a pool of ``pages`` pages,
    ``heads`` = (Hq, Hkv, D)), run the kernel twice and its plain version
    once on copies of the pools, check the two kernel calls bit for bit
    against each other and the kernel against the plain version, and
    print the result. ``route`` forces a route of the window kernel
    (``flash_prefill.ROUTES``). Returns (max |err|, kernel, plain,
    inputs)."""
    HQ, HKV, D = heads
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
    if heads != QWEN3_HEADS:
        label = f"{label} G{HQ // HKV} D{D}"
    print(f"[kernels] {label:21s} act {act:8s} pool {pool_dt:8s} "
          f"pools+counters equal {same} | max |err| {err:.3e} "
          f"(tol {TOL[act]}) | idle rows 0 {dead_ok} | two calls "
          f"bit-identical {twice} | counters {c_k.sum(0).tolist()}",
          flush=True)
    if not (same and err <= TOL[act] and dead_ok and twice):
        raise AssertionError(f"{label} ({act}/{pool_dt}) disagrees with its "
                             f"plain version or with itself")
    return err, kernel, plain, (q, kn, vn, pool_k, pool_v, pt, idx)


DTYPE_PAIRS = (("bfloat16", "float32"), ("bfloat16", "bfloat16"),
               ("float32", "float32"))


def check_hostile(torch, np):
    """Phase 2, hostile tables in every dtype pair."""
    rng = np.random.default_rng(0)
    seed = 0
    for act, pool_dt in DTYPE_PAIRS:
        for name, S, idx_np, store in kernel_cases(np):
            seed += 1
            run_case(torch, act, pool_dt, name, S, idx_np,
                     hostile_table(np, rng, idx_np, S), store, seed)


# the main path's kernel calls: (JSON key, case, S, position)
MAIN_CALLS = (("paged_decode", "decode", 1, 144),
              ("paged_window", "window S=128 store", 128, 0),
              ("paged_verify", "verify W=5 defer", 5, 144),
              ("paged_verify", "verify W=5 overwrite", 5, 144))


def time_paged(torch, np, timer, name, S, pos, pt_np, pages, seed,
               heads=QWEN3_HEADS):
    """Check one call on the main path's dtypes (bf16 activations, f32
    pool) with every slot at ``pos``, then time kernel, plain version and
    SDPA over the gathered view by device time (CUPTI, L2 flushed before
    each call), kernel and SDPA also by CUDA events. Returns (max |err|,
    device ms by call, event ms by call, bytes, flops)."""
    idx_np = np.full(B, pos, np.int32)
    store = not name.endswith("defer")
    err, kernel, plain, inputs = run_case(
        torch, "bfloat16", "float32", name, S, idx_np, pt_np, store,
        seed=seed, pages=pages, heads=heads)
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
                                q.element_size(), pool_k.element_size(),
                                heads)
    return err, dev, ev, nbytes, flops


def launch_grids(torch, fn, kinds=("paged_decode", "paged_window")):
    """The kernels of ``kinds`` one call of fn launches, with their grids,
    from the profiler's trace: [(kernel, (x, y, z))]."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_IN):        # a trace can miss its first kernels
            torch.cuda._sleep(100)
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
            and _kernel_kind(e["name"]) in kinds]


def kernel_label_demangled(name: str) -> str:
    """``window_tc_kernel<float, 128>`` from a demangled kernel name."""
    import re
    m = re.search(r"([a-z_]+_kernel<[^(]*>)", name)
    return m.group(1) if m else name


def time_main_calls(torch, np, timer, heads, model):
    """The main path's kernel calls (``MAIN_CALLS``) on the main path's own
    inputs at ``heads`` = (Hq, Hkv, D): checked against the plain version
    (run_case), one launch a call with its grid read from the trace, and
    timed (time_paged). Returns {(JSON key, case): numbers}."""
    HQ, HKV, D = heads
    rng = np.random.default_rng(1)
    nums = {}
    for key, name, S, pos in MAIN_CALLS:
        err, dev, ev, nbytes, flops = time_paged(
            torch, np, timer, name, S, pos, main_path_table(np, rng), P,
            seed=100 + S, heads=heads)
        b_ms, by = bound(nbytes, flops, PEAK_FLOPS["bfloat16"])
        ms = dev["kernel"]
        grids = dev.pop("launches")
        print(f"[kernels] {key} on {model}'s main-path inputs ({name}): "
              f"launches per call {grids}", flush=True)
        # one launch a call (the store rides it); the decode and the
        # verify windows split the history (grid x: splits of the split
        # kernel, grid z: of the tensor-core kernel's one row tile)
        assert len(grids) == 1, grids
        kern, grid = grids[0]
        if S < 128 and grid:
            splits = grid[0] if "split" in kern else grid[2]
            assert splits >= 2, grids
        print(f"[kernels] {key} on {model}'s main-path inputs ({name}, B "
              f"{B}, Hq {HQ}, Hkv {HKV}, D {D}, position {pos}, bf16 act, "
              f"f32 pool), device time: kernel "
              f"{ms:.4f} ms | plain {dev['plain']:.4f} ms | SDPA over the "
              f"gathered view {dev['sdpa']:.4f} ms (kernel / SDPA "
              f"{ms / dev['sdpa']:.2f}) | bound {b_ms:.4f} ms ({by}: "
              f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP; kernel at "
              f"{b_ms / ms:.3f} of it) | CUDA events: kernel "
              f"{ev['kernel']:.4f} ms, SDPA {ev['sdpa']:.4f} ms", flush=True)
        nums[(key, name)] = {
            "max_abs_err": err, "ms": ms, "plain_ms": dev["plain"],
            "bound_ms": b_ms, "bound_by": by, "library_ms": dev["sdpa"],
            "event_ms": ev["kernel"]}
    return nums


def shape_label(model, name):
    """A ``by_shape`` key: the model and the call (``decode``,
    ``prefill``, ``verify W=5 defer`` ...)."""
    return f"{model} {'prefill' if name.startswith('window') else name}"


def check_kernels(torch, np, timer):
    """Phase 2. Hostile tables in every dtype pair, then the main path's
    own inputs (bf16 activations, f32 pool; decode with every slot at
    position 144, prefill of 128 tokens at 0, verify windows of 5 at 144
    in both modes), timed. Returns the kernels' JSON entries (all but
    launches), each call's numbers under ``by_shape``."""
    check_hostile(torch, np)
    nums = time_main_calls(torch, np, timer, QWEN3_HEADS, "qwen3-1.7b")
    entries = {}
    for (key, name), num in nums.items():
        if key == "paged_verify":
            key = "paged_window"          # a mode of paged_window
        e = entries.setdefault(key, {
            "name": key, "route": "cuda",
            "source": f"src/repro_torch/csrc/{key}.cu",
            "replaces": ("src/repro/kernels/paged_attention.py:120"
                         if key == "paged_decode" else
                         "src/repro/kernels/flash_prefill.py:171"),
            "by_shape": {}})
        if "ms" not in e:                 # the decode, the prefill
            e.update(num)
        e["by_shape"][shape_label("qwen3-1.7b", name)] = num
    long_history(torch, np, timer)
    crossover(torch, np, timer)
    return entries


def window_routes(act, heads):
    """The window kernel's routes that take these inputs (route_ok in
    csrc/paged_window.cu): the split (D 64/128 and small D), the tensor
    cores (bf16 activations, G <= 64) and the CUDA cores."""
    routes = ["split", "cuda_core"]
    if act == "bfloat16" and heads[0] // heads[1] <= 64:
        routes.append("tensor_core")
    return routes


# granite's windows: both sides of the routes' thresholds at G 3: the
# split and the tensor cores for bf16 (S * G = 3, 6), the split and the
# CUDA-core kernel for f32 (S * G = 15, 18), the tensor-core kernel with
# history splits (one row tile: S * G = 63, the 64th stacked row slack)
# and without (66), the prefill (7 row tiles of 21)
GRANITE_SIZES = (1, 2, 5, 6, 21, 22, 128)


def check_granite_kernels(torch, np, timer, entries):
    """Phase 2c. B1 and B2 at granite-moe-3b-a800m's heads (Hq 24, Hkv 8,
    D 64: G 3) on hostile tables in every dtype pair, B2 through the
    route it picks and through every route that takes the inputs (forced:
    ``paged_window_on_route``), two calls bit-identical in each; then the
    main path's calls timed as qwen3's, their numbers added to the
    entries' ``by_shape``."""
    rng = np.random.default_rng(10)
    seed = 1000
    for act, pool_dt in DTYPE_PAIRS:
        for name, S, idx_np, store in kernel_cases(np, GRANITE_SIZES):
            seed += 1
            pt_np = hostile_table(np, rng, idx_np, S)
            run_case(torch, act, pool_dt, name, S, idx_np, pt_np, store,
                     seed, heads=GRANITE_HEADS)
            if name == "decode":
                continue
            for route in window_routes(act, GRANITE_HEADS):
                run_case(torch, act, pool_dt, name, S, idx_np, pt_np, store,
                         seed, route=route, heads=GRANITE_HEADS)
    nums = time_main_calls(torch, np, timer, GRANITE_HEADS, GRANITE)
    for (key, name), num in nums.items():
        key = "paged_window" if key == "paged_verify" else key
        entries[key]["by_shape"][shape_label(GRANITE, name)] = num


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
    G = q.shape[2] // kn.shape[2]
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
# rstd: f32 either way, another summation order over up to 4096 squares
RMS_RSTD_TOL = 1e-5
RMS_EPS = 1e-6                            # qwen3's norm_eps
# host-path measurement: back-to-back calls, and the spin (GPU cycles)
# that keeps the device busy while they are enqueued
HOST_CALLS = 1000
HOST_SPIN = 4_000_000


def rms_tol(dtype):
    """(output, gradient) tolerance of an RMSNorm output in ``dtype``:
    float32's, or the 16-bit one (one rounding of the output)."""
    return RMS_TOL["float32" if dtype == "float32" else "bfloat16"]


def host_us(torch, fn, calls=HOST_CALLS, rounds=3):
    """Host time of one call in microseconds: ``calls`` back-to-back
    calls after a warm-up, no synchronisation inside the loop, behind a
    spin kernel that keeps the device busy (the launches queue behind
    it, so no call waits for the device); the median of ``rounds`` such
    loops (the host's cores are shared, and one loop can catch another
    process's burst)."""
    for _ in range(20):
        fn()
    per = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        torch.cuda._sleep(HOST_SPIN)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return sorted(per)[rounds // 2]


def norm_host_path(torch, tag, x, scale, dy, rstd, want_rstd):
    """B5's host path at one shape: the forward wrapper, and the parts
    of it (the ctypes launch alone on prepared arguments, the
    allocation alone), an empty kernel launched the same way, the
    backward wrapper and ``F.rms_norm``, each in microseconds a call
    (``host_us``). Returns {name: us}."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rn
    width = x.shape[-1]
    plan = rn.fwd_plan_for(x, scale)
    t, n, d, xs = rn._rows(x, "x")
    stream = torch.cuda.current_stream().cuda_stream
    y = x.new_empty(x.shape)
    r = x.new_empty(n, dtype=torch.float32) if want_rstd else None
    args = (t.data_ptr(), scale.data_ptr(), y.data_ptr(),
            r.data_ptr() if want_rstd else None, n, xs, RMS_EPS,
            plan.word(d, x.dtype, scale.dtype), stream)
    lib = rn._lib()

    def alloc():                      # as the wrapper allocates
        torch.empty_like(x) if t is x else x.new_empty(x.shape)
        if want_rstd:
            x.new_empty(n, dtype=torch.float32)
    us = {"forward": host_us(torch, lambda: rn.rmsnorm_forward(
              x, scale, RMS_EPS, want_rstd=want_rstd)),
          "ctypes launch": host_us(torch, lambda: lib.rmsnorm_fwd(*args)),
          "allocation": host_us(torch, alloc),
          "empty kernel": host_us(torch, lambda: lib.launch_floor(
              plan.blocks, plan.threads, stream)),
          "backward": host_us(torch, lambda: rn.rmsnorm_backward(
              x, scale, rstd, dy, RMS_EPS)),
          "F.rms_norm": host_us(torch, lambda: F.rms_norm(
              x, (width,), scale, RMS_EPS))}
    rest = us["forward"] - us["ctypes launch"] - us["allocation"]
    print(f"[host] rmsnorm {tag} ({tuple(x.shape)} {str(x.dtype)[6:]}, "
          f"{str(scale.dtype)[6:]} scale{', rstd' if want_rstd else ''}), "
          f"host us a call (median of 3 x {HOST_CALLS} calls, no sync, "
          f"device busy): "
          f"forward {us['forward']:.2f} (= ctypes launch "
          f"{us['ctypes launch']:.2f} + allocation {us['allocation']:.2f} "
          f"+ wrapper Python {rest:.2f}; target <= 15: "
          f"{us['forward'] <= 15}) | empty kernel by ctypes "
          f"{us['empty kernel']:.2f} | backward {us['backward']:.2f} | "
          f"F.rms_norm {us['F.rms_norm']:.2f}", flush=True)
    return us


def norm_fwd_trace_and_floor(torch, timer, tag, x, scale, want_rstd):
    """The forward's launch read from the trace (one kernel, the plan's
    grid), and the device time of an empty kernel on the same grid and
    block launched the same way (ctypes, current stream): the floor
    under any launch. Returns (plan, floor ms)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm as rn
    plan = rn.fwd_plan_for(x, scale)
    grids = launch_grids(torch, lambda: rn.rmsnorm_forward(
        x, scale, RMS_EPS, want_rstd=want_rstd), ("rmsnorm_fwd",))
    assert len(grids) == 1 and grids[0][1] == (plan.blocks, 1, 1), \
        (tag, grids, plan)
    lib, stream = rn._lib(), torch.cuda.current_stream().cuda_stream
    build.launched(lib.launch_floor(plan.blocks, plan.threads, stream),
                   "empty")
    floor = timer.device(lambda: lib.launch_floor(plan.blocks, plan.threads,
                                                  stream))
    print(f"[kernels] rmsnorm forward {tag}: one call in the trace "
          f"{grids} ({plan.route} route, {plan.blocks} blocks of "
          f"{plan.rows} rows, {plan.threads} threads, {plan.lanes} lanes a "
          f"row) | an empty kernel "
          f"on that grid, device time {floor:.4f} ms", flush=True)
    return plan, floor


def norm_fwd_sweep(torch, timer, tag, x, scale, want_rstd):
    """The forward's device time by rows a block (every power of two its
    route takes), the wrapper's choice marked. Returns {rows: ms}."""
    from repro_torch.kernels import rmsnorm as rn
    chosen = rn.fwd_plan_for(x, scale)
    plans = {}
    for k in (1, 2, 4, 8, 16, 32, 64):
        p = rn.fwd_plan_for(x, scale, k)
        plans.setdefault(p.rows, p)
    sweep = {rows: timer.device(lambda rows=rows: rn.rmsnorm_forward(
        x, scale, RMS_EPS, want_rstd=want_rstd, rows=rows))
        for rows in plans}
    print(f"[kernels] rmsnorm forward {tag} by rows a block (device ms; "
          f"{chosen.rows} on the path): " + ", ".join(
              f"{rows} ({plans[rows].blocks} blocks): {ms:.4f}"
              for rows, ms in sweep.items()), flush=True)
    return sweep


def rmsnorm_case(torch, rows, width, x_dtype, s_dtype, strided, seed):
    """Forward (with rstd) and backward kernels against their plain
    versions on one set of inputs. Returns (max |err| of y, max |err| of
    dx and dscale, relative errors, inputs)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import (fwd_plan_for, plan_for,
                                            rmsnorm_backward,
                                            rmsnorm_forward)
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
    before_f = rmsnorm_forward.launches
    y, rstd = rmsnorm_forward(x, scale, RMS_EPS, want_rstd=True)
    y2, rstd2 = rmsnorm_forward(x, scale, RMS_EPS, want_rstd=True)
    assert rmsnorm_forward.launches == before_f + 2
    fplan = fwd_plan_for(x, scale)
    before = rmsnorm_backward.launches
    dx, ds = rmsnorm_backward(x, scale, rstd, dy, RMS_EPS)
    dx2, ds2 = rmsnorm_backward(x, scale, rstd, dy, RMS_EPS)
    plan = plan_for(x, dy)
    _, blocked_ds = ref.rmsnorm_bwd_blocked(
        x, scale, rstd, dy, blocks=plan.blocks, workers=plan.workers,
        group=plan.group)
    want = ref.rmsnorm_ref(x, scale, RMS_EPS)
    want_dx, want_ds = ref.rmsnorm_bwd_ref(x, scale, dy, RMS_EPS)
    want_rstd = torch.rsqrt(x.float().square().mean(-1) + RMS_EPS)
    torch.cuda.synchronize()
    same = torch.equal(dx, dx2) and torch.equal(ds, ds2)
    same_f = torch.equal(y, y2) and torch.equal(rstd, rstd2)
    blocked = torch.equal(ds, blocked_ds)
    err = float((y.float() - want.float()).abs().max())
    rel = float(((y.float() - want.float()).abs()
                 / want.float().abs().clamp_min(1e-3)).max())
    rel_r = float(((rstd - want_rstd).abs() / want_rstd).max())
    err_g = max(float((a.float() - b.float()).abs().max())
                for a, b in ((dx, want_dx), (ds, want_ds)))
    # each output at its own dtype's tolerance: y and dx in x's, dscale
    # in scale's
    tol, tol_dx = rms_tol(x_dtype)
    tol_ds = rms_tol(s_dtype)[1]
    rel_dx, rel_ds = (float((a.float() - b.float()).abs().max())
                      / max(float(b.float().abs().max()), 1e-30)
                      for a, b in ((dx, want_dx), (ds, want_ds)))
    print(f"[kernels] rmsnorm {rows:6d} x {width:5d} x {x_dtype:8s} scale "
          f"{s_dtype:8s}{' strided' if strided else '        '} | out max "
          f"rel err {rel:.3e} (tol {tol}), rstd {rel_r:.3e} (tol "
          f"{RMS_RSTD_TOL}) | dx max rel err {rel_dx:.3e} (tol {tol_dx}), "
          f"dscale {rel_ds:.3e} (tol {tol_ds}) | forward {fplan.route} route, {fplan.blocks} blocks "
          f"of {fplan.rows} rows: two calls bit-identical {same_f} | "
          f"backward {plan.route} route, {plan.blocks} blocks: two calls "
          f"bit-identical {same}, dscale equal to the blocked plain "
          f"version {blocked}", flush=True)
    if not (rel <= tol and rel_r <= RMS_RSTD_TOL and rel_dx <= tol_dx
            and rel_ds <= tol_ds):
        raise AssertionError(f"rmsnorm ({rows}x{width}, {x_dtype}/"
                             f"{s_dtype}) disagrees with its plain version")
    assert same and same_f and blocked, (rows, width, x_dtype, s_dtype,
                                         fplan, plan)
    assert rmsnorm_backward.launches == before + 2
    return err, err_g, (x, scale, dy, rstd)


def check_rmsnorm(torch, timer):
    """Phase 2b. Every norm shape of the three main paths (decode tick,
    verify tick, prefill, training block/q/k norms) in each x/scale dtype
    pair, strided rows, a ragged width, and widths that take the narrow
    (64) and general (999, 10000) routes; timed at the three training
    norms (bf16, bf16 scale, rstd written), each call's launch and grid
    read from the trace, the backward's blocks an SM swept over 1-8 and
    the forward's rows a block, the empty launch's device time on the
    forward's grid, and the host path of a call (``norm_host_path``).
    Returns the forward and backward JSON entries (the block norm's
    numbers, every shape's under ``by_shape``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import (BLOCKS_PER_SM, plan_for,
                                            rmsnorm_backward,
                                            rmsnorm_forward)
    seed = 0
    for x_dtype, s_dtype in (("float32", "float32"), ("bfloat16", "float32"),
                             ("bfloat16", "bfloat16")):
        for rows, width, strided in (
                (8, 2048, False), (40, 2048, False), (1024, 2048, False),
                (128, 128, False), (16384, 128, False),
                (TB * TSEQ, 2048, False), (TB * TSEQ * HQ, 128, False),
                (TB * TSEQ * HKV, 128, False), (131, 2048, True),
                (517, 128, True), (33, 1000, False), (77, 64, False),
                (45, 999, False), (6, 10000, False)):
            seed += 1
            rmsnorm_case(torch, rows, width, x_dtype, s_dtype, strided, seed)

    entries = {
        "rmsnorm_fwd": {"name": "rmsnorm_fwd", "route": "cuda",
                        "source": "src/repro_torch/csrc/rmsnorm.cu",
                        "replaces": "src/repro/kernels/rmsnorm.py:23"},
        "rmsnorm_bwd": {"name": "rmsnorm_bwd", "route": "cuda",
                        "source": "src/repro_torch/csrc/rmsnorm.cu",
                        "replaces": "src/repro/kernels/rmsnorm.py:23"}}
    by_shape = {"rmsnorm_fwd": {}, "rmsnorm_bwd": {}}
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
        # the backward's bytes moved by one elementwise pass (reads x and
        # dy, writes one x-sized tensor): what streaming them costs here
        out = torch.empty_like(x)
        stream_ms = timer.device(lambda: torch.add(x, dy, out=out))
        fwd, bwd, fwd_plain, bwd_plain, fwd_lib, bwd_lib = (
            dev[k] for k in ("fwd", "bwd", "fwd_plain", "bwd_plain",
                             "fwd_lib", "bwd_lib"))
        plan = plan_for(x, dy)
        grids = launch_grids(torch, calls["bwd"], ("rmsnorm_bwd",))
        print(f"[kernels] rmsnorm {label} backward, one call in the trace: "
              f"{grids} ({plan.route} route, {plan.blocks} blocks of "
              f"{plan.workers} row workers, groups of {plan.group})",
              flush=True)
        assert len(grids) == 1 and grids[0][1] == (plan.blocks, 1, 1), grids
        sweep = {}
        for k in range(1, 9):      # up to what stays resident
            blocks = plan_for(x, dy, k).blocks
            if blocks not in sweep:
                sweep[blocks] = (k, timer.device(lambda: rmsnorm_backward(
                    x, scale, rstd, dy, RMS_EPS, blocks_per_sm=k)))
        print(f"[kernels] rmsnorm {label} backward by blocks an SM (device "
              f"ms; {BLOCKS_PER_SM} on the path, {plan.blocks} "
              f"blocks): " + ", ".join(f"{k} ({b} blocks): {v:.4f}"
                                      for b, (k, v) in sweep.items()),
              flush=True)
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
              f"{bwd_b[0]:.4f} ms ({bwd_b[1]}) | one elementwise pass over "
              f"the same bytes (torch.add of x and dy) {stream_ms:.4f} ms",
              flush=True)
        print(f"[kernels] rmsnorm {label}, CUDA events around each call "
              f"(host launch path included): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ev.items())
              + f" | forward <= F.rms_norm: {ev['fwd'] <= ev['fwd_lib']}",
              flush=True)
        fplan, floor = norm_fwd_trace_and_floor(torch, timer, label, x,
                                                scale, True)
        norm_fwd_sweep(torch, timer, label, x, scale, True)
        us = norm_host_path(torch, label, x, scale, dy, rstd, True)
        print(f"[kernels] rmsnorm forward {label}: {fplan.route} route, "
              f"device {fwd:.4f} ms = {fwd_b[0] / fwd:.3f} of the bound "
              f"(empty launch {floor:.4f} ms), host {us['forward']:.2f} "
              f"us a call | F.rms_norm device {fwd_lib:.4f} ms, host "
              f"{us['F.rms_norm']:.2f} us", flush=True)
        for key, ms, plain_ms, lib_ms, e, (b_ms, by), host in (
                ("rmsnorm_fwd", fwd, fwd_plain, fwd_lib, err, fwd_b,
                 us["forward"]),
                ("rmsnorm_bwd", bwd, bwd_plain, bwd_lib, err_g, bwd_b,
                 us["backward"])):
            num = {"max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
                   "event_ms": ev[key[-3:]], "host_us": host}
            by_shape[key][label] = num
            if label == "block":
                entries[key].update(num)
    for key, e in entries.items():
        e["by_shape"] = by_shape[key]
    return entries


def check_rmsnorm_granite(torch, timer, entries):
    """Phase 2d. B5 at granite-moe-3b-a800m's width (1536: a masked
    block, no power of two) at its serving paths' row counts (decode 8,
    verify 40, prefill 1024) and strided rows, in each x/scale dtype pair
    (the backward's routes too); the forward timed at the serving path's
    dtypes (bf16 x, f32 scale) at the prefill's and the decode's rows
    beside ``F.rms_norm``, its numbers added to ``by_shape``."""
    width, seed = 1536, 500
    for x_dtype, s_dtype in (("float32", "float32"), ("bfloat16", "float32"),
                             ("bfloat16", "bfloat16")):
        for rows, strided in ((8, False), (40, False), (1024, False),
                              (131, True)):
            seed += 1
            rmsnorm_case(torch, rows, width, x_dtype, s_dtype, strided, seed)
    for label, rows in (("prefill", 1024), ("decode", 8)):
        norm_forward_times(torch, timer, entries, f"{GRANITE} {label}", rows,
                           width)


def norm_forward_times(torch, timer, entries, tag, rows, width,
                       s_dtype="float32"):
    """B5's forward at one serving shape (bf16 x, a scale in
    ``s_dtype``, no rstd) against its plain version (and its backward on
    the same rows, by ``rmsnorm_case``), timed by device time beside
    ``F.rms_norm`` (CUDA-event times beside), its launch and grid read
    from the trace beside an empty launch on that grid; at prefill rows
    swept over rows a block, at decode rows its host path measured. The
    numbers go into the forward entry's ``by_shape`` under ``tag``."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_forward
    err, _, (x, scale, dy, rstd) = rmsnorm_case(
        torch, rows, width, "bfloat16", s_dtype, False, seed=rows + width)
    calls = {"fwd": lambda: rmsnorm_forward(x, scale, RMS_EPS),
             "plain": lambda: ref.rmsnorm_ref(x, scale, RMS_EPS),
             "lib": lambda: F.rms_norm(x, (width,), scale, RMS_EPS)}
    dev = {k: timer.device(fn) for k, fn in calls.items()}
    ev = {k: timer(calls[k]) for k in ("fwd", "lib")}
    n = rows * width
    b_ms, by = bound(2 * n * x.element_size() + width * scale.element_size(),
                     4 * n, PEAK_FLOPS["float32"])
    plan, floor = norm_fwd_trace_and_floor(torch, timer, tag, x, scale,
                                           False)
    print(f"[kernels] rmsnorm forward, {tag} ({rows} x {width} bf16, "
          f"{s_dtype} scale), device time: kernel {dev['fwd']:.4f} ms "
          f"({b_ms / dev['fwd']:.3f} of the bound; {plan.route} route, "
          f"{plan.blocks} blocks of {plan.rows} rows; an empty launch on "
          f"that grid {floor:.4f} ms) | plain {dev['plain']:.4f} ms | "
          f"F.rms_norm {dev['lib']:.4f} ms | bound {b_ms:.4f} ms ({by}: "
          f"{(2 * n * 2) / 1e6:.3f} MB) | CUDA events: kernel "
          f"{ev['fwd']:.4f} ms, F.rms_norm {ev['lib']:.4f} ms", flush=True)
    num = {"max_abs_err": err, "ms": dev["fwd"], "plain_ms": dev["plain"],
           "bound_ms": b_ms, "bound_by": by, "library_ms": dev["lib"],
           "event_ms": ev["fwd"], "floor_ms": floor}
    if rows >= 1024:          # prefill rows: what rows a block gives
        norm_fwd_sweep(torch, timer, tag, x, scale, False)
    else:                     # decode rows: the host's part of a call
        us = norm_host_path(torch, tag, x, scale, dy, rstd, False)
        num.update(host_us=us["forward"], lib_host_us=us["F.rms_norm"])
    entries["rmsnorm_fwd"]["by_shape"][tag] = num


def norm_train_times(torch, timer, entries, tag, rows, width):
    """B5's forward (rstd written) and backward at a training shape (bf16
    x and scale, as the compute params are) against their plain versions
    (two backward calls bit-identical, one backward launch a call in the
    trace), timed by device time beside ``F.rms_norm``; the numbers go
    into both entries' ``by_shape`` under ``tag``."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import (plan_for, rmsnorm_backward,
                                            rmsnorm_forward)
    err, err_g, (x, scale, dy, rstd) = rmsnorm_case(
        torch, rows, width, "bfloat16", "bfloat16", False, seed=rows + width)
    xl = x.detach().requires_grad_(True)
    sl = scale.detach().requires_grad_(True)
    calls = {
        "fwd": lambda: rmsnorm_forward(x, scale, RMS_EPS, want_rstd=True),
        "bwd": lambda: rmsnorm_backward(x, scale, rstd, dy, RMS_EPS),
        "fwd_plain": lambda: ref.rmsnorm_ref(x, scale, RMS_EPS),
        "bwd_plain": lambda: ref.rmsnorm_bwd_ref(x, scale, dy, RMS_EPS),
        "fwd_lib": lambda: F.rms_norm(x, (width,), scale, RMS_EPS),
        "bwd_lib": lambda: torch.autograd.backward(
            F.rms_norm(xl, (width,), sl, RMS_EPS), dy)}
    dev = {k: timer.device(fn) for k, fn in calls.items()}
    plan = plan_for(x, dy)
    grids = launch_grids(torch, calls["bwd"], ("rmsnorm_bwd",))
    assert len(grids) == 1 and grids[0][1] == (plan.blocks, 1, 1), grids
    n, isz = rows * width, x.element_size()
    fwd_b = bound(2 * n * isz + width * isz + rows * 4, 4 * n,
                  PEAK_FLOPS["float32"])
    bwd_b = bound(3 * n * isz + rows * 4 + 2 * width * isz, 8 * n,
                  PEAK_FLOPS["float32"])
    print(f"[kernels] rmsnorm {tag} ({rows} x {width} bf16, bf16 scale), "
          f"device time: forward kernel {dev['fwd']:.4f} ms ("
          f"{fwd_b[0] / dev['fwd']:.3f} of the bound) | plain "
          f"{dev['fwd_plain']:.4f} ms | F.rms_norm {dev['fwd_lib']:.4f} ms | "
          f"bound {fwd_b[0]:.4f} ms ({fwd_b[1]}); backward kernel "
          f"{dev['bwd']:.4f} ms ({bwd_b[0] / dev['bwd']:.3f} of the bound; "
          f"{plan.route} route, {plan.blocks} blocks, one launch in the "
          f"trace) | plain {dev['bwd_plain']:.4f} ms | F.rms_norm fwd+bwd "
          f"{dev['bwd_lib']:.4f} ms | bound {bwd_b[0]:.4f} ms ({bwd_b[1]}: "
          f"{(3 * n * isz) / 1e6:.2f} MB)", flush=True)
    for key, tag_ms, e, (b_ms, by) in (("rmsnorm_fwd", "fwd", err, fwd_b),
                                       ("rmsnorm_bwd", "bwd", err_g, bwd_b)):
        entries[key]["by_shape"][tag] = {
            "max_abs_err": e, "ms": dev[tag_ms],
            "plain_ms": dev[tag_ms + "_plain"], "bound_ms": b_ms,
            "bound_by": by, "library_ms": dev[tag_ms + "_lib"]}


# qwen3-1.7b's serving norms: (tag, rows, width) of a decode tick of 8
# slots and an admission prefill of 8 x 128 tokens: the block norms (ln1,
# ln2, final) over 2048, the q-norm over Hq 16 rows a token and the
# k-norm over Hkv 8, each over D 128
QWEN3_SERVING_NORMS = (
    ("qwen3-1.7b decode", B, 2048), ("qwen3-1.7b decode q-norm", B * HQ, D),
    ("qwen3-1.7b decode k-norm", B * HKV, D),
    ("qwen3-1.7b prefill", B * 128, 2048),
    ("qwen3-1.7b prefill q-norm", B * 128 * HQ, D),
    ("qwen3-1.7b prefill k-norm", B * 128 * HKV, D))


def check_rmsnorm_serving(torch, timer, entries):
    """Phase 2e. B5's forward at qwen3-1.7b's serving shapes (bf16 x, f32
    scale, no rstd), timed beside ``F.rms_norm``."""
    for tag, rows, width in QWEN3_SERVING_NORMS:
        norm_forward_times(torch, timer, entries, tag, rows, width)


# ----------------------------------------------------------------------
# phase 4: the training kernels against their plain versions
# ----------------------------------------------------------------------
TB, TSEQ = 4, 1024                        # the training path's batch


def flash_case(torch, dtype, sq, skv, causal, seed, d=D, layout="plain",
               hq=HQ, hkv=HKV):
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
        qkv = randn(TB, sq, hq + 2 * hkv, d)
        q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
    elif layout == "misaligned":
        q, k, v = (randn(TB, s, h, d + 2)[..., 1:d + 1]
                   for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    else:
        q, k, v = (randn(TB, sq, hq, d), randn(TB, skv, hkv, d),
                   randn(TB, skv, hkv, d))
    dout = randn(TB, sq, hq, d)
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
          f"Hq {hq:2d} Hkv {hkv:2d} D {d:3d} causal {causal!s:5s} "
          f"{layout:10s} | out/lse max |err| "
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


def flash_bytes_flops(sq, skv, isz, causal, backward, heads=QWEN3_HEADS):
    """Least bytes and flops of one call: inputs read once, outputs
    written once; 4 D flops per visible (query, key) pair forward (two
    products), 10 D backward (the scores again, dP, dV, dK, dQ)."""
    hq, hkv, d = heads
    pairs = TB * hq * (sum(min(r + 1, skv) for r in range(sq)) if causal
                       else sq * skv)
    qo = TB * sq * hq * d * isz
    kv = TB * skv * hkv * d * isz
    lse = TB * hq * sq * 4
    if backward:       # q k v out dout lse in; dq dk dv out
        return 3 * qo + 2 * kv + lse + qo + 2 * kv, 10 * d * pairs
    return 2 * qo + 2 * kv + lse, 4 * d * pairs


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
    nums = flash_on_training_inputs(torch, timer, "qwen3-1.7b", QWEN3_HEADS)
    entries = {}
    for key, num in nums.items():
        entries[key] = {
            "name": key, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:93",
            **num, "by_shape": {}}
    return entries


def flash_on_training_inputs(torch, timer, arch, heads, causal=True):
    """Flash attention at a training path's inputs (B 4, S 1024, the
    model's heads, bf16, causal or not) in bfloat16 and float32 against
    the plain versions, two forward and two backward calls bit-identical,
    then timed by device time (CUPTI) beside SDPA's forward, its backward
    alone and its forward + backward, CUDA-event times printed beside.
    Returns the forward's and the backward's numbers."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_forward)
    hq, hkv, d = heads
    mask = "causal" if causal else "non-causal"
    flash_case(torch, "float32", TSEQ, TSEQ, causal, seed=3, d=d, hq=hq,
               hkv=hkv)
    err, err_g, (q, k, v, out, lse, dout) = flash_case(
        torch, "bfloat16", TSEQ, TSEQ, causal, seed=1, d=d, hq=hq, hkv=hkv)
    fwd = [flash_attention_forward(q, k, v, causal) for _ in range(2)]
    first = flash_attention_backward(q, k, v, out, lse, dout, causal)
    again = flash_attention_backward(q, k, v, out, lse, dout, causal)
    torch.cuda.synchronize()
    same_fwd = all(torch.equal(a, b) for a, b in zip(*fwd))
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    print(f"[kernels] flash attention, two calls on {arch}'s {mask} "
          f"training inputs: out and lse bit-identical {same_fwd}, dq, dk, "
          f"dv bit-identical {same}", flush=True)
    assert same and same_fwd, "flash attention is not deterministic"
    del first, again, fwd

    # SDPA on the (B, H, S, D) layout, transposed outside the timed call
    qt, kt, vt, dt_ = (x.transpose(1, 2).contiguous()
                       for x in (q, k, v, dout))

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(a, b, c, is_causal=causal,
                                              enable_gqa=True)
    leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
    sdpa_out = sdpa(*leaves)           # the forward of "SDPA bwd", untimed
    calls = {
        "fwd": lambda: flash_attention_forward(q, k, v, causal),
        "bwd": lambda: flash_attention_backward(q, k, v, out, lse, dout,
                                                causal),
        "fwd_plain": lambda: ref.flash_attention_ref(q, k, v, causal),
        "bwd_plain": lambda: ref.flash_attention_bwd_ref(
            q, k, v, out, lse, dout, causal),
        "sdpa_fwd": lambda: sdpa(qt, kt, vt),
        # the backward alone: autograd.grad through the saved graph (no
        # accumulation into .grad)
        "sdpa_bwd": lambda: torch.autograd.grad(sdpa_out, leaves, dt_,
                                                retain_graph=True),
        "sdpa_fwd_bwd": lambda: torch.autograd.grad(sdpa(*leaves), leaves,
                                                    dt_)}
    dev = {k: timer.device(fn) for k, fn in calls.items()}
    ev = {k: timer(fn) for k, fn in calls.items()}
    print(f"[kernels] flash attention on {arch}'s {mask} training inputs, "
          f"CUDA events around each call (host launch path and flush tail "
          f"included): " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                     ev.items()), flush=True)
    isz = q.element_size()
    nums = {}
    for key, back, e in (("flash_attention_fwd", False, err),
                         ("flash_attention_bwd", True, err_g)):
        tag = "bwd" if back else "fwd"
        ms, plain_ms, lib_ms = dev[tag], dev[tag + "_plain"], dev["sdpa_" + tag]
        nbytes, flops = flash_bytes_flops(TSEQ, TSEQ, isz, causal, back,
                                          heads)
        b_ms, by = bound(nbytes, flops, PEAK_FLOPS["bfloat16"])
        nums[key] = {"max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
                     "event_ms": ev[tag]}
        extra = (f" | SDPA fwd+bwd {dev['sdpa_fwd_bwd']:.4f} ms" if back
                 else "")
        print(f"[kernels] {key} on {arch}'s training inputs (B {TB}, S "
              f"{TSEQ}, Hq {hq}, Hkv {hkv}, D {d}, bf16, {mask}), device "
              f"time: kernel {ms:.4f} ms = {flops / ms / 1e9:.1f} TFLOP/s at "
              f"the bound's flops, {b_ms / ms:.3f} of the bound | plain "
              f"{plain_ms:.4f} ms | {'SDPA bwd alone' if back else 'SDPA fwd'}"
              f" {lib_ms:.4f} ms (kernel / SDPA {ms / lib_ms:.2f}){extra} | "
              f"bound {b_ms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP)", flush=True)
    return nums


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
QWEN3 = "qwen3-1.7b"
ZAMBA = "zamba2-1.2b"
ZAMBA_HEADS = (32, 32, 64)                # G 1, D 64


def launches_per_forward(cfg):
    """(B4 launches, B5 launches, B4 launches inside the superblocks, B5
    launches inside the superblocks) of one cache-free forward, derived
    from the model's schedule: per attention block (dense, moe, the
    hybrid's shared block) one B4 and ln1, ln2 (and the q- and k-norm
    with qk-norm); per Mamba2 block its ln and gate norm, per mLSTM or
    sLSTM block its ln and out_norm; per encdec block two B4 (its own
    tokens, then across to the encoder's output) and ln1, lnx, ln2 (and
    both attentions' q- and k-norms with qk-norm); the audio family's
    encoder blocks (dense, never checkpointed) and the encoder's norm,
    and the final norm, outside every superblock."""
    from repro_torch.models.lm import make_schedule
    sch = make_schedule(cfg)
    qk = 2 if cfg.qk_norm else 0
    norms = {"dense": 2 + qk, "moe": 2 + qk, "shared": 2 + qk, "mamba": 2,
             "mlstm": 2, "slstm": 2, "encdec": 3 + 2 * qk}
    attns = {"dense": 1, "moe": 1, "shared": 1, "encdec": 2}
    inner = sch.n_super * sum(norms[t] for t in sch.pattern)
    attn = sch.n_super * sum(attns.get(t, 0) for t in sch.pattern)
    outer = sum(norms[t] for t in sch.tail) + 1
    outer_attn = 0
    if sch.has_encoder:
        outer += encoder_norms(cfg)
        outer_attn += cfg.encoder_layers
    return attn + outer_attn, inner + outer, attn, inner


def encoder_norms(cfg):
    """B5 launches of the audio family's encoder: ln1, ln2 (and the q-
    and k-norm with qk-norm) a block, and the encoder's norm."""
    return cfg.encoder_layers * (2 + (2 if cfg.qk_norm else 0)) + 1


def train_counters():
    import repro_torch.kernels.flash_attention as fa
    import repro_torch.kernels.rmsnorm as rn
    import repro_torch.kernels.silent_compare as sc
    return {"flash_attention_fwd": fa.flash_attention_forward,
            "flash_attention_bwd": fa.flash_attention_backward,
            "silent_compare": sc.silent_compare,
            "rmsnorm_fwd": rn.rmsnorm_forward,
            "rmsnorm_bwd": rn.rmsnorm_backward}


def train_path(torch, np, arch=QWEN3, remat="none", steps=TRAIN_STEPS):
    """``launch.train.run`` for ``arch`` at full width with the detectors
    on, under ``remat``, ``steps`` steps; the training kernels' launch
    counts are set to 0 just before and read just after. Returns the
    launches."""
    import math
    import repro_torch.kernels.flash_attention as fa
    from repro_torch.configs import registry
    from repro_torch.launch.train import run

    cfg = registry.get_config(arch)
    counters = train_counters()
    for c in counters.values():
        c.launches = 0
    fa.flash_attention_forward.copies = 0
    fa.flash_attention_backward.copies = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses, merged = run(arch, smoke=False, steps=steps, batch=TB,
                         seq=TSEQ, profile=True, remat=remat, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    copies = (fa.flash_attention_forward.copies,
              fa.flash_attention_backward.copies)
    checked = merged.checked.get("silent_param_store", 0)
    print(f"[train] {arch} full width, {steps} steps of {TB} x {TSEQ} "
          f"tokens, remat {remat}, detectors on: {wall:.1f} s including "
          f"set-up; launches {launches}; flash attention alignment copies "
          f"(forward, backward) {copies}; losses {losses}; profile tiers "
          f"{merged.tiers}, checked {dict(sorted(merged.checked.items()))}, "
          f"flagged {dict(sorted(merged.flagged.items()))}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    attn, norms, attn_in, inner = launches_per_forward(cfg)
    again = 0 if remat == "none" else 1
    assert launches["flash_attention_fwd"] == \
        (attn + again * attn_in) * steps, launches
    assert launches["flash_attention_bwd"] == attn * steps, launches
    assert copies == (0, 0), copies
    assert launches["rmsnorm_fwd"] == \
        (norms + again * inner) * steps, launches
    assert launches["rmsnorm_bwd"] == norms * steps, launches
    assert launches["silent_compare"] == checked > 0, (launches, checked)
    assert all(math.isfinite(x) for x in losses), losses
    assert abs(losses[0] - math.log(cfg.padded_vocab)) < 3.0, losses
    assert merged.tiers == [3], merged.tiers
    # each step's batch leaves: tokens, labels (and the audio family's
    # frames)
    leaves = 3 if cfg.family == "audio" else 2
    assert merged.checked.get("silent_data_load") == leaves * steps
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


def train_timing_and_trace(torch, np, arch=QWEN3, remat="none", timed=3,
                           warmup=1):
    """Train tokens/s with the detectors on, full width: ``warmup`` first
    steps (untimed), then ``timed`` steps timed on the host clock, each
    ending in a device synchronization; then one step under
    torch.profiler (device time by kernel kind, device busy share), its
    kernels checked against the launch counters (``traced_step``)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ProfilerConfig, TrainConfig
    from repro_torch.core.detectors import TrainingDetectors
    from repro_torch.data.synthetic import stream
    from repro_torch.models.zoo import build_model
    from repro_torch.train import state as TS
    from repro_torch.train.step import make_train_step

    cfg = registry.get_config(arch)
    model = build_model(cfg)
    tc = TrainConfig(learning_rate=3e-4, total_steps=8, warmup_steps=1,
                     remat=remat)
    state = TS.create(model, 0, device="cuda")
    det = TrainingDetectors(ProfilerConfig(enabled=True))
    loop = _train_loop(torch, state, make_train_step(model, tc), det,
                       stream(cfg, TB, TSEQ, seed=0), "cuda")
    del state
    for _ in range(warmup):
        state, m = next(loop)
        float(m["loss"])
    times = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = next(loop)
        float(m["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    tok = TB * TSEQ
    print(f"[train] {arch} timed steps (remat {remat}, detectors on): "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms = "
          f"{', '.join(f'{tok / t:.1f}' for t in times)} tok/s", flush=True)
    del state, m

    def step():
        _, metrics = next(loop)
        float(metrics["loss"])
    traced_step(torch, f"{arch} train step", lambda: step, train_counters())
    del loop
    torch.cuda.empty_cache()
    return times


def train_smoke_check(torch, np, arch=QWEN3, resync=False, **overrides):
    """The smoke config in float32: 4 train steps with the detectors on,
    kernels on the card against plain versions on the CPU, from the same
    state and batches. Losses and grad norms within 1e-4 relative (the
    same f32 arithmetic in other summation orders, moved through 4 Adam
    steps), detector findings and counters equal. With ``resync`` each
    card step starts from the CPU's state of that step: xLSTM's
    exponential gates carry Adam's sign flips of near-zero gradients
    (every parameter moves by about +-lr in the first steps) to 0.45% of
    the grad norm by the third free step (``tests/test_torch_xlstm.py``),
    while each step from one state agrees within 1e-5."""
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

    cfg = dataclasses.replace(registry.get_config(arch).smoke(),
                              dtype="float32", **overrides)
    model = build_model(cfg)
    tc = TrainConfig(learning_rate=3e-4, total_steps=TRAIN_STEPS,
                     warmup_steps=1, remat="none")
    s0 = TS.create(model, 0, compute_dtype=torch.float32, device="cpu")

    def copy_state(st, dev):
        def move(tree):
            return tree_map(lambda t: t.to(dev, copy=True), tree)
        return TS.TrainState(params=move(st.params), master=move(st.master),
                             opt=AdamWState(m=move(st.opt.m),
                                            v=move(st.opt.v)),
                             step=st.step.to(dev, copy=True))
    results, starts = {}, []
    for dev in ("cpu", "cuda"):
        state = copy_state(s0, dev)
        step_fn = make_train_step(model, tc)
        det = TrainingDetectors(ProfilerConfig(enabled=True))
        batches = stream(cfg, 4, 64, seed=0)
        rows = []
        for step in range(TRAIN_STEPS):
            if resync and dev == "cpu":
                starts.append(copy_state(state, "cpu"))
            elif resync:
                state = copy_state(starts[step], dev)
            b = next(batches)
            det.on_batch(step, b)
            before = state.params
            state, m = step_fn(state, {k: torch.from_numpy(v).to(dev)
                                       for k, v in b.items()})
            det.on_step(step, before, state.params)
            del before
            rows.append((float(m["loss"]), float(m["grad_norm"]),
                         float(m["moe_aux"])))
        rep = det.report
        results[dev] = (np.array(rows),
                        sorted((f.kind, f.c1, f.step) for f in rep.findings),
                        dict(rep.checked), dict(rep.flagged))
    (rc, fc, cc, gc), (rg, fg, cg, gg) = results["cpu"], results["cuda"]
    rel = float(np.max(np.abs(rg - rc) / np.maximum(np.abs(rc), 1e-30)))
    same = (fc, cc, gc) == (fg, cg, gg)
    print(f"[check] {arch} smoke f32 training ({cfg.num_layers} layers"
          f"{', each card step from the CPU state' if resync else ''}), "
          f"kernels on the card vs plain on the CPU: losses "
          f"{rg[:, 0].tolist()} vs {rc[:, 0].tolist()}, max relative "
          f"difference of loss, grad norm and moe_aux {rel:.3e} (tol 1e-4); "
          f"detector findings and counters equal {same} (checked {cg})",
          flush=True)
    if not same:
        print(f"[check]   CPU flagged {gc}, card flagged {gg}", flush=True)
    assert rel <= 1e-4 and same, results


def reckon_step_bytes(torch, model, state, batch, remat):
    """The device bytes a train step under ``remat`` would reach,
    reckoned before the step runs: the state held now (master, moments,
    compute params), the gradients (one compute-dtype element per
    parameter), and the larger of (a) the activations the forward keeps
    for the backward with the head's and the loss's forward and backward
    on top, and (b) the clip's f32 temporaries of the largest leaf (a
    copy and its square). The activations are measured at full width on
    the step's own batch: the bytes one superblock under ``remat`` (and,
    for the hybrid, one tail block, which is never checkpointed) keeps
    alive for its backward, times their count; under "full" and "dots"
    one superblock's recomputation adds what it keeps under "none".
    Returns (bytes, parts)."""
    import gc
    from repro_torch.models import lm as LMmod
    from repro_torch.models import params as P
    from repro_torch.train.fused_xent import lm_loss
    cfg, sch = model.cfg, model.sched
    params = state.params

    def leaf(t):
        return t.detach().requires_grad_(True)

    def kept(fn):
        """Bytes that fn's outputs (and the graph behind them) hold."""
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        with torch.enable_grad():
            out = fn()
        torch.cuda.synchronize()
        n = torch.cuda.memory_allocated() - base
        del out
        return n

    dt = getattr(torch, cfg.dtype)
    with torch.no_grad():
        x0 = params["embed"][batch["tokens"].long()].to(dt)
    layer = P.tree_map(lambda t: leaf(t[0]), params["main"])
    shared = (P.tree_map(leaf, params["shared"]) if "shared" in params
              else None)
    enc0, per_enc = None, 0
    if sch.has_encoder:
        # the encoder's blocks are never checkpointed; the decoder's
        # cross-attention reads the encoder's output
        from repro_torch.models import layers as L
        f0 = batch["frames"].to(dt)
        with torch.no_grad():
            enc0 = model.encode(params, f0)
        blk = P.tree_map(lambda t: leaf(t[0]), params["enc"]["blocks"])
        per_enc = kept(lambda: L.apply_dense_block(blk, cfg, leaf(f0),
                                                   causal=False))
    aux = torch.zeros((), device=x0.device)
    saved_remat = model.remat
    per_super = {}
    for mode in {"none", remat}:
        model.remat = mode
        per_super[mode] = kept(lambda: model._maybe_remat(
            layer, shared, leaf(x0), aux,
            None if enc0 is None else leaf(enc0)))
    model.remat = saved_remat
    recompute = per_super["none"] if remat != "none" else 0
    per_tail = 0
    if sch.tail:
        tail = P.tree_map(lambda t: leaf(t[0]), params["tail"])
        per_tail = kept(lambda: LMmod._apply_sub(tail, cfg, sch.tail[0],
                                                 leaf(x0)))
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.enable_grad():
        xx = leaf(x0)
        loss = lm_loss(xx, model.head_weight(params), batch["labels"])
        torch.autograd.grad(loss, [xx])
    del xx, loss
    head = torch.cuda.max_memory_allocated() - base
    leaves = P.tree_leaves(params)
    grads = sum(t.numel() * t.element_size() for t in leaves)
    clip = 8 * max(t.numel() for t in leaves)
    held = torch.cuda.memory_allocated()
    enc_layers = cfg.encoder_layers if sch.has_encoder else 0
    acts = (sch.n_super * per_super[remat] + recompute
            + len(sch.tail) * per_tail + enc_layers * per_enc + head)
    parts = {"state": held, "grads": grads, "superblock": per_super[remat],
             "recomputed superblock": recompute, "tail block": per_tail,
             "encoder block": per_enc, "head and loss": head,
             "activations": acts, "clip": clip}
    return held + grads + max(acts, clip), parts


def remat_check(torch, np, arch=QWEN3):
    """One train step at full width under remat "none", "full" and
    "dots", each from the same seeded state and batch, for each mode
    whose reckoned bytes (``reckon_step_bytes``, before anything of the
    mode is allocated) fit in 94% of the card's memory; a mode that does
    not fit is reported with its reckoning and not run. Among the modes
    run: loss and grad norm equal bit for bit (recomputing a
    deterministic forward gives the same bits); launches per step: B4
    forward and B5 forward as ``launches_per_forward`` derives them, and
    the checkpointed superblocks' attention and norms again under "full"
    and "dots"; B4 and B5 backward once in every mode. Prints each mode's
    peak device memory beside its reckoning. Returns the modes run."""
    import gc
    from repro_torch.configs import registry
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synthetic import stream
    from repro_torch.models.zoo import build_model
    from repro_torch.train import state as TS
    from repro_torch.train.step import make_train_step

    cfg = registry.get_config(arch)
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in next(stream(cfg, TB, TSEQ, seed=0)).items()}
    attn, norms, attn_in, inner = launches_per_forward(cfg)
    counters = {k: c for k, c in train_counters().items()
                if k != "silent_compare"}
    budget = 0.94 * torch.cuda.mem_get_info()[1]
    results = {}
    gib = 2 ** 30
    for remat in ("none", "full", "dots"):
        model = build_model(cfg)
        step = make_train_step(model, TrainConfig(
            learning_rate=3e-4, total_steps=8, warmup_steps=1, remat=remat))
        state = TS.create(model, 0, device="cuda")
        reckoned, parts = reckon_step_bytes(torch, model, state, batch, remat)
        parts = ", ".join(f"{k} {v / gib:.2f}" for k, v in parts.items())
        if reckoned > budget:
            print(f"[remat] {arch} {remat}: not run: a step would reach "
                  f"{reckoned / gib:.2f} GiB by the reckoning ({parts} GiB), "
                  f"over the budget of {budget / gib:.2f} GiB (94% of the "
                  f"card's memory)", flush=True)
            del state, step, model
            gc.collect()
            torch.cuda.empty_cache()
            continue
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {k: c.launches for k, c in counters.items()}
        loss, gnorm = m["loss"].cpu(), m["grad_norm"].cpu()
        results[remat] = (loss, gnorm, launches)
        print(f"[remat] {arch} {remat}: one train step of {TB} x {TSEQ} "
              f"tokens at full width, loss {float(loss)!r}, grad norm "
              f"{float(gnorm)!r}, launches {launches}, peak device memory "
              f"{peak / gib:.2f} GiB (reckoned {reckoned / gib:.2f} GiB: "
              f"{parts} GiB; {(peak - held) / gib:.2f} GiB above the "
              f"{held / gib:.2f} GiB of state held before the step), "
              f"{wall * 1e3:.1f} ms including the first call's set-up",
              flush=True)
        del state, m, step, model
        gc.collect()
        torch.cuda.empty_cache()
    assert results, f"{arch}: no remat mode fits"
    first = next(iter(results))
    want_loss, want_gnorm, _ = results[first]
    for remat, (loss, gnorm, launches) in results.items():
        again = 0 if remat == "none" else 1
        assert torch.equal(loss, want_loss) and torch.equal(
            gnorm, want_gnorm), (remat, loss, gnorm, want_loss, want_gnorm)
        assert launches == {
            "flash_attention_fwd": attn + again * attn_in,
            "flash_attention_bwd": attn,
            "rmsnorm_fwd": norms + again * inner,
            "rmsnorm_bwd": norms}, (remat, launches)
    print(f"[remat] {arch}: {', '.join(results)} give equal loss and grad "
          f"norm bit for bit", flush=True)
    return list(results)


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
    norms = launches_per_forward(cfg)[1]

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
    print(f"[main] qwen3-1.7b full width, paged, profile: {wall:.1f} s "
          f"(tier 1 {tier1_seconds(stats)}); launches {launches}; ticks "
          f"{stats['ticks']}, prefills {stats['prefills']}; prefill "
          f"{stats['prefill_tok_s']:.1f} tok/s, decode "
          f"{stats['decode_tok_s']:.1f} tok/s", flush=True)
    assert launches["paged_decode"] == layers * stats["ticks"] > 0, launches
    assert launches["paged_window"] == layers * stats["prefills"] > 0, launches
    # + 1: tier 1's recorded decode microstep
    assert launches["rmsnorm_fwd"] == norms * (stats["ticks"]
                                               + stats["prefills"] + 1), launches
    assert out.shape == (8, 32) and ((out >= 0) & (out < cfg.vocab_size)).all()
    assert merged.tiers == [1, 2, 3, 4], merged.tiers
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
    del eng, params, model
    torch.cuda.empty_cache()
    engine_steps(torch, np, cfg)
    return launches, stats


def tier1_seconds(stats) -> str:
    """Tier 1's share of a ``launch.serve.run(..., profile=True)``."""
    return (f"{stats['tier1_s']:.1f} s: recording "
            f"{stats['tier1_record_s']:.1f} s, engine passes "
            + " / ".join(f"{t:.1f}" for t in stats["tier1_epoch_s"]) + " s")


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
    if "rmsnorm_fwd_" in name:
        return "rmsnorm_fwd"
    if "rmsnorm_bwd_" in name:
        return "rmsnorm_bwd"
    if any(s in name for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul"
    if "copy" in name:
        return "cast/copy"
    return "other"


# untimed kernels that open a trace whose kernels are counted: a trace
# can lose the first device records of its window
LEAD_IN = 256


def report_trace(torch, prof, label, wall_ms):
    """Device time by kernel kind, kernel count and the device's busy
    share of a profiled step's wall time, the lead-in's spin kernels left
    out. The device records are read from the profiler's raw results:
    parsing them into ``prof.events()`` took 291 s for a trace of 0.77 M
    kernels (xlstm-1.3b's train step). Returns the kernels by kind."""
    cuda = torch.autograd.DeviceType.CUDA
    kinds, others, counts, n = {}, {}, {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        name = e.name()
        if "spin_kernel" not in name:
            n += 1
            k = _kernel_kind(name)
            ms = e.duration_ns() / 1e6
            kinds[k] = kinds.get(k, 0.0) + ms
            counts[k] = counts.get(k, 0) + 1
            if k == "other":
                others[name[:70]] = others.get(name[:70], 0.0) + ms
    if not n:
        print(f"[trace] {label}: the profiler saw no device kernels; "
              f"device time not measured (wall {wall_ms:.2f} ms)")
        return counts
    busy = sum(kinds.values())
    parts = ", ".join(f"{k} {v:.3f} ms" for k, v in
                      sorted(kinds.items(), key=lambda kv: -kv[1]))
    print(f"[trace] {label}: wall {wall_ms:.2f} ms (profiled), {n} "
          f"kernels, device busy {busy:.3f} ms = "
          f"{busy / wall_ms:.3f} of wall; {parts}", flush=True)
    top = sorted(others.items(), key=lambda kv: -kv[1])[:5]
    print(f"[trace] {label}: largest kernels of 'other': "
          + "; ".join(f"{name} {ms:.3f} ms" for name, ms in top), flush=True)
    return counts


# kernels a launch of a counted wrapper puts in a trace: B4's backward is
# the delta, dK/dV and dQ kernels; every other wrapper launches one
KERNELS_PER_LAUNCH = {"flash_attention_bwd": 3}


def traced_step(torch, label, prepare, counters, want=None, tries=3):
    """torch.profiler over one step: ``prepare()`` (untraced) returns the
    step, a callable. The trace opens with LEAD_IN untimed spin kernels
    (a trace can lose the first device records of its window: 14-16 of
    them in this process), which ``report_trace`` leaves out. The kernels
    of each counted kind in the trace must equal the launches the
    counters (``{kind: wrapper}``, set to 0 before the step) saw, times
    ``KERNELS_PER_LAUNCH``; with ``want``, the launches must equal it. A
    trace that misses kernels the counters saw is printed and retaken, at
    most ``tries`` times in all. Returns the launches."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(tries):
        step = prepare()
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_IN):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        counts = report_trace(torch, prof, label, wall_ms)
        print(f"[trace] {label}: the trace read in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        launched = {k: c.launches for k, c in counters.items()}
        expect = {k: n * KERNELS_PER_LAUNCH.get(k, 1)
                  for k, n in launched.items()}
        got = {k: counts.get(k, 0) for k in counters}
        print(f"[trace] {label}: kernels {got} in the trace, launches "
              f"{launched}" + (f" (expected {want})" if want else ""),
              flush=True)
        if want is not None:
            assert launched == want, (label, launched, want)
        if got == expect:
            return launched
        if attempt + 1 < tries:
            print(f"[trace] {label}: the trace missed kernels the counters "
                  f"saw; retaken", flush=True)
    raise AssertionError((label, got, expect))


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
    norms = launches_per_forward(cfg)[1]
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
              f"{wall:.1f} s (tier 1 {tier1_seconds(stats)}); launches "
              f"{launches}; verify ticks "
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
        # + 1: tier 1's recorded decode microstep
        assert launches["rmsnorm_fwd"] == norms * (forwards + 1), launches
        assert out.shape == (8, 32) and ((out >= 0)
                                         & (out < cfg.vocab_size)).all()
        assert checked == stats["draft_proposed"] > 0, (checked, stats)
        assert flagged == (0 if rollback else rejected), (flagged, rejected)
        by_run[f"spec {mode}"] = launches
    return by_run


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


# ----------------------------------------------------------------------
# phase 3c: granite-moe-3b-a800m, the MoE family, served at full width
# ----------------------------------------------------------------------
def granite_path(torch, np):
    """``launch.serve.run`` for granite-moe-3b-a800m at full width (32
    layers, d_model 1536, Hq 24, Hkv 8, D 64, 40 experts top-8; random
    weights from seed 0): paged, profile on, batch 8, prompt 128 + 32;
    again with the profiler off (equal tokens; tier 1 would take ~30 s
    of the repeat), then ``--spec on`` (n-gram drafts, k 4) with rollback
    and with overwrite. The serving kernels' launch counts are set to 0
    just before each run and read just after: 32 B1 or B2 and 65 B5
    launches a forward (and a forward more in a profiled run's tier 1).
    Then the MoE dispatch stats and traced steps (engine_steps). Returns
    the launches per run."""
    import repro_torch.kernels.flash_prefill as fp
    import repro_torch.kernels.paged_attention as pa
    import repro_torch.kernels.rmsnorm as rn
    from repro_torch.configs import registry
    from repro_torch.launch.serve import run

    cfg = registry.get_config(GRANITE)
    layers = cfg.num_layers
    norms = launches_per_forward(cfg)[1]
    counters = {"paged_decode": pa.paged_decode_attention,
                "paged_window": fp.paged_window_attention,
                "rmsnorm_fwd": rn.rmsnorm_forward}
    by_run, outs = {}, []
    for label, kw in (("granite serve", {}),
                      ("granite serve, again", {"profile": False}),
                      ("granite spec rollback",
                       {"spec": True, "spec_rollback": True}),
                      ("granite spec overwrite",
                       {"spec": True, "spec_rollback": False})):
        spec = kw.get("spec", False)
        profile = kw.setdefault("profile", True)
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        out, merged, stats = run(GRANITE, smoke=False, kv="paged",
                                 batch=8, prompt_len=128, gen=32,
                                 spec_k=SPEC_K, draft="ngram",
                                 device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        ticks = stats["spec_ticks"] if spec else stats["ticks"]
        forwards = stats["prefills"] + ticks
        rates = (f"verify {stats['verify_tok_s']:.1f} tok/s over verified "
                 f"positions, drafts accepted {stats['draft_accepted']} of "
                 f"{stats['draft_proposed']}, " if spec else "")
        tier1 = (f"profile: {wall:.1f} s (tier 1 {tier1_seconds(stats)}); "
                 f"tiers {merged.tiers}" if profile
                 else f"no profile: {wall:.1f} s")
        print(f"[granite] {label}: full width, paged, {tier1}; launches "
              f"{launches}; {ticks} ticks, {stats['prefills']} "
              f"prefills; prefill {stats['prefill_tok_s']:.1f} tok/s, "
              f"{rates}decode {stats['decode_tok_s']:.1f} tok/s", flush=True)
        if spec:
            assert stats["ticks"] == stats["spec_ticks"] > 0, stats
            assert launches["paged_decode"] == 0, launches
            assert launches["paged_window"] == layers * forwards, launches
            rejected = stats["draft_proposed"] - stats["draft_accepted"]
            checked = merged.checked.get("kernel_rejected_draft_store", 0)
            flagged = merged.flagged.get("kernel_rejected_draft_store", 0)
            assert checked == stats["draft_proposed"] > 0, (checked, stats)
            assert flagged == (0 if kw["spec_rollback"] else rejected)
        else:
            assert launches["paged_decode"] == layers * ticks > 0, launches
            assert launches["paged_window"] == layers * stats["prefills"] > 0
        # + 1: tier 1's recorded decode microstep
        assert launches["rmsnorm_fwd"] == norms * (forwards + profile), \
            launches
        assert out.shape == (8, 32) and ((out >= 0)
                                         & (out < cfg.vocab_size)).all()
        assert not profile or merged.tiers == [1, 2, 3, 4], merged.tiers
        outs.append(out)
        by_run[label] = launches
    same = np.array_equal(outs[0], outs[1])
    print(f"[granite] two plain runs give equal tokens {same}; rollback and "
          f"overwrite give equal tokens {np.array_equal(outs[2], outs[3])}",
          flush=True)
    assert same, "two runs of the same requests gave different tokens"
    engine_steps(torch, np, cfg)
    return by_run


class MoEDispatchStats:
    """While active, every MoE layer call also measures its dispatch
    buffer (``models.moe.dispatch_stats`` on the layer's own input) and
    counts its tokens."""

    def __init__(self):
        self.calls, self.stats = 0, {}

    def __enter__(self):
        from repro_torch.models import moe as M
        self._orig = M.apply_moe

        def measured(p, cfg, x):
            st = M.dispatch_stats(p, cfg, x)
            assert st["dispatch"] == "scatter", st
            self.calls += 1
            st["choices"] = x.shape[0] * x.shape[1] * \
                cfg.moe.experts_per_token
            for k, v in st.items():
                if k not in ("dispatch", "dead_fraction"):
                    self.stats[k] = self.stats.get(k, 0) + v
            return self._orig(p, cfg, x)
        M.apply_moe = measured
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as M
        M.apply_moe = self._orig

    def report(self, label):
        st = self.stats
        print(f"[granite] MoE dispatch, {label}: {self.calls} layer calls, "
              f"{st['choices']} expert choices, {st['rows_routed']} routed "
              f"({st['choices'] - st['rows_routed']} dropped past capacity) "
              f"of {st['rows_total']} buffer rows; rows stored "
              f"{st['rows_stored']}, dead rows {st['dead_rows']} "
              f"(scatter)", flush=True)
        assert st["dead_rows"] == 0 and st["rows_stored"] == st["rows_routed"]


def engine_steps(torch, np, cfg):
    """At full width, one set of weights: for the MoE family the dispatch
    stats of an admission step (prefill 8 x 128 + first tick), a decode
    tick and a verify tick (dead rows 0 under scatter); then
    torch.profiler over an admission step, a decode tick and a verify
    tick (rollback), with the kernels of each read from the trace: per
    forward one B1 or B2 a layer and ``launches_per_forward``'s B5
    launches (``traced_step``: the launch counters must show them, and
    the trace must hold them). A retaken admission step is a fresh
    engine's, a retaken tick the same engine's next tick."""
    import repro_torch.kernels.flash_prefill as fp
    import repro_torch.kernels.paged_attention as pa
    import repro_torch.kernels.rmsnorm as rn
    from repro_torch.configs.base import ProfilerConfig
    from repro_torch.core.detectors import ServingDetectors
    from repro_torch.data.synthetic import batch_at
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.spec import NGramDrafter

    model = build_model(cfg)
    params = model.init(0, device="cuda")
    prompts = batch_at(cfg, 8, 128, seed=0, step=0)["tokens"]
    layers = cfg.num_layers
    norms = launches_per_forward(cfg)[1]
    moe = cfg.moe is not None

    def engine(spec):
        eng = ServeEngine(model, params, num_slots=8, max_len=MAX_LEN,
                          detectors=ServingDetectors(ProfilerConfig(
                              enabled=True, seed=0)),
                          kv_dtype=torch.float32, kv_layout="paged",
                          page_size=PS, kernel_counters=True,
                          drafter=NGramDrafter() if spec else None,
                          spec_k=SPEC_K)
        for b in range(8):
            eng.submit(Request(rid=f"g{b}", tokens=np.asarray(prompts[b]),
                               max_new_tokens=32))
        return eng

    counters = {"paged_window": fp.paged_window_attention,
                "paged_decode": pa.paged_decode_attention,
                "rmsnorm_fwd": rn.rmsnorm_forward}
    label = cfg.name
    if moe:
        eng = engine(False)
        with MoEDispatchStats() as st:
            eng.step()                        # admission: prefill + a tick
        st.report("admission step (prefill 8 x 128, 4 groups of 256)")
        with MoEDispatchStats() as st:
            eng.step()
        st.report("decode tick (8 tokens, one group)")
        del eng
    fresh = []

    def admission():
        fresh[:] = [engine(False)]
        return fresh[0].step
    traced_step(torch, f"{label} admission step", admission, counters,
                {"paged_window": layers, "paged_decode": layers,
                 "rmsnorm_fwd": 2 * norms})
    eng = fresh.pop()
    traced_step(torch, f"{label} decode tick", lambda: eng.step, counters,
                {"paged_window": 0, "paged_decode": layers,
                 "rmsnorm_fwd": norms})
    del eng
    eng = engine(True)
    # admission and the first ticks: the continuations start to repeat,
    # so the n-gram drafter proposes in the measured ticks
    for _ in range(4):
        eng.step()
    if moe:
        with MoEDispatchStats() as st:
            eng.step()
        st.report("verify tick (8 x 5 tokens, one group of 40)")
    before = dict(eng.stats)
    traced_step(torch, f"{label} verify tick", lambda: eng.step, counters,
                {"paged_window": layers, "paged_decode": 0,
                 "rmsnorm_fwd": norms})
    delta = {k: eng.stats[k] - before[k] for k in
             ("prefills", "spec_ticks", "draft_proposed", "draft_accepted")}
    print(f"[trace] {label} verify tick(s): {delta}", flush=True)
    assert delta["prefills"] == 0 and delta["spec_ticks"] >= 1, delta
    del eng, params, model
    torch.cuda.empty_cache()


class KernelIdleRows:
    """While active, the plain paged versions (CPU tensors) return 0 in
    the rows that attend nothing, as the kernels do (the plain versions
    return NaN there, as the reference's do)."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self._orig = (ops.paged_decode_attention, ops.paged_window_attention)
        decode, window = self._orig

        def zero(out, lse):
            import torch
            live = lse.reshape(out.shape[0], out.shape[2], -1) > NEG_INF / 2
            return torch.where(live.permute(0, 2, 1)[..., None], out,
                               torch.zeros((), dtype=out.dtype))

        def dec(*a, **k):
            out, lse, cnt = decode(*a, **k)
            return zero(out, lse), lse, cnt

        def win(*a, **k):
            out, lse, cnt, ck, cv = window(*a, **k)
            return zero(out, lse), lse, cnt, ck, cv
        ops.paged_decode_attention, ops.paged_window_attention = dec, win
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.paged_decode_attention, ops.paged_window_attention = self._orig


def granite_smoke_check(torch, np):
    """granite's smoke config in float32, as is (G 2) and at Hq 6, Hkv 2
    (G 3), the same weights on the card (kernels) and on the CPU: the
    engine (paged, kernel counters and detectors on) on duplicated-prefix
    traffic, plain and with n-gram drafts under rollback and overwrite.
    Greedy tokens, stats, spec counters, store counts and the tier-3 and
    tier-4 findings must be equal on the card and on the CPU with the
    kernels' rows-that-attend-nothing (0; KernelIdleRows); whether they
    also equal the plain versions' (NaN there) is printed: an MoE layer
    routes those rows too, and they take expert capacity."""
    import contextlib
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.configs.base import ProfilerConfig
    from repro_torch.core.detectors import ServingDetectors
    from repro_torch.models.params import tree_map
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.spec import NGramDrafter

    def serve(model, params, mode):
        det = ServingDetectors(ProfilerConfig(enabled=True, seed=0))
        eng = ServeEngine(model, params, num_slots=3, max_len=48,
                          detectors=det, kv_dtype=torch.float32,
                          kv_layout="paged", page_size=4,
                          kernel_counters=True,
                          drafter=None if mode == "plain" else NGramDrafter(),
                          spec_k=SPEC_K, spec_rollback=mode == "rollback")
        for r in dup_prefix_requests(np, model.cfg.vocab_size, Request, n=7,
                                     shared_len=10, tails=(2, 12),
                                     gens=(4, 12)):
            eng.submit(r)
        eng.run(max_steps=300)
        return ({rid: r.generated for rid, r in eng.finished.items()},
                {k: v for k, v in eng.stats.items() if not k.endswith("_s")},
                {t: (dict(p.checked), dict(p.flagged)) for t, p in
                 (("tier 3", det.report), ("tier 4", det.kernel))})

    modes = ("plain", "rollback", "overwrite")
    for label, heads in (("G2", {}), ("G3", {"num_heads": 6,
                                             "num_kv_heads": 2})):
        cfg = dataclasses.replace(registry.get_config(GRANITE).smoke(),
                                  dtype="float32", **heads)
        model = build_model(cfg)
        cpu_params = model.init(0, device="cpu")
        res = {}
        for dev, idle in (("cpu", "NaN"), ("cpu", "0"), ("cuda", "0")):
            params = tree_map(lambda t: t.to(dev), cpu_params)
            ctx = (KernelIdleRows() if dev == "cpu" and idle == "0"
                   else contextlib.nullcontext())
            with ctx:
                for mode in modes:
                    res[(dev, idle, mode)] = serve(model, params, mode)
        same = [res[("cuda", "0", m)] == res[("cpu", "0", m)] for m in modes]
        plain = [res[("cuda", "0", m)] == res[("cpu", "NaN", m)]
                 for m in modes]
        st = {m: res[("cuda", "0", m)][1] for m in modes}
        print(f"[check] {GRANITE} smoke f32 {label} (Hq {cfg.num_heads}, "
              f"Hkv {cfg.num_kv_heads}), engine on the card vs the CPU "
              f"(plain / rollback / overwrite): tokens, stats, spec "
              f"counters, tier-3/4 checked and flagged equal {same}; equal "
              f"to the CPU with the plain versions' NaN rows {plain}; drafts "
              f"accepted {[st[m]['draft_accepted'] for m in modes[1:]]} of "
              f"{[st[m]['draft_proposed'] for m in modes[1:]]}, prefix hits "
              f"{st['plain']['prefix_hits']}", flush=True)
        assert all(same), {m: (res[("cpu", "0", m)], res[("cuda", "0", m)])
                           for m in modes}


# ----------------------------------------------------------------------
# phase 6: tier 1 (the concrete-run recorder) on the card
# ----------------------------------------------------------------------
def tier1_corpus_programs(torch, dev):
    """The tier-1 corpus (tests/test_torch_interpreter.py: twins of the
    reference's tests/test_core.py programs) on `dev`: name -> (fn,
    args)."""
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    zero_f = torch.zeros((), device=dev)

    def linear_search(keys, arr):
        c = zero_i
        for k in keys:
            c = c + (arr == k).any().to(torch.int32)
        return c

    def recompute(keys, x):
        c = zero_f
        for k in keys:
            c = c + torch.exp(x).sum() * k
        return c

    def wasteful(x):
        acc = 0.0
        for i in range(20):
            w = torch.exp(x) * (i + 1)
            acc = x.sum() + acc
        return acc, w

    def chain(x):
        for _ in range(6):
            x = torch.tanh(x * 1.1 + 0.3)
        return x.sum()

    def drift(keys, x, eps):
        c = zero_f
        for k in keys:
            c = c + (x * (1.0 + eps * k)).sum()
        return c

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    lin = torch.linspace(1, 2, 128, device=dev)
    return {
        "linear_search": (linear_search, (t([i % 7 for i in range(48)],
                                            torch.int32),
                                          t(range(256), torch.int32))),
        "recompute": (recompute, (t([1.0] * 24),
                                  torch.linspace(0, 1, 256, device=dev))),
        "wasteful": (wasteful, (torch.linspace(0, 1, 512, device=dev),)),
        "chain": (chain, (torch.linspace(0, 1, 2048, device=dev),)),
        "drift_small": (drift, (t(range(24)), lin, t(1e-5))),
        "drift_big": (drift, (t(range(24)), lin, t(0.5))),
    }


def tier1_corpus(torch):
    """6a: each corpus program profiled on CUDA tensors equals its CPU
    profile (totals, counts, pairs)."""
    from repro_torch.configs.base import ProfilerConfig
    from repro_torch.core.interpreter import profile_fn

    profs = {}
    for dev in ("cpu", "cuda"):
        for name, (fn, args) in tier1_corpus_programs(torch, dev).items():
            profs[name, dev] = profile_fn(
                fn, *args, cfg=ProfilerConfig(enabled=True, period=20,
                                              num_watchpoints=4), epochs=2)
    for name in tier1_corpus_programs(torch, "cpu"):
        cpu, card = profs[name, "cpu"], profs[name, "cuda"]
        same = card.to_dict() == cpu.to_dict()
        print(f"[tier1] corpus {name}: card equals CPU {same}; fractions "
              + ", ".join(f"{k} {v:.3f}" for k, v in
                          sorted(card.fractions().items()))
              + f"; checked {dict(sorted(card.checked.items()))}, flagged "
              f"{dict(sorted(card.flagged.items()))}", flush=True)
        assert same, (name, cpu.to_dict(), card.to_dict())


def tier1_smoke_check(torch, np):
    """6b: the decode microstep of qwen3-1.7b's smoke config in float32
    (batch 8, cache 161), the kernels on the card against the plain
    versions on the CPU, same weights: totals, samples and checked counts
    equal; flagged counts equal, or each difference printed with its
    pair."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.launch.serve import tier1_decode_profile
    from repro_torch.models.params import tree_map
    from repro_torch.models.zoo import build_model

    cfg = dataclasses.replace(registry.get_config("qwen3-1.7b").smoke(),
                              dtype="float32")
    model = build_model(cfg)
    cpu_params = model.init(0, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (8, 1))
    res = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev), cpu_params)
        res[dev] = tier1_decode_profile(
            model, params, torch.as_tensor(toks, dtype=torch.int32,
                                           device=dev), MAX_LEN, 0)
    (cpu, ic), (card, icard) = res["cpu"], res["cuda"]
    samples = {k: v for k, v in card.watchpoint_stats.items()}
    same = {"totals": card.totals == cpu.totals,
            "samples": samples == cpu.watchpoint_stats,
            "checked": card.checked == cpu.checked,
            "flagged": card.flagged == cpu.flagged}
    print(f"[tier1] smoke f32 decode microstep, card vs CPU: equal {same}; "
          f"{icard.stats['ops']} ops ({icard.stats['kernel_ops']} kernel), "
          f"{icard.stats['events']} events, totals {card.totals}, "
          f"checked {dict(sorted(card.checked.items()))}, flagged "
          f"{dict(sorted(card.flagged.items()))}", flush=True)
    if not same["flagged"]:
        pairs = {}
        for who, prof in (("cpu", cpu), ("card", card)):
            for f in prof.findings:
                pairs.setdefault((f.kind, f.c1, f.c2), {})[who] = f.count
        for (kind, c1, c2), n in sorted(pairs.items()):
            if n.get("cpu") != n.get("card"):
                print(f"[tier1]   {kind}: CPU {n.get('cpu', 0)}, card "
                      f"{n.get('card', 0)}: {' -> '.join(c1[-2:])} => "
                      f"{' -> '.join(c2[-2:])}", flush=True)
    assert same["totals"] and same["samples"] and same["checked"], same
    assert icard.stats["events"] == ic.stats["events"]


def tier1_full_width(torch, np, card_line, arch=QWEN3):
    """6c (and 9c for xlstm-1.3b): tier 1 on ``arch``'s decode microstep
    at full width (batch 8, cache 161, period 5000, 2 epochs; random
    weights from seed 0): the recording's operations, events and
    element-events, B5 launches in the recording and in the engine's
    passes, bytes snapshotted, the seconds of each part, peak device
    memory with the trace held and after it is dropped, the top
    findings. Returns the launches."""
    import gc
    import repro_torch.kernels.rmsnorm as rn
    from repro_torch.configs import registry
    from repro_torch.configs.base import ProfilerConfig
    from repro_torch.core.interpreter import JxInterpreter
    from repro_torch.launch.serve import tier1_decode_subject
    from repro_torch.models.zoo import build_model

    cfg = registry.get_config(arch)
    _, norms, attn_in, _ = launches_per_forward(cfg)
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    toks = torch.as_tensor(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (8, 1)),
        dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    decode = tier1_decode_subject(model, params, 8, MAX_LEN)
    interp = JxInterpreter(ProfilerConfig(enabled=True, period=5000, seed=0))

    # B5 launches before each engine pass: the recording's, then each
    # pass's (a pass replays the trace and runs no operation)
    passes = []
    replay = interp.engine.replay

    def counted(trace):
        passes.append(rn.rmsnorm_forward.launches)
        rn.rmsnorm_forward.launches = 0
        replay(trace)
    interp.engine.replay = counted
    rn.rmsnorm_forward.launches = 0
    t0 = time.perf_counter()
    prof = interp.profile(decode, toks, epochs=2)
    wall = time.perf_counter() - t0
    passes.append(rn.rmsnorm_forward.launches)
    recorded, replayed = passes[0], passes[1:]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated()
    st = interp.stats
    del interp, decode
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    gib = 2 ** 30
    print(f"[tier1] {arch} full width decode microstep (batch 8, cache "
          f"{MAX_LEN}, period 5000, 2 epochs) on {card_line}: "
          f"{st['ops']} ops ({st['kernel_ops']} kernel, {st['views']} "
          f"views), {st['events']} events, {st['element_events']:,} "
          f"element-events; B5 launches {recorded} in the recording, "
          f"{replayed} in the engine's passes; {st['snapshot_bytes']:,} "
          f"bytes snapshotted; recording {st['record_s']:.2f} s, engine "
          f"passes " + " / ".join(f"{t:.2f}" for t in st["epoch_s"])
          + f" s (epoch 0 over the recorded trace, then the replay), "
          f"{wall:.2f} s in all; device memory: params "
          f"{base / gib:.2f} GiB, peak {peak / gib:.2f} GiB, with the trace "
          f"held {held / gib:.2f} GiB, after it is dropped {after / gib:.2f} "
          f"GiB", flush=True)
    samples = {k: v["armed"] + v["replaced"] + v["rejected"]
               for k, v in prof.watchpoint_stats.items()}
    print(f"[tier1]   samples {samples}; checked "
          f"{dict(sorted(prof.checked.items()))}, flagged "
          f"{dict(sorted(prof.flagged.items()))}; fractions "
          + ", ".join(f"{k} {v:.4f}" for k, v in
                      sorted(prof.fractions().items())), flush=True)
    for f in prof.top(3):
        print(f"[tier1]   top: {f.kind} x{f.count} {f.bytes:.0f} B: "
              f"{' -> '.join(f.c1[-3:])} => {' -> '.join(f.c2[-3:])}",
              flush=True)
    assert recorded == norms and replayed == [0, 0], (recorded, replayed)
    # a decode's masked attention is one recorded kernel op a layer
    assert st["kernel_ops"] == norms + attn_in, st
    assert prof.total_load_events > 0 and prof.total_store_events > 0
    assert after <= base + 2 ** 26, (after, base)
    del params, model
    torch.cuda.empty_cache()
    return {"rmsnorm_fwd": recorded}


# ----------------------------------------------------------------------
# phases 7 and 8: granite-moe-3b-a800m training, and zamba2-1.2b (the
# hybrid family) served and trained, all at full width
# ----------------------------------------------------------------------
def check_slice_kernels(torch, timer, entries):
    """Phases 7a and 8a. B4 at granite-moe-3b-a800m's training heads (Hq
    24, Hkv 8, D 64: G 3) and zamba2-1.2b's (Hq 32, Hkv 32, D 64: G 1),
    B 4, S 1024, in bfloat16 and float32, two backward calls
    bit-identical, timed beside SDPA; B5 at zamba2's gate-norm width 4096
    (the edge of the backward's wide route) and at 4104 (past it), and at
    granite's training rows (4096 x 1536), in every dtype pair, strided
    rows too; B5 forward and backward timed at
    granite's training norm (4096 x 1536) and zamba2's gate norm (4096 x
    4096), the forward at zamba2's decode norms. The numbers go into the
    entries' ``by_shape``."""
    for arch, heads in ((GRANITE, GRANITE_HEADS), (ZAMBA, ZAMBA_HEADS)):
        nums = flash_on_training_inputs(torch, timer, arch, heads)
        for key, num in nums.items():
            entries[key]["by_shape"][f"{arch} train"] = num
    seed = 900
    for x_dtype, s_dtype in (("float32", "float32"), ("bfloat16", "float32"),
                             ("bfloat16", "bfloat16")):
        for rows, width, strided in ((8, 4096, False), (TB * TSEQ, 4096, False),
                                     (131, 4096, True), (77, 4104, False),
                                     (TB * TSEQ, 1536, False)):
            seed += 1
            rmsnorm_case(torch, rows, width, x_dtype, s_dtype, strided, seed)
    norm_train_times(torch, timer, entries, f"{GRANITE} train", TB * TSEQ,
                     1536)
    norm_train_times(torch, timer, entries, f"{ZAMBA} train gate norm",
                     TB * TSEQ, 4096)
    norm_forward_times(torch, timer, entries, f"{ZAMBA} decode", B, 2048)
    norm_forward_times(torch, timer, entries, f"{ZAMBA} decode gate norm",
                       B, 4096)


def train_family(torch, np, arch, steps=TRAIN_STEPS, timed=3, warmup=1,
                 **smoke_overrides):
    """A family's training at full width: one step under each remat mode
    that fits (``remat_check``), then ``launch.train.run`` (``steps``
    steps, detectors on) under "none" if it fits, else "full"; ``warmup``
    and ``timed`` timed steps and one traced step; the smoke config in
    float32, card against CPU. Returns the launches of the driver's
    run."""
    modes = remat_check(torch, np, arch)
    remat = "none" if "none" in modes else "full"
    launches = train_path(torch, np, arch, remat, steps)
    train_timing_and_trace(torch, np, arch, remat, timed, warmup)
    train_smoke_check(torch, np, arch, **smoke_overrides)
    torch.cuda.empty_cache()
    return launches


def token_loop_inputs(cfg, model, batch, prompt_len, dev):
    """The token-loop driver's cache arguments, as ``launch.serve.run``
    makes them (``frame_inputs``, bucketed): for the audio family
    ``(cache_kw, tier1_kw)``, for the other families ``(None, None)``."""
    from repro_torch.data.synthetic import batch_at
    from repro_torch.launch.serve import frame_inputs
    if cfg.family != "audio":
        return None, None
    frames = batch_at(cfg, batch, prompt_len, seed=0, step=0)["frames"]
    return frame_inputs(cfg, model, frames, seed=0, bucket_frames=True,
                        device=dev)[:2]


def token_loop_serve(torch, np, arch, profile_again=True):
    """Phases 8b, 9b and 10b. ``launch.serve.run`` for ``arch`` at full
    width (random weights from seed 0): the token-loop driver with the
    profiler on, batch 8, prompt 128 + 32, twice (equal tokens; the
    second without the profiler unless ``profile_again``), the
    kernels' launches counted: a decode forward's B5 launches a step
    (89 for zamba2-1.2b, 97 for xlstm-1.3b and whisper-large-v3) and one
    forward more in tier 1's recorded decode microstep, and for the audio
    family the encoder's (65) twice: in the run's ``init_cache`` and in
    tier 1's. A decode's attention is masked (the plain composition, as
    in the reference), so the run makes no B4 launch, except in the audio
    family's tier 1: its cache is the reference driver's, built from the
    frames as drawn without lengths, so its encoder (one non-causal B4 a
    layer) and its microstep's cross-attention (one a layer, Sq 1) take
    B4. Then one decode step traced. Returns the launches per run."""
    import repro_torch.kernels.flash_attention as fa
    import repro_torch.kernels.rmsnorm as rn
    from repro_torch.configs import registry
    from repro_torch.launch.serve import run
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.decode import make_serve_step

    cfg = registry.get_config(arch)
    sch = build_model(cfg).sched
    _, norms, _, _ = launches_per_forward(cfg)
    enc = encoder_norms(cfg) if sch.has_encoder else 0
    dec = norms - enc
    b4 = cfg.encoder_layers + sch.n_super if sch.has_encoder else 0
    by_run, outs = {}, []
    for label, profile in (("serve", True), ("serve, again", profile_again)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rn.rmsnorm_forward.launches = 0
        fa.flash_attention_forward.launches = 0
        t0 = time.perf_counter()
        out, merged, stats = run(arch, smoke=False, profile=profile, batch=8,
                                 prompt_len=128, gen=32, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"rmsnorm_fwd": rn.rmsnorm_forward.launches,
                    "flash_attention_fwd": fa.flash_attention_forward.launches}
        frames = ""
        if sch.has_encoder:
            frames = (f"; encoder frames: extent {stats['frames_run']}/"
                      f"{stats['frames_capacity']}, {stats['true_frames']} "
                      f"true + {stats['padded_frames']} padded")
        tier1 = (f"profile: {wall:.1f} s (tier 1 {tier1_seconds(stats)}); "
                 f"tiers {merged.tiers}" if profile
                 else f"no profile: {wall:.1f} s")
        print(f"[{arch}] {label}: full width, token loop, {tier1}; "
              f"launches {launches}; {stats['steps']} steps; prefill "
              f"{stats['prefill_tok_s']:.1f} tok/s, decode "
              f"{stats['decode_tok_s']:.1f} tok/s{frames}; peak device "
              f"memory over the run (with profile: tier 1's trace held at "
              f"its end) {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB", flush=True)
        assert stats["steps"] == 128 + 32 - 1, stats
        # a profiled run adds tier 1's encoder (in its cache) and its
        # recorded decode microstep
        assert launches["rmsnorm_fwd"] == dec * (stats["steps"] + profile) \
            + enc * (1 + profile), (launches, dec, enc)
        assert launches["flash_attention_fwd"] == b4 * profile, \
            (launches, b4)
        assert out.shape == (8, 32) and ((out >= 0)
                                         & (out < cfg.vocab_size)).all()
        if profile:
            assert merged.tiers == ([1, 2] if sch.has_encoder else [1]), \
                merged.tiers
            assert merged.total_load_events > 0 \
                and merged.total_store_events > 0
        outs.append(out)
        by_run[f"{arch} {label}"] = launches
    same = np.array_equal(outs[0], outs[1])
    print(f"[{arch}] two runs give equal tokens {same}", flush=True)
    assert same, "two runs of the same prompts gave different tokens"

    model = build_model(cfg)
    params = model.init(0, device="cuda")
    cache_kw, _ = token_loop_inputs(cfg, model, 8, 128, "cuda")
    cache = model.init_cache(params, 8, MAX_LEN, kv_dtype=torch.float32,
                             **(cache_kw or {}))
    params = model.decode_params(params)
    step = make_serve_step(model)
    tok = torch.as_tensor(outs[0][:, :1], device="cuda")
    for _ in range(4):
        tok, cache = step(params, cache, tok)

    def decode_step():
        def one():
            step(params, cache, tok)[0].cpu()
        return one
    traced_step(torch, f"{arch} decode step (8 slots)", decode_step,
                {"rmsnorm_fwd": rn.rmsnorm_forward,
                 "flash_attention_fwd": fa.flash_attention_forward},
                {"rmsnorm_fwd": dec, "flash_attention_fwd": 0})
    del cache, params, model
    torch.cuda.empty_cache()
    return by_run


def token_loop_smoke_check(torch, np, arch, **overrides):
    """Phases 8c, 9d and 10d. ``arch``'s smoke config in float32 (with
    ``overrides``), the same weights on the card (kernels) and on the
    CPU: the token-loop driver's greedy tokens (batch 4, prompt 16 + 8;
    for the audio family over the seeded frames, bucketed, and their
    lengths) equal, and tier 1 on the decode microstep: totals, samples
    and checked counts equal (flagged counts equal or each difference
    printed)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.launch.serve import _run_legacy, tier1_decode_profile
    from repro_torch.models.params import tree_map
    from repro_torch.models.zoo import build_model

    cfg = dataclasses.replace(registry.get_config(arch).smoke(),
                              dtype="float32", **overrides)
    model = build_model(cfg)
    cpu_params = model.init(0, device="cpu")
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (4, 16))
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 1))
    res = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev), cpu_params)
        cache_kw, tier1_kw = token_loop_inputs(cfg, model, 4, 16, dev)
        out, _ = _run_legacy(model, params, torch.as_tensor(
            prompts, dtype=torch.int32, device=dev), 8, cache_kw)
        prof, interp = tier1_decode_profile(
            model, params, torch.as_tensor(toks, dtype=torch.int32,
                                           device=dev), 25, 0, tier1_kw)
        res[dev] = (out, prof, interp.stats)
    (out_c, cpu, sc), (out_g, card, sg) = res["cpu"], res["cuda"]
    same = {"tokens": np.array_equal(out_c, out_g),
            "totals": card.totals == cpu.totals,
            "samples": card.watchpoint_stats == cpu.watchpoint_stats,
            "checked": card.checked == cpu.checked,
            "flagged": card.flagged == cpu.flagged}
    print(f"[check] {arch} smoke f32 ({cfg.num_layers} layers), the card vs "
          f"the CPU: equal {same}; tokens {out_g[0].tolist()}; tier 1 "
          f"{sg['ops']} ops ({sg['kernel_ops']} kernel), {sg['events']} "
          f"events, totals {card.totals}, checked "
          f"{dict(sorted(card.checked.items()))}, flagged "
          f"{dict(sorted(card.flagged.items()))}", flush=True)
    if not same["flagged"]:
        for kind in sorted(set(cpu.flagged) | set(card.flagged)):
            print(f"[check]   flagged {kind}: CPU {cpu.flagged.get(kind, 0)}, "
                  f"card {card.flagged.get(kind, 0)}", flush=True)
    assert (same["tokens"] and same["totals"] and same["samples"]
            and same["checked"]), same
    assert sg["events"] == sc["events"], (sg, sc)


# ----------------------------------------------------------------------
# phases 9 and 10: xlstm-1.3b (the ssm family) and whisper-large-v3 (the
# audio family), served and trained at full width
# ----------------------------------------------------------------------
XLSTM = "xlstm-1.3b"
WHISPER = "whisper-large-v3"
WHISPER_HEADS = (20, 20, 64)              # G 1, D 64


def check_new_family_kernels(torch, timer, entries):
    """Phases 9a and 10a. B4 at whisper-large-v3's heads (Hq 20, Hkv 20,
    D 64: G 1), B 4, in bfloat16 and float32: non-causal 1024 x 1024 (the
    encoder's self-attention and the decoder's cross-attention, 1024
    queries over 1024 frames) and causal 1024 (the decoder's own tokens),
    forward, lse and the three gradients against the plain versions, two
    calls bit-identical, timed beside SDPA; ragged non-causal cases: 1024
    queries over the capacity's 1500 frames, and tier 1's cross-attention
    of one query over 128 frames and encoder of 128 frames. B5 at
    whisper's width 1280 and xlstm's 2048 and 4096 (the mLSTM's out_norm)
    at their decode rows (8) and training rows (4096), strided rows too,
    in every dtype pair; B5's forward timed beside ``F.rms_norm`` at the
    decode rows and whisper's serving encoder rows (8 x 128), forward and
    backward at the training rows. The numbers go into the entries'
    ``by_shape``."""
    hq, hkv, d = WHISPER_HEADS
    for causal in (False, True):
        nums = flash_on_training_inputs(torch, timer, WHISPER, WHISPER_HEADS,
                                        causal)
        mask = "causal" if causal else "non-causal"
        for key, num in nums.items():
            entries[key]["by_shape"][f"{WHISPER} train {mask}"] = num
    for dtype, sq, skv in (("float32", TSEQ, 1500), ("bfloat16", TSEQ, 1500),
                           ("bfloat16", 1, 128), ("bfloat16", 128, 128)):
        flash_case(torch, dtype, sq, skv, False, seed=sq + skv, d=d, hq=hq,
                   hkv=hkv)
    seed = 1300
    for x_dtype, s_dtype in (("float32", "float32"), ("bfloat16", "float32"),
                             ("bfloat16", "bfloat16")):
        for rows, width, strided in ((8, 1280, False), (1024, 1280, False),
                                     (TB * TSEQ, 1280, False),
                                     (131, 1280, True), (8, 2048, False),
                                     (TB * TSEQ, 2048, False),
                                     (TB * TSEQ, 4096, False)):
            seed += 1
            rmsnorm_case(torch, rows, width, x_dtype, s_dtype, strided, seed)
    norm_forward_times(torch, timer, entries, f"{WHISPER} decode", B, 1280)
    norm_forward_times(torch, timer, entries, f"{WHISPER} encoder",
                       B * 128, 1280)
    norm_train_times(torch, timer, entries, f"{WHISPER} train", TB * TSEQ,
                     1280)
    norm_forward_times(torch, timer, entries, f"{XLSTM} decode", B, 2048)
    norm_forward_times(torch, timer, entries, f"{XLSTM} decode out_norm", B,
                       4096)
    norm_train_times(torch, timer, entries, f"{XLSTM} train", TB * TSEQ,
                     2048)
    norm_train_times(torch, timer, entries, f"{XLSTM} train out_norm",
                     TB * TSEQ, 4096)


def whisper_bucketing(torch, np):
    """Phase 10c. whisper-large-v3 at full width: frames (8, 1500, 1280)
    from the seeded stream, lengths from ``frame_lengths`` (187 to 750),
    right-padded to the bucket (1024) and to capacity (1500), each through
    ``init_cache`` (the masked encoder, the cross K/V and ``xvalid``) and
    the one-token step over a 16-token prompt and 8 greedy tokens, in
    float32 (the gate: equal greedy tokens, as every token-parity check
    of the port is made in float32) and in the config's bfloat16
    (reported: masked keys add exact zeros, but a row's sums depend on
    the extent through cuBLAS's choice of kernel and the softmax's
    blocking, and bfloat16 rounding carries a last-bit difference through
    32 layers); prints the largest logit difference and whether the cross
    K/V rows below each length are the same bits."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_at, frame_lengths
    from repro_torch.launch.serve import _prep_frames
    from repro_torch.models.zoo import build_model

    base = registry.get_config(WHISPER)
    data = batch_at(base, 8, base.encoder_frames, seed=0, step=0)
    lens = frame_lengths(base, 8, seed=0)
    prompts = torch.as_tensor(data["tokens"][:, :16], device="cuda")
    params = build_model(base).init(0, device="cuda")
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        model = build_model(cfg)
        dparams = model.decode_params(params)
        res = {}
        for bucket in (True, False):
            frames, lens_c, st = _prep_frames(cfg, model, data["frames"],
                                              lens, bucket)
            t0 = time.perf_counter()
            with torch.no_grad():
                cache = model.init_cache(
                    params, 8, 16 + 8 + 1, kv_dtype=torch.float32,
                    frames=torch.as_tensor(frames, device="cuda"),
                    frame_lengths=torch.as_tensor(lens_c, device="cuda"))
                toks, logits = [], []
                for t in range(16 + 8 - 1):
                    inp = prompts[:, t:t + 1] if t < 16 else toks[-1]
                    lg, cache = model.decode_step(dparams, cache, inp)
                    if t >= 15:
                        toks.append(lg[:, -1:].argmax(dim=-1)
                                    .to(torch.int32))
                        logits.append(lg[:, -1].float())
            torch.cuda.synchronize()
            sub = cache["main"]["b0_encdec"]
            res[bucket] = (torch.cat(toks, 1).cpu().numpy(),
                           torch.stack(logits), sub["xk"], sub["xv"], st,
                           time.perf_counter() - t0)
            del cache, sub
        (tb, lb, kb, vb, sb, wb), (tc, lc, kc, vc, sc, wc) = \
            res[True], res[False]
        same = np.array_equal(tb, tc)
        diff = float((lb - lc).abs().max())
        kv_diff, kv_same = 0.0, True
        for b, n in enumerate(lens_c):
            for x, y in ((kb, kc), (vb, vc)):
                kv_diff = max(kv_diff, float(
                    (x[:, b, :n] - y[:, b, :n]).abs().max()))
                kv_same = kv_same and torch.equal(x[:, b, :n], y[:, b, :n])
        print(f"[whisper] bucketing at full width, {dtype}: lengths "
              f"{lens_c.tolist()}; extent {sb['frames_run']} "
              f"({sb['padded_frames']} padded rows, {sb['padded_bytes']} "
              f"padded bytes, {wb:.2f} s) against {sc['frames_run']} "
              f"({sc['padded_frames']} padded rows, {sc['padded_bytes']} "
              f"padded bytes, {wc:.2f} s); greedy tokens equal {same} "
              f"(bucketed {tb[0].tolist()}, capacity {tc[0].tolist()}); "
              f"largest logit difference {diff:.3e}; cross K/V rows below "
              f"each length bit-identical {kv_same} (largest difference "
              f"{kv_diff:.3e})", flush=True)
        assert sb["frames_run"] == 1024 and sc["frames_run"] == 1500, \
            (sb, sc)
        if dtype == "float32":
            assert same, "bucketed and capacity frames gave other tokens"
        del res, kb, vb, kc, vc, dparams, model
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()


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
    tok = re.compile(r"f|13__nv_bfloat16|6__half|S\d*_|Li(\d+)E")
    args, rest = [], m.group(2)
    while rest and not rest.startswith("E"):
        t = tok.match(rest)
        if t is None:
            break
        w = t.group(0)
        args.append("f32" if w == "f" else "bf16" if w[0] == "1" else
                    "f16" if w[0] == "6" else
                    args[-1] if w[0] == "S" else t.group(1))
        rest = rest[t.end():]
    return f"{m.group(1)}<{','.join(args)}>"


def sass_counts(lib, patterns):
    """Instructions matching each of ``patterns`` (name -> regex) per
    kernel of a built library, from ``cuobjdump -sass``; None where the
    toolkit has no cuobjdump."""
    import re
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
        counts[kernel_label(sec.split("\n", 1)[0].strip())] = {
            k: len(re.findall(rx, sec)) for k, rx in patterns.items()}
    return counts


# B5's forward stores: y by 16-byte (8-byte for 16-bit rows of 4 elements
# a lane) vector stores, rstd by one 4-byte store a row
FWD_STORES = {"16-byte": r"STG\.E\.128\s", "8-byte": r"STG\.E\.64\s",
              "4-byte": r"STG\.E\s"}


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
        hmma = sass_counts(build.library_path(name), {"HMMA": "HMMA"})
        print(f"[build] {name} HMMA instructions per kernel (cuobjdump "
              f"-sass): " + ("not measured (no cuobjdump)" if hmma is None
                             else ", ".join(f"{k} {n['HMMA']}" for k, n
                                            in sorted(hmma.items()))),
              flush=True)
    stores = sass_counts(build.library_path("rmsnorm"), FWD_STORES)
    if stores is None:
        print("[build] rmsnorm forward stores: not measured (no cuobjdump)")
        return
    fwd = {k: n for k, n in sorted(stores.items())
           if k.startswith(("rmsnorm_fwd_narrow", "rmsnorm_fwd_wide"))}
    print("[build] rmsnorm forward global stores per kernel (cuobjdump "
          "-sass; 16-byte / 8-byte / 4-byte): " + ", ".join(
              f"{k} {n['16-byte']}/{n['8-byte']}/{n['4-byte']}"
              for k, n in fwd.items()), flush=True)
    for k, n in fwd.items():
        # no y store split into 4-byte stores: those are rstd's, one for
        # each of a narrow lane's rows (the last template argument) and
        # one for a wide row
        rows = int(k[:-1].split(",")[-1]) if "narrow" in k else 1
        assert n["4-byte"] <= rows and n["16-byte"] + n["8-byte"] >= rows, \
            (k, n)


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
    t_start = time.perf_counter()

    def phase(name, fn, *args, **kwargs):
        """Run one phase, printing its seconds."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s "
              f"({time.perf_counter() - t_start:.1f} s since the build)",
              flush=True)
        return out

    entries = phase("2 serving kernels", check_kernels, torch, np, timer)
    phase("2c granite kernels", check_granite_kernels, torch, np, timer,
          entries)
    entries.update(phase("2b rmsnorm", check_rmsnorm, torch, timer))
    phase("2d rmsnorm granite", check_rmsnorm_granite, torch, timer, entries)
    phase("2e rmsnorm serving", check_rmsnorm_serving, torch, timer, entries)
    entries.update(phase("4a flash attention", check_flash, torch, timer))
    entries["silent_compare"] = phase("4b silent compare", check_silent,
                                      torch, timer)
    phase("7a/8a slice kernels", check_slice_kernels, torch, timer, entries)
    phase("9a/10a new families' kernels", check_new_family_kernels, torch,
          timer, entries)
    # each main path is driven with the launch counts set to 0 just
    # before it and read just after
    by_path = {}
    by_path["serve"], stats = phase("3 main path", main_path, torch, np)
    phase("3 smoke", small_reference_check, torch, np)
    by_path.update(phase("3b spec", spec_path, torch, np))
    phase("3b smoke", spec_smoke_check, torch, np)
    by_path.update(phase("3c granite serve", granite_path, torch, np))
    phase("3c smoke", granite_smoke_check, torch, np)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    by_path["train"] = phase("5 train", train_path, torch, np)
    phase("5 timing", train_timing_and_trace, torch, np)
    phase("5 smoke", train_smoke_check, torch, np)
    phase("5 remat", remat_check, torch, np)
    phase("6a corpus", tier1_corpus, torch)
    phase("6b smoke", tier1_smoke_check, torch, np)
    torch.cuda.empty_cache()
    by_path["tier1"] = phase("6c tier 1", tier1_full_width, torch, np, card)
    torch.cuda.empty_cache()
    by_path["granite train"] = phase("7 granite train", train_family, torch,
                                     np, GRANITE)
    by_path.update(phase("8b zamba2 serve", token_loop_serve, torch, np,
                         ZAMBA, profile_again=False))
    phase("8c zamba2 smoke", token_loop_smoke_check, torch, np, ZAMBA,
          num_layers=8)
    by_path["zamba2 train"] = phase("8 zamba2 train", train_family, torch,
                                    np, ZAMBA, num_layers=8)
    by_path.update(phase("9b xlstm serve", token_loop_serve, torch, np,
                         XLSTM))
    by_path["xlstm tier1"] = phase("9c xlstm tier 1", tier1_full_width,
                                   torch, np, card, XLSTM)
    phase("9d xlstm smoke", token_loop_smoke_check, torch, np, XLSTM)
    by_path.update(phase("10b whisper serve", token_loop_serve, torch, np,
                         WHISPER))
    phase("10c whisper bucketing", whisper_bucketing, torch, np)
    phase("10d whisper smoke", token_loop_smoke_check, torch, np, WHISPER)
    by_path["whisper train"] = phase("10e whisper train", train_family,
                                     torch, np, WHISPER)
    # last: its traced step holds ~0.9 M kernels, after which this
    # process's profiler traces were seen to come back empty
    # xlstm's steps are host-bound (~22 s: the sLSTM's token loop), so its
    # driver takes 2 steps and one step is timed, without a warm-up
    by_path["xlstm train"] = phase("9e xlstm train", train_family, torch,
                                   np, XLSTM, steps=2, timed=1, warmup=0,
                                   resync=True)

    import math
    for key, e in entries.items():
        per = {path: n[key] for path, n in by_path.items() if key in n}
        e["launches"] = sum(per.values())
        e["launches_by_path"] = per
        bad = [k for k, v in e.items() if isinstance(v, float)
               and not math.isfinite(v)]
        bad += [f"{shape}.{k}" for shape, nums in e.get("by_shape", {}).items()
                for k, v in nums.items() if isinstance(v, float)
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
