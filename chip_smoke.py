#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one
NVIDIA GPU: the serving path and the training path.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit), the torch, CUDA
   and nvcc versions, and builds the hand-written CUDA kernels from
   ``src/repro_torch/csrc`` (timed);
2. holds every kernel of the serving path against its plain PyTorch
   version on the card, at the main path's shapes (qwen3-1.7b: Hq 16,
   Hkv 8, D 128, page 16, 8 slots, windows of 16 and 128) on a hostile
   page table (out-of-order pages, partial last pages, unmapped holes
   and tails, an idle slot, a write past the table), for float32 and
   bfloat16 pools: pools and counters must be equal, outputs and lse
   within 1e-4 (float32 activations) or 2e-2 (bfloat16) on rows that
   attend something; and times kernel, plain version and a PyTorch
   library call (SDPA over the gathered view, a yardstick the port never
   calls) with CUDA events, L2 flushed before every launch;
3. runs the main path at full width: ``repro_torch.launch.serve.run``
   for qwen3-1.7b with the paged KV heap and the profiler on (random
   weights from seed 0, 28 layers), with the kernels' launch counts set
   to 0 just before and read just after; then one engine with kernel
   counters on duplicated-prefix traffic (prefix hits, copy-on-write,
   slot recycling, history in the window kernel); and checks the
   results: launches per layer and step, finite tokens in range, a
   merged profile with tier-3 and tier-4 entries, and, on the smoke
   config in float32, the same greedy tokens and store counts from the
   kernels on the card as from the plain versions on the CPU; and traces
   one admission step and one decode tick at full width with
   torch.profiler (device time by kernel kind, device busy share);
4. holds the training kernels against their plain versions on the card:
   flash attention forward and backward at the training path's shapes
   (B 4, S 1024, Hq 16, Hkv 8, D 128) in bfloat16 and float32, and at a
   ragged length, Sq != Skv and without the causal mask (out and lse
   within 1e-4 / 2e-2, dq, dk, dv within 2e-4 / 3e-2 of the plain
   gradient's largest magnitude, at float32 / bfloat16); the silent
   compare on a bfloat16 tensor the size of the embedding leaf, on an
   f32 leaf and on edge cases (counts equal exactly); and times them as
   in 2 (the library yardsticks: SDPA forward, SDPA forward + backward
   through autograd; none for the silent compare);
5. runs the training path at full width: ``repro_torch.launch.train.run``
   for qwen3-1.7b, 4 steps of batch 4 x 1024 tokens with the training
   detectors on (random weights from seed 0, 28 layers), with the
   kernels' launch counts set to 0 just before and read just after, and
   checks the launches (28 forward and 28 backward flash launches per
   step, one silent compare per checked parameter store), finite losses
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
    for S in (16, 128):
        w = np.array([0, 72, 32, 0, 17, 0, 9, -(S + 1)], np.int32)
        w = np.minimum(w, MAX_LEN - S)
        w[-1] = -(S + 1)
        cases += [(f"window S={S} store", S, w, True),
                  (f"window S={S} defer", S, w, False)]
    return cases


def bytes_flops(np, name, S, idx, pt, store, act_isz, pool_isz):
    """Least bytes moved and flops done by one call on these inputs: each
    input read once, each output written once, history counted as the
    mapped rows the call attends, stores as the rows that land."""
    row = 2 * HKV * D * pool_isz                       # one K+V pool row
    nbytes = (B * S * HQ * D * act_isz * 2             # q in, out
              + 2 * B * S * HKV * D * act_isz          # new/window K, V
              + B * HQ * S * 4 + B * 3 * 4 + pt.size * 4 + idx.size * 4)
    flops = 0
    for b in range(B):
        i0 = int(idx[b])
        mapped = [pt[b, p // PS] >= 0 if 0 <= p < M * PS else False
                  for p in range(max(i0, 0) + S)]
        hist = sum(mapped[:max(i0, 0)])
        nbytes += hist * row
        win_ok = [(0 <= i0 + c < M * PS) and (not store or mapped[i0 + c])
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


def run_case(torch, act, pool_dt, name, S, idx_np, pt_np, store, seed):
    """Build one case's inputs on the card, run the kernel and its plain
    version on copies of the pools, check them against each other and
    print the result. Returns (max |err|, kernel, plain, inputs)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import paged_window_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention

    adt, pdt = getattr(torch, act), getattr(torch, pool_dt)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    q = randn(B, S, HQ, D, dtype=adt)
    kn = randn(B, S, HKV, D, dtype=adt)
    vn = randn(B, S, HKV, D, dtype=adt)
    pool_k = randn(P, PS, HKV, D, dtype=pdt)
    pool_v = randn(P, PS, HKV, D, dtype=pdt)
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
        def kernel(pk, pv):
            out, lse, cnt, _, _ = paged_window_attention(
                *args, pk, pv, pt, idx, store=store)
            return out, lse, cnt

        def plain(pk, pv):
            out, lse, _, _, cnt = ref.paged_window_ref(
                *args, pk, pv, pt, idx, store=store)
            return out, lse, cnt
    kk, kv = pool_k.clone(), pool_v.clone()
    pk_, pv_ = pool_k.clone(), pool_v.clone()
    o_k, l_k, c_k = kernel(kk, kv)
    o_p, l_p, c_p = plain(pk_, pv_)
    torch.cuda.synchronize()
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
    print(f"[kernels] {name:20s} act {act:8s} pool {pool_dt:8s} "
          f"pools+counters equal {same} | max |err| {err:.3e} "
          f"(tol {TOL[act]}) | idle rows 0 {dead_ok} | counters "
          f"{c_k.sum(0).tolist()}", flush=True)
    if not (same and err <= TOL[act] and dead_ok):
        raise AssertionError(f"{name} ({act}/{pool_dt}) disagrees with its "
                             f"plain version")
    return err, kernel, plain, (q, kn, vn, pool_k, pool_v, pt, idx)


def check_kernels(torch, np, timer):
    """Phase 2. Hostile tables in every dtype pair, then the main path's
    own inputs (bf16 activations, f32 pool; decode with every slot at
    position 144, prefill of 128 tokens at 0), timed. Returns the
    kernels' JSON entries (all but launches)."""
    rng = np.random.default_rng(0)
    seed = 0
    for act, pool_dt in (("bfloat16", "float32"), ("bfloat16", "bfloat16"),
                         ("float32", "float32")):
        for name, S, idx_np, store in kernel_cases(np):
            seed += 1
            run_case(torch, act, pool_dt, name, S, idx_np,
                     hostile_table(np, rng, idx_np, S), store, seed)

    entries = {}
    for key, name, S, pos in (("paged_decode", "decode", 1, 144),
                              ("paged_window", "window S=128 store", 128, 0)):
        idx_np = np.full(B, pos, np.int32)
        pt_np = main_path_table(np, rng)
        err, kernel, plain, inputs = run_case(
            torch, "bfloat16", "float32", name, S, idx_np, pt_np, True,
            seed=100 + S)
        q, kn, vn, pool_k, pool_v, pt, idx = inputs
        # store mode rewrites the same rows on every call
        kk, kv = pool_k.clone(), pool_v.clone()
        ms = timer(lambda: kernel(kk, kv))
        pk_, pv_ = pool_k.clone(), pool_v.clone()
        plain_ms = timer(lambda: plain(pk_, pv_))
        library_ms = time_library(torch, timer, q, kn, vn, pool_k, pool_v,
                                  pt, idx, S)
        nbytes, flops = bytes_flops(np, name, S, idx_np, pt_np, True,
                                    q.element_size(), pool_k.element_size())
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        entries[key] = {
            "name": key, "route": "cuda",
            "source": f"src/repro_torch/csrc/{key}.cu",
            "replaces": ("src/repro/kernels/paged_attention.py:120"
                         if key == "paged_decode" else
                         "src/repro/kernels/flash_prefill.py:171"),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}
        print(f"[kernels] {key} on the main path's inputs ({name}, B {B}, "
              f"position {pos}, bf16 act, f32 pool): kernel {ms:.4f} ms | "
              f"plain {plain_ms:.4f} ms | SDPA over the gathered view "
              f"{library_ms:.4f} ms | bound {max(t_bytes, t_ops):.4f} ms "
              f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)", flush=True)
    return entries


def time_library(torch, timer, q, kn, vn, pool_k, pool_v, pt, idx, S):
    """One SDPA call on the gathered, masked view of the same inputs (the
    gather and the mask are built outside the timed call)."""
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
    return timer(lambda: F.scaled_dot_product_attention(qt, k, v,
                                                        attn_mask=mask))


# ----------------------------------------------------------------------
# phase 4: the training kernels against their plain versions
# ----------------------------------------------------------------------
TB, TSEQ = 4, 1024                        # the training path's batch


def flash_case(torch, dtype, sq, skv, causal, seed):
    """Forward and backward kernels against their plain versions on one
    set of inputs (the backward versions both get the kernel's out and
    lse). Returns (out/lse error, relative gradient error, inputs)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_forward)
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dt)
    q, k, v = (randn(TB, sq, HQ, D), randn(TB, skv, HKV, D),
               randn(TB, skv, HKV, D))
    dout = randn(TB, sq, HQ, D)
    out, lse = flash_attention_forward(q, k, v, causal)
    grads = flash_attention_backward(q, k, v, out, lse, dout, causal)
    want_out, want_lse = ref.flash_attention_ref(q, k, v, causal)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal)
    torch.cuda.synchronize()
    err = max(float((out.float() - want_out.float()).abs().max()),
              float((lse - want_lse).abs().max()))
    err_g = max(float((a.float() - b.float()).abs().max())
                / max(float(b.float().abs().max()), 1e-30)
                for a, b in zip(grads, want))
    tol, tol_g = FLASH_TOL[dtype]
    print(f"[kernels] flash attention {dtype:8s} Sq {sq:4d} Skv {skv:4d} "
          f"causal {causal!s:5s} | out/lse max |err| {err:.3e} (tol {tol}) "
          f"| dq/dk/dv max rel err {err_g:.3e} (tol {tol_g})", flush=True)
    if not (err <= tol and err_g <= tol_g):
        raise AssertionError(f"flash attention ({dtype}, {sq}x{skv}, "
                             f"causal {causal}) disagrees with its plain "
                             f"version")
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
    and non-causal cases; timed at the training path's own inputs
    (bfloat16, causal). Returns the forward and backward JSON entries."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_forward)
    for dtype in ("float32", "bfloat16"):
        for sq, skv, causal in ((TSEQ, TSEQ, True), (1000, 1000, True),
                                (1000, TSEQ, True), (TSEQ, 1000, True),
                                (1000, TSEQ, False)):
            flash_case(torch, dtype, sq, skv, causal, seed=sq + skv)
    err, err_g, (q, k, v, out, lse, dout) = flash_case(
        torch, "bfloat16", TSEQ, TSEQ, True, seed=1)
    fwd_ms = timer(lambda: flash_attention_forward(q, k, v, True))
    bwd_ms = timer(lambda: flash_attention_backward(q, k, v, out, lse, dout,
                                                    True))
    fwd_plain = timer(lambda: ref.flash_attention_ref(q, k, v, True))
    bwd_plain = timer(lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse,
                                                          dout, True))
    # SDPA on the (B, H, S, D) layout, transposed outside the timed call
    qt, kt, vt, dt_ = (x.transpose(1, 2).contiguous()
                       for x in (q, k, v, dout))

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(a, b, c, is_causal=True,
                                              enable_gqa=True)
    fwd_lib = timer(lambda: sdpa(qt, kt, vt))
    leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
    bwd_lib = timer(lambda: torch.autograd.backward(sdpa(*leaves), dt_))
    isz = q.element_size()
    entries = {}
    for key, ms, plain_ms, lib_ms, e, back in (
            ("flash_attention_fwd", fwd_ms, fwd_plain, fwd_lib, err, False),
            ("flash_attention_bwd", bwd_ms, bwd_plain, bwd_lib, err_g, True)):
        nbytes, flops = flash_bytes_flops(TSEQ, TSEQ, isz, True, back)
        b_ms, by = bound(nbytes, flops, PEAK_FLOPS["bfloat16"])
        entries[key] = {
            "name": key, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:93",
            "max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms}
        print(f"[kernels] {key} on the training inputs (B {TB}, S {TSEQ}, "
              f"Hq {HQ}, Hkv {HKV}, D {D}, bf16, causal): kernel "
              f"{ms:.4f} ms | plain {plain_ms:.4f} ms | "
              f"{'SDPA fwd+bwd' if back else 'SDPA fwd'} {lib_ms:.4f} ms | "
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
    import repro_torch.kernels.silent_compare as sc
    from repro_torch.configs import registry
    from repro_torch.launch.train import run

    cfg = registry.get_config("qwen3-1.7b")
    counters = (fa.flash_attention_forward, fa.flash_attention_backward,
                sc.silent_compare)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    losses, merged = run("qwen3-1.7b", smoke=False, steps=TRAIN_STEPS,
                         batch=TB, seq=TSEQ, profile=True, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fa.flash_attention_forward.launches,
                "flash_attention_bwd": fa.flash_attention_backward.launches,
                "silent_compare": sc.silent_compare.launches}
    checked = merged.checked.get("silent_param_store", 0)
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
    from repro_torch.configs import registry
    from repro_torch.configs.base import ProfilerConfig
    from repro_torch.core.detectors import ServingDetectors
    from repro_torch.launch.serve import run
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = registry.get_config("qwen3-1.7b")
    layers = cfg.num_layers

    pa.paged_decode_attention.launches = 0
    fp.paged_window_attention.launches = 0
    t0 = time.perf_counter()
    out, merged, stats = run("qwen3-1.7b", smoke=False, kv="paged",
                             profile=True, batch=8, prompt_len=128, gen=32,
                             device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode": pa.paged_decode_attention.launches,
                "paged_window": fp.paged_window_attention.launches}
    print(f"[main] qwen3-1.7b full width, paged, profile: {wall:.1f} s; "
          f"launches {launches}; ticks {stats['ticks']}, prefills "
          f"{stats['prefills']}; prefill {stats['prefill_tok_s']:.1f} tok/s, "
          f"decode {stats['decode_tok_s']:.1f} tok/s", flush=True)
    assert launches["paged_decode"] == layers * stats["ticks"] > 0, launches
    assert launches["paged_window"] == layers * stats["prefills"] > 0, launches
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
    assert prof.tiers == [3, 4] and prof.checked["kernel_dead_store"] > 0
    assert sum(prof.checked.get(k, 0) for k in
               ("dead_kv_store", "silent_kv_store", "silent_prefix_load")) > 0
    trace_steps(torch, np, eng, cfg.vocab_size, Request)
    del eng, params, model
    torch.cuda.empty_cache()
    return launches, stats


def _kernel_kind(name: str) -> str:
    if "paged_decode_kernel" in name:
        return "paged_decode"
    if "window_attn_kernel" in name or "window_store_kernel" in name:
        return "paged_window"
    if "flash_fwd_kernel" in name:
        return "flash_attention_fwd"
    if "flash_bwd_" in name or "flash_delta_kernel" in name:
        return "flash_attention_bwd"
    if "silent_count_kernel" in name:
        return "silent_compare"
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
    t0 = time.perf_counter()
    logs = build.build()
    print(f"[build] {len(logs)} CUDA sources compiled for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    timer = Timer(torch)
    entries = check_kernels(torch, np, timer)
    entries.update(check_flash(torch, timer))
    entries["silent_compare"] = check_silent(torch, timer)
    launches, stats = main_path(torch, np)
    small_reference_check(torch, np)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches.update(train_path(torch, np))
    train_timing_and_trace(torch, np)
    train_smoke_check(torch, np)

    for key, e in entries.items():
        e["launches"] = launches[key]
    print(json.dumps({"kernels": [entries[k] for k in (
        "paged_decode", "paged_window", "flash_attention_fwd",
        "flash_attention_bwd", "silent_compare")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
