"""Rank bodies and shared inputs of the port's multi-rank CPU tests.

The tests start gloo ranks with ``repro_torch.launch.mesh.launch``
(spawned processes), which import the function they run by name: the
bodies live here, in a module that imports neither JAX nor the
reference, so a rank loads only torch and the port. The input builders
use numpy alone, so the reference's subprocesses build the same inputs.
"""
import dataclasses

import numpy as np

# ----------------------------------------------------------------------
# Flash-decoding inputs (test_torch_flash_decode.py)
# ----------------------------------------------------------------------
HEADS = (4, 2, 16)                  # Hq, Hkv, D: G 2
PAGES, PAGE, M = 16, 8, 4           # pool pages, page size, table width
SMAX = 64                           # dense cache extent
TARGETS = (1, 5, 9, 13)             # slot 0's new-row page, one per
                                    # chunk of 4 (and two per chunk of 8)
DENSE_IDX = (5, 21, 37, 53)         # a decode row in each chunk of 16


def paged_table(t: int) -> np.ndarray:
    """Hostile (4, M) page table of case ``t``: slot 0 writes its new row
    on page TARGETS[t]; slots 0 and 1 share page 10; slot 2 is idle; slot
    3 has an unmapped hole and writes its verify window past the
    table."""
    return np.array([[3, 10, TARGETS[t], -1],
                     [10, 2, 12, -1],
                     [7, -1, -1, -1],
                     [0, -1, 6, 11]], np.int32)


def flash_inputs(t: int) -> dict:
    """Case ``t``'s seeded float32 inputs of the four sharded functions."""
    Hq, Hkv, D = HEADS
    rng = np.random.default_rng(100 + t)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    B, W = 4, 3
    return {
        "q": r(B, 1, Hq, D), "kn": r(B, 1, Hkv, D), "vn": r(B, 1, Hkv, D),
        "qw": r(B, W, Hq, D), "knw": r(B, W, Hkv, D), "vnw": r(B, W, Hkv, D),
        "pk": r(PAGES, PAGE, Hkv, D), "pv": r(PAGES, PAGE, Hkv, D),
        "pt": paged_table(t),
        "pidx": np.array([18, 13, -2, 29], np.int32),
        "vidx": np.array([17, 12, -4, 30], np.int32),
        "ck": r(2, SMAX, Hkv, D), "cv": r(2, SMAX, Hkv, D),
        "dq": r(2, 1, Hq, D), "dkn": r(2, 1, Hkv, D), "dvn": r(2, 1, Hkv, D),
        "didx": np.int32(DENSE_IDX[t]),
        "xq": r(2, 3, Hq, D),
    }


def flash_rank(mesh, cases):
    """Every case through the port's four sharded functions on this
    rank's chunks; returns per case the outputs, the rank's chunks after
    the stores and the pool-wide counters."""
    import torch
    from repro_torch.serve import flash_decode as FD
    from repro_torch.sharding.rules import PS, local_slice
    n, r = mesh.shape["model"], mesh.index("model")
    ax = dict(mesh=mesh, batch_axes=("data",), seq_axes=("model",))
    out = []
    for t in cases:
        x = {k: torch.from_numpy(np.array(v)) for k, v in
             flash_inputs(t).items()}

        def chunk(a, dim):
            spec = PS(*([None] * dim + ["model"]))
            return local_slice(a, spec, mesh).clone()
        res = {}
        pk, pv = chunk(x["pk"], 0), chunk(x["pv"], 0)
        o, pk, pv, cnt = FD.decode_paged_attention_sharded(
            x["q"], x["kn"], x["vn"], pk, pv, x["pt"], x["pidx"], **ax)
        row = 2 * HEADS[1] * HEADS[2]
        res["decode"] = (o, pk, pv, FD.global_counts(
            cnt, x["pt"], x["pidx"], 1, PAGE, row, ("model",), mesh), cnt)
        pk, pv = chunk(x["pk"], 0), chunk(x["pv"], 0)
        o, pk, pv, cnt = FD.verify_paged_attention_sharded(
            x["qw"], x["knw"], x["vnw"], pk, pv, x["pt"], x["vidx"], **ax)
        res["verify"] = (o, pk, pv, FD.global_counts(
            cnt, x["pt"], x["vidx"], 3, PAGE, row, ("model",), mesh), cnt)
        ck, cv = chunk(x["ck"], 1), chunk(x["cv"], 1)
        o, ck, cv = FD.decode_attention_sharded(
            x["dq"], x["dkn"], x["dvn"], ck, cv, x["didx"], **ax)
        res["dense"] = (o, ck, cv)
        res["cross"] = (FD.cross_attention_sharded(
            x["xq"], chunk(x["ck"], 1), chunk(x["cv"], 1), **ax),)
        out.append({k: tuple(a.numpy() for a in v) for k, v in res.items()})
    return {"rank": r, "n": n, "cases": out}


def comm_rank(mesh):
    """The collectives of sharding/comm.py on rank-distinct tensors."""
    import torch
    from repro_torch.sharding import comm
    r = mesh.index("model")
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
    b = (torch.arange(4, dtype=torch.float32) / 3 + r).to(torch.bfloat16)
    return {
        "sum": comm.all_reduce(x, "model", mesh).numpy(),
        "max": comm.all_reduce(-x, "model", mesh, op="max").numpy(),
        "isum": comm.all_reduce(x.to(torch.int32), "model", mesh).numpy(),
        "gather": comm.all_gather(x, "model", mesh, dim=1).numpy(),
        "gather_bf16": comm.all_gather(b, "model", mesh, dim=0)
        .view(torch.int16).numpy(),
        "bcast": comm.broadcast(x, 1, "model", mesh).numpy(),
        "bf16": b.view(torch.int16).numpy(),
        "calls": comm.STATS["calls"],
    }


# ----------------------------------------------------------------------
# tp_serve engine (test_torch_tp_serve.py)
# ----------------------------------------------------------------------
def dup_requests(vocab: int, n: int = 16):
    """Duplicated-prefix traffic: a 40-token prompt, then prompts that
    extend it with random tails (each follower reuses it: a partial page,
    copied on write), three arrivals a step so that slots recycle.
    (rid, tokens, max_new_tokens, arrival) tuples."""
    rng = np.random.default_rng(1)
    shared = rng.integers(0, vocab, size=40).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(1, vocab, size=int(rng.integers(3, 60))
                            if i else 0).astype(np.int32)
        out.append((f"r{i}", np.concatenate([shared, tail]),
                    int(rng.integers(3, 9)), i // 3))
    return out


# engine configurations: kv layout, cache sizes, speculative overwrite
SERVE_CASES = {
    "paged": dict(kv_layout="paged", max_len=256, num_pages=32,
                  page_size=32, kernel_counters=True),
    "dense": dict(kv_layout="dense", max_len=1024),
    "overwrite": dict(kv_layout="paged", max_len=256, num_pages=32,
                      page_size=32, kernel_counters=True, spec=True),
}


def report_of(prof):
    """A profile's comparable content: tiers, checked, flagged, totals
    and each finding's (count, bytes) by key."""
    return {"tiers": list(prof.tiers), "checked": dict(prof.checked),
            "flagged": dict(prof.flagged), "totals": dict(prof.totals),
            "findings": {repr(f.key): (f.count, f.bytes)
                         for f in prof.findings}}


def serve_case(model, params, case: str, strategy=None):
    """One engine of ``case`` over ``dup_requests`` with the detectors on;
    returns the engine and its detectors."""
    import torch
    from repro_torch.configs.base import ProfilerConfig
    from repro_torch.core.detectors import ServingDetectors
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.spec import NGramDrafter
    kw = dict(SERVE_CASES[case])
    spec = kw.pop("spec", False)
    if spec:
        kw.update(drafter=NGramDrafter(), spec_k=3, spec_rollback=False)
    det = ServingDetectors(ProfilerConfig(enabled=True, num_watchpoints=8,
                                          seed=0), sites_per_step=4)
    eng = ServeEngine(model, params, num_slots=4, detectors=det,
                      kv_dtype=torch.float32, strategy=strategy, **kw)
    for rid, toks, gen, arr in dup_requests(model.cfg.vocab_size):
        eng.submit(Request(rid=rid, tokens=toks, max_new_tokens=gen,
                           arrival=arr))
    return eng, det


def serve_rank(mesh, ref_params, cases):
    """This rank's tp_serve engines: per case its tokens, stats, page
    table, refcounts, tier-3/4 reports, the sharded calls it made, the
    pool pages of its chunk that held live data, the copies on write it
    ran, and its leaves held to their slice of the full tree."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.models.params import from_reference
    from repro_torch.models.zoo import build_model
    from repro_torch.serve import flash_decode as FD
    from repro_torch.sharding.rules import PS, local_slice, make_strategy
    cfg = dataclasses.replace(registry.get_config("qwen3-1.7b").smoke(),
                              dtype="float32")
    model = build_model(cfg)
    calls = {"decode": 0, "verify": 0, "dense": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    FD.decode_paged_attention_sharded = counted(
        "decode", FD.decode_paged_attention_sharded)
    FD.verify_paged_attention_sharded = counted(
        "verify", FD.verify_paged_attention_sharded)
    FD.decode_attention_sharded = counted(
        "dense", FD.decode_attention_sharded)
    full = from_reference(ref_params, device="cpu")
    out = {}
    for case in cases:
        for k in calls:
            calls[k] = 0
        strategy = make_strategy("tp_serve", mesh)
        eng, det = serve_case(model, full, case, strategy)
        cows, live = [], set()
        admit = eng.kv.admit if eng.paged else None
        if admit is not None:
            def recording(*a, **k):
                plan = admit(*a, **k)
                cows.extend(plan.cow)
                return plan
            eng.kv.admit = recording
        steps = 0
        while eng.pending and steps < 300:
            eng.step()
            steps += 1
            if eng.paged:
                live.update(int(p) for p in eng.kv.pt.reshape(-1) if p >= 0)
        specs = flatten(strategy.param_specs(model),
                        is_leaf=lambda x: isinstance(x, PS))
        whole = flatten(full)
        held = sorted(specs) == sorted(whole) and all(
            torch.equal(t, local_slice(whole[k], specs[k], mesh))
            for k, t in flatten(eng.params).items())
        first = next(iter(eng.cache["main"].values()))["k"]
        out[case] = {
            "tokens": {k: v.generated for k, v in eng.finished.items()},
            "reuse": {k: v.reuse_len for k, v in eng.finished.items()},
            "stats": {k: v for k, v in eng.stats.items()
                      if k not in ("prefill_s", "decode_s", "draft_s",
                                   "verify_s")},
            "pt": None if eng.kv is None else eng.kv.pt.copy(),
            "refcount": (None if eng.kv is None
                         else eng.kv.alloc.refcount.copy()),
            "report": report_of(det.report),
            "kernel": report_of(det.kernel),
            "calls": dict(calls), "live": sorted(live), "cows": cows,
            "held": held, "local_shape": tuple(first.shape),
            "sharder": (strategy.sharder().pool_pages,
                        strategy.sharder().seq_len),
        }
    return {"rank": mesh.rank, "cases": out}


# ----------------------------------------------------------------------
# Elastic restore (test_torch_checkpoint.py)
# ----------------------------------------------------------------------
def elastic_rank(mesh, ckpt_dir):
    """``resume_elastic`` onto this mesh's size from this rank: its
    leaves by checkpoint key, as numpy."""
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.checkpoint.elastic import resume_elastic
    from repro_torch.configs import registry
    from repro_torch.models.zoo import build_model
    model = build_model(registry.get_config("qwen3-1.7b").smoke())
    emesh, strat, state = resume_elastic(ckpt_dir, model, "dp_tp",
                                         num_devices=mesh.size,
                                         rank=mesh.rank)
    return {"shape": dict(emesh.shape), "coords": dict(emesh.coords),
            "leaves": {k: v.float().numpy() for k, v in
                       flatten(state).items()}}
