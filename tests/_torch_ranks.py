"""Rank bodies and shared inputs of the port's multi-rank CPU tests.

The tests start gloo ranks with ``repro_torch.launch.mesh.launch``
(spawned processes), which import the function they run by name: the
bodies live here, in a module that imports neither JAX nor the
reference, so a rank loads only torch and the port. The input builders
use numpy alone, so the reference's subprocesses build the same inputs.
"""
import contextlib
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


# engine configurations: kv layout, cache sizes, speculative overwrite,
# the model config ("wide": WIDE's, every attention projection sharded;
# default the smoke config, whose attention leaves stay replicated)
SERVE_CASES = {
    "paged": dict(kv_layout="paged", max_len=256, num_pages=32,
                  page_size=32, kernel_counters=True),
    "dense": dict(kv_layout="dense", max_len=1024),
    "overwrite": dict(kv_layout="paged", max_len=256, num_pages=32,
                      page_size=32, kernel_counters=True, spec=True),
    "paged-wide": dict(kv_layout="paged", max_len=256, num_pages=32,
                       page_size=32, kernel_counters=True, config="wide"),
}


def serve_config(case: str) -> str:
    """The model config ("plain" or "wide") a serving case runs."""
    return SERVE_CASES[case].get("config", "plain")


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
    kw.pop("config", None)
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


@contextlib.contextmanager
def count_kernels():
    """Within: each kernel entry point's calls (``kernels/ops.py``; the
    cache-free attention only; the chunked paged functions of
    serve/flash_decode.py, each a B1 or B2 launch on the card) counted by
    the label its traced node has, in the dict this yields; restored on
    exit. A CPU call runs the plain version: this counts what the card
    would launch."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import traced as T
    from repro_torch.serve import flash_decode as FD
    counts = {}

    def counted(label, fn, take=lambda *a, **k: True):
        def wrapped(*a, **k):
            if take(*a, **k):
                counts[label] = counts.get(label, 0) + 1
            return fn(*a, **k)
        return wrapped

    def cache_free(q, k, v, causal=True, q_offset=0, kv_len=None,
                   kv_valid=None):
        return T.cache_free(q_offset, kv_len, kv_valid)
    patched = [(ops, "rmsnorm", "ops.rmsnorm", None),
               (ops, "attention", "ops.attention", cache_free),
               (ops, "paged_decode", "ops.paged_decode", None),
               (ops, "paged_window", "ops.paged_window", None),
               (FD, "decode_paged_attention_sharded", "ops.paged_decode",
                None),
               (FD, "verify_paged_attention_sharded", "ops.paged_window",
                None),
               (FD, "defer_paged_attention_sharded", "ops.paged_window",
                None)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _, _ in patched]
    for mod, name, label, take in patched:
        setattr(mod, name, counted(label, getattr(mod, name),
                                   *(() if take is None else (take,))))
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def collective_nodes(traced) -> dict:
    """A trace's collective nodes by kind (core/graph_cost.py)."""
    from collections import Counter
    from repro_torch.core.graph_cost import collective_of
    return dict(Counter(c[0] for c in map(collective_of, traced.graph.nodes)
                        if c))


def forward_kernel_nodes(traced) -> dict:
    """A trace's kernel nodes, backwards left out (on the CPU they are
    the plain versions' autograd, no call of their own)."""
    return {k: v for k, v in traced.kernel_nodes().items()
            if not k.endswith(".bwd")}


def tick_check(eng) -> dict:
    """The engine's traced tick against one real tick, every slot active
    (at the end of a run; it writes the cache): the trace's collective
    nodes by kind and forward kernel nodes, the real tick's collectives
    by kind (``comm.STATS``) and kernel calls (``count_kernels``)."""
    import torch
    from repro_torch.sharding import comm
    traced = eng.traced_tick()
    active = torch.ones((eng.num_slots,), dtype=torch.bool)
    comm.reset_stats()
    with count_kernels() as calls:
        eng._tick_fn(eng._step_params, eng.cache, eng.tokens, active)
    return {"nodes": collective_nodes(traced),
            "kernel_nodes": forward_kernel_nodes(traced),
            "collectives": dict(comm.STATS["kinds"]), "kernel_calls": calls}


def serve_rank(mesh, ref_params, cases):
    """This rank's tp_serve engines (``ref_params``: the reference's
    weights by config): per case its tokens, stats, page table,
    refcounts, tier-3/4 reports, the sharded calls it made, the pool
    pages of its chunk that held live data, the copies on write it ran,
    its leaves held to their slice of the full tree, and the attention
    projections it holds a block of."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.models.params import from_reference
    from repro_torch.models.zoo import build_model
    from repro_torch.serve import flash_decode as FD
    from repro_torch.sharding.rules import PS, local_slice, make_strategy
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
    out = {}
    for case in cases:
        kind = serve_config(case)
        model = build_model(dataclasses.replace(
            registry.get_config("qwen3-1.7b").smoke(),
            **train_overrides(kind)))
        full = from_reference(ref_params[kind], device="cpu")
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
            "sharded_attn": sorted(
                k for k in ("wq", "wk", "wv", "wo")
                if eng.params["main"]["b0_dense"]["attn"][k]["w"].shape
                != full["main"]["b0_dense"]["attn"][k]["w"].shape),
            "sharder": (strategy.sharder().pool_pages,
                        strategy.sharder().seq_len),
        }
        out[case]["tick"] = tick_check(eng)
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


# ----------------------------------------------------------------------
# Sharded training (test_torch_train_sharded.py)
# ----------------------------------------------------------------------
# qwen3-1.7b's smoke config widened until every attention projection
# and the embedding shard (each over 16 Ki elements): 8 heads over 4 kv
# heads of 32, d_ff 512
WIDE = dict(d_model=256, num_heads=8, num_kv_heads=4, head_dim=32,
            d_ff=512)
TRAIN_STEPS, TRAIN_SEQ = 3, 32
# case -> (config, strategy, TrainConfig fields, global batch)
TRAIN_CASES = {
    "wide-dp_tp": ("wide", "dp_tp", {}, 4),
    "wide-fsdp": ("wide", "fsdp", {}, 4),
    "plain-dp_tp": ("plain", "dp_tp", {}, 4),
    "plain-fsdp": ("plain", "fsdp", {}, 4),
    "wide-dp_tp-mb2": ("wide", "dp_tp", {"microbatches": 2}, 8),
    "wide-fsdp-mb2": ("wide", "fsdp", {"microbatches": 2}, 8),
    "wide-dp_tp-int8": ("wide", "dp_tp", {"grad_compression": "int8_ef"},
                        4),
    "wide-fsdp-int8": ("wide", "fsdp", {"grad_compression": "int8_ef"}, 4),
}


# the cases whose last step is also traced (train_case's ``trace``)
TRACED_CASES = ("wide-dp_tp", "wide-fsdp")


def train_overrides(kind: str) -> dict:
    """Config fields of a training case's config ("wide" or "plain"), in
    float32."""
    return dict(WIDE, dtype="float32") if kind == "wide" else \
        {"dtype": "float32"}


def port_train_model(kind: str):
    from repro_torch.configs import registry
    from repro_torch.models.zoo import build_model
    return build_model(dataclasses.replace(
        registry.get_config("qwen3-1.7b").smoke(), **train_overrides(kind)))


def port_state(host: dict):
    """A whole port TrainState on the CPU from a reference state on the
    host as plain dicts ({"params", "master", "m", "v"} trees of numpy
    arrays, "step" an int): a rank needs no JAX to load it."""
    import torch
    from repro_torch.models.params import from_reference
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.state import TrainState

    def tree(t):
        return from_reference(t, device="cpu")
    return TrainState(params=tree(host["params"]),
                      master=tree(host["master"]),
                      opt=AdamWState(m=tree(host["m"]), v=tree(host["v"])),
                      step=torch.tensor(host["step"], dtype=torch.int32))


def train_case(model, state, case: str, strategy=None, trace=False):
    """TRAIN_STEPS steps of ``case`` from ``state`` (this rank's share
    under a ``strategy``) with the training detectors on: per step (loss,
    nll, grad norm, lr), the whole state after (numpy by checkpoint key),
    the detectors' report, and the eval step's logits of the last batch's
    rows here (``block``: this rank's (index, count) over the batch
    axes). With ``trace`` the last step is traced first (fake tensors)
    and "step" holds its collective and forward kernel nodes against the
    real step's collectives (``comm.STATS``) and kernel calls."""
    import torch
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.configs.base import ProfilerConfig, TrainConfig
    from repro_torch.core.detectors import TrainingDetectors
    from repro_torch.core.graph_trace import trace_step
    from repro_torch.data.synthetic import stream
    from repro_torch.sharding import comm
    from repro_torch.train import state as TS
    from repro_torch.train.step import (make_eval_step, make_train_step,
                                        rank_batch)
    _, _, fields, B = TRAIN_CASES[case]
    tc = TrainConfig(**fields)
    fn = make_train_step(model, tc, strategy)
    shard = ({} if strategy is None else
             dict(mesh=strategy.mesh, specs=strategy.param_specs(model)))
    det = TrainingDetectors(ProfilerConfig(enabled=True), **shard)
    data = stream(model.cfg, B, TRAIN_SEQ, seed=0)
    rows, checked = [], None
    for step in range(TRAIN_STEPS):
        b = next(data)
        det.on_batch(step, b)
        mine = b if strategy is None else rank_batch(b, strategy,
                                                     tc.microbatches)
        before = state.params
        batch = {k: torch.from_numpy(v) for k, v in mine.items()}
        if trace and step == TRAIN_STEPS - 1:
            traced = trace_step(fn, state, batch)
            comm.reset_stats()
            with count_kernels() as calls:
                state, m = fn(state, batch)
            checked = {"nodes": collective_nodes(traced),
                       "kernel_nodes": forward_kernel_nodes(traced),
                       "collectives": dict(comm.STATS["kinds"]),
                       "kernel_calls": calls}
        else:
            state, m = fn(state, batch)
        det.on_step(step, before, state.params)
        rows.append(tuple(float(m[k]) for k in ("loss", "nll", "grad_norm",
                                                "lr")))
    # the eval step on the last batch's rows, with the stepped params
    logits, _ = make_eval_step(model, strategy)(
        state.params, {k: torch.from_numpy(v) for k, v in mine.items()})
    whole = (state if strategy is None
             else TS.gather_state(state, model, strategy))
    return {"rows": rows, "report": report_of(det.report),
            "logits": logits.numpy().copy(),
            "block": (0, 1) if strategy is None else (
                strategy.mesh.index(strategy.batch_axes),
                strategy.mesh.axis_size(strategy.batch_axes)),
            "state": {k: v.numpy().copy() for k, v in
                      flatten(whole).items()}, "step": checked}


def train_rank(mesh, hosts, cases, ckpt_root=None):
    """Every case of ``cases`` on this rank, from the reference's state
    of its config (``hosts``: by config) cut to this rank's share: the
    case's ``train_case`` result, and the share's layout: each leaf's
    element count against its ``state_specs`` block, the sharded leaves
    of the param layout and the largest param leaf here."""
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.sharding.rules import PS, global_shape, make_strategy
    from repro_torch.train import state as TS
    out = {}
    for case in cases:
        kind, name, _, _ = TRAIN_CASES[case]
        model = port_train_model(kind)
        strategy = make_strategy(name, mesh)
        whole = port_state(hosts[kind])
        state = TS.shard_state(whole, model, strategy)
        specs = flatten(TS.state_specs(model, strategy),
                        is_leaf=lambda x: isinstance(x, PS))
        mine, full = flatten(state), flatten(whole)
        held = all(global_shape(t.shape, specs[k], mesh)
                   == tuple(full[k].shape)
                   for k, t in mine.items() if k != ".step")
        pspecs = flatten(strategy.param_specs(model),
                         is_leaf=lambda x: isinstance(x, PS))
        res = train_case(model, state, case, strategy,
                         trace=case in TRACED_CASES)
        res["layout"] = {
            "held": held,
            "sharded": sorted(k for k, s in pspecs.items() if any(s)),
            "leaves": len(pspecs),
        }
        out[case] = res
    driver = None if ckpt_root is None else driver_rank(mesh, ckpt_root)
    return {"rank": mesh.rank, "cases": out, "driver": driver}


def driver_rank(mesh, ckpt_root):
    """``launch.train.run`` under dp_tp on this rank (qwen3-1.7b's smoke
    config, seed 7, batch 4 x 32): 4 straight steps with the profile on
    (saved at the end), then 2 steps saved and a resume of 2 more, each
    checkpoint under ``ckpt_root``. The losses and the profile."""
    import os
    from repro_torch.launch.train import run
    kw = dict(smoke=True, batch=4, seq=32, seed=7, device="cpu",
              strategy="dp_tp", mesh=mesh)
    straight, prof = run("qwen3-1.7b", steps=4, profile=True,
                         ckpt_dir=os.path.join(ckpt_root, "straight"),
                         ckpt_every=100, **kw)
    resumed = os.path.join(ckpt_root, "resumed")
    first, _ = run("qwen3-1.7b", steps=2, total_steps=4, ckpt_dir=resumed,
                   ckpt_every=2, **kw)
    second, _ = run("qwen3-1.7b", steps=4, ckpt_dir=resumed, resume=True,
                    **kw)
    return {"straight": straight, "first": first, "second": second,
            "report": report_of(prof)}


# ----------------------------------------------------------------------
# Vocab-parallel loss and differentiable collectives
# (test_torch_fused_xent.py)
# ----------------------------------------------------------------------
XENT_SHAPE = (4, 8, 16)             # B, S, d
XENT_VOCABS = (64, 63)              # divides 'model' (fused), does not
Z_LOSSES = (0.0, 1e-3)


def xent_inputs(V: int) -> dict:
    """Seeded float32 inputs of the loss: x (B,S,d), w (V,d), labels."""
    B, S, d = XENT_SHAPE
    rng = np.random.default_rng(V)
    return {"x": rng.standard_normal((B, S, d)).astype(np.float32),
            "w": (0.5 * rng.standard_normal((V, d))).astype(np.float32),
            "labels": rng.integers(0, V, size=(B, S)).astype(np.int32)}


def grad_inputs() -> dict:
    """Seeded float32 inputs of the collectives' products."""
    rng = np.random.default_rng(7)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"x": r(4, 8), "w1": r(8, 12), "w2": r(12, 8), "c": r(4, 8)}


def _largest_forward_tensor(fn):
    """fn() under a dispatch mode: its result and the most elements of
    any tensor an operation in it returned."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        most = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    Largest.most = max(Largest.most, t.numel())
            return out
    with Largest():
        res = fn()
    return res, Largest.most


def xent_rank(mesh):
    """On this rank: the fused loss (``make_fused_xent``) and ``lm_loss``
    under a dp_tp sharder, for each vocab and z_loss: loss, dx of its
    rows, its rows' part of dw of its vocab block (or of the whole head
    where ``lm_loss`` falls back), the largest tensor the fused forward
    made; then the differentiable collectives' gradients
    (``grad_rank``)."""
    import torch
    from repro_torch.sharding.rules import PS, local_slice, make_strategy
    from repro_torch.train.fused_xent import lm_loss, make_fused_xent
    sharder = make_strategy("dp_tp", mesh).sharder()
    out = {}
    for V in XENT_VOCABS:
        a = {k: torch.from_numpy(v) for k, v in xent_inputs(V).items()}
        x_l = local_slice(a["x"], PS("data"), mesh).clone()
        lab = local_slice(a["labels"], PS("data"), mesh).clone()
        fused = V % mesh.shape["model"] == 0
        w_l = (local_slice(a["w"], PS("model"), mesh) if fused
               else a["w"]).clone()
        for z in Z_LOSSES:
            res = {}
            for how in ("fused", "lm_loss"):
                if how == "fused" and not fused:
                    continue
                x = x_l.clone().requires_grad_(True)
                w = w_l.clone().requires_grad_(True)
                if how == "fused":
                    fn = make_fused_xent(mesh, ("data",), z)
                    loss, most = _largest_forward_tensor(
                        lambda: fn(x, w, lab))
                else:
                    loss = lm_loss(x, w, lab, z_loss=z, sharder=sharder,
                                   vocab=V)
                    most = None
                loss.backward()
                res[how] = (float(loss.detach()), x.grad.numpy(),
                            w.grad.numpy(), most)
            out[(V, z)] = res
    return {"rank": mesh.rank, "coords": dict(mesh.coords), "xent": out,
            "grads": grad_rank(mesh)}


def grad_rank(mesh):
    """The gradients of small sharded products through each
    differentiable collective of sharding/comm.py, on this rank (model
    blocks over 'model', batch rows over 'data'):
    - "mlp": x (rows) -> copy_to -> x @ w1 (column block) -> relu ->
      @ w2 (row block) -> reduce_from -> sum(y * c);
    - "gather": x @ w1 (column block) -> gather_from -> sum(z * c');
    - "block": block_of(x) (its columns) @ w1 (row block) ->
      reduce_from;
    - "fsdp": x (rows over every axis) @ gather_weight(w1 rows block) ->
      mean_over every axis of the rows' mean of (y * c'')."""
    import torch
    from repro_torch.sharding import comm
    from repro_torch.sharding.rules import PS, local_slice
    a = {k: torch.from_numpy(v) for k, v in grad_inputs().items()}
    every = mesh.axis_names

    def cut(t, spec):
        return local_slice(t, spec, mesh).clone().requires_grad_(True)
    out = {}
    x, w1, w2 = (cut(a["x"], PS("data")), cut(a["w1"], PS(None, "model")),
                 cut(a["w2"], PS("model")))
    c = local_slice(a["c"], PS("data"), mesh)
    y = comm.reduce_from(torch.relu(comm.copy_to(x, "model", mesh) @ w1)
                         @ w2, "model", mesh)
    (y * c).sum().backward()
    out["mlp"] = [t.grad.numpy() for t in (x, w1, w2)]
    x, w1 = cut(a["x"], PS("data")), cut(a["w1"], PS(None, "model"))
    z = comm.gather_from(comm.copy_to(x, "model", mesh) @ w1, "model",
                         mesh, dim=-1)
    (z * local_slice(a["c"] @ a["w1"], PS("data"), mesh)).sum().backward()
    out["gather"] = [t.grad.numpy() for t in (x, w1)]
    x, w1 = cut(a["x"], PS("data")), cut(a["w1"], PS("model"))
    y = comm.reduce_from(comm.block_of(x, "model", mesh, dim=-1) @ w1,
                         "model", mesh)
    (y * local_slice(a["c"] @ a["w1"], PS("data"), mesh)).sum().backward()
    out["block"] = [t.grad.numpy() for t in (x, w1)]
    x, w1 = cut(a["x"], PS(every)), cut(a["w1"], PS(every))
    y = x @ comm.gather_weight(w1, every, mesh, dim=0)
    loss = comm.mean_over(torch.mean(y * local_slice(
        a["c"] @ a["w1"], PS(every), mesh)), every, mesh)
    loss.backward()
    out["fsdp"] = [t.grad.numpy() for t in (x, w1)] + [float(loss.detach())]
    return out


# the vlm, audio, hybrid and ssm families at their smoke configs in
# float32, 2 steps of 4 x 32 tokens (test_torch_train_sharded.py; the
# MoE family and dp_tp of the hybrid and ssm families are
# test_torch_train_families_sharded.py's FAMILIES_SHARDED)
FAMILY_CASES = (
    ("llama-3.2-vision-90b", "dp_tp"), ("llama-3.2-vision-90b", "fsdp"),
    ("whisper-large-v3", "dp_tp"), ("whisper-large-v3", "fsdp"),
    ("zamba2-1.2b", "fsdp"), ("xlstm-1.3b", "fsdp"))


@contextlib.contextmanager
def count_choices():
    """Within: the MoE layers' expert choices of every real forward
    (``models/moe.py``: ``_route`` of the whole batch, ``_route_rows`` of
    a rank's rows, whose kept mask is False on the other ranks'
    positions), kept and dropped past capacity, summed in the dict this
    yields; restored on exit."""
    from torch._subclasses.fake_tensor import FakeTensor
    from repro_torch.models import moe as M
    counts = {"kept": 0, "dropped": 0}

    def count(keep, choices):
        if not isinstance(keep, FakeTensor):
            kept = int(keep.sum())
            counts["kept"] += kept
            counts["dropped"] += choices - kept

    def route(p, cfg, x, *args):
        out = saved[0](p, cfg, x, *args)
        count(out[3], out[3].numel())
        return out

    def route_rows(p, cfg, x, *args):
        out = saved[1](p, cfg, x, *args)
        count(out[5], x.shape[0] * x.shape[1] * cfg.moe.experts_per_token)
        return out
    saved = (M._route, M._route_rows)
    M._route, M._route_rows = route, route_rows
    try:
        yield counts
    finally:
        M._route, M._route_rows = saved


def family_config(arch: str, layers=None, dispatch=None):
    """``arch``'s smoke config in float32 (``layers``: its depth;
    ``dispatch``: its MoE layer's dispatch path)."""
    from repro_torch.configs import registry
    cfg = registry.get_config(arch).smoke()
    fields = {"dtype": "float32"}
    if layers:
        fields["num_layers"] = layers
    if dispatch:
        fields["moe"] = dataclasses.replace(cfg.moe, dispatch=dispatch)
    return dataclasses.replace(cfg, **fields)


def family_run(arch: str, strategy=None, mesh=None, layers=None,
               dispatch=None, remat="none", trace=False):
    """2 f32 steps under ``remat`` of ``arch``'s smoke config
    (``family_config`` of ``layers`` and ``dispatch``) from the
    port's seed-0 state (this rank's share under ``strategy``), each
    rank on its rows of the stream's 4 x 32 batches. Returns "rows"
    ((loss, nll, moe_aux, grad norm) a step), "master" (whole, by
    checkpoint key), "choices" (the MoE layers' kept and dropped expert
    choices of this rank's forwards, ``count_choices``), "router" (the
    first MoE layer's router gradient on the first batch after the
    step's sum over the batch axes its layout does not shard: the whole
    batch's on every rank; None for other families) and "coords". With
    ``trace`` the last step is traced on fake tensors first and "step"
    holds its collective and forward kernel nodes against the real
    step's collectives (``comm.STATS``) and kernel calls."""
    import torch
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.graph_trace import trace_step
    from repro_torch.data.synthetic import stream
    from repro_torch.models.zoo import build_model
    from repro_torch.sharding import comm
    from repro_torch.sharding.rules import make_strategy
    from repro_torch.train import state as TS
    from repro_torch.train.step import make_train_step, rank_batch
    cfg = family_config(arch, layers, dispatch)
    model = build_model(cfg)
    strat = None if strategy is None else make_strategy(strategy, mesh)
    fn = make_train_step(model, TrainConfig(
        learning_rate=3e-4, total_steps=2, warmup_steps=1, remat=remat),
        strat)
    state = TS.create(model, 0, compute_dtype=torch.float32, device="cpu",
                      strategy=strat)
    data = stream(cfg, 4, TRAIN_SEQ, seed=0)
    rows, router, checked = [], None, None
    with count_choices() as choices:
        for step in range(2):
            b = next(data)
            b = b if strat is None else rank_batch(b, strat)
            batch = {k: torch.from_numpy(v) for k, v in b.items()}
            if step == 0 and cfg.moe is not None:
                router = _router_grad(model, state.params, batch, strat)
            if trace and step == 1:
                traced = trace_step(fn, state, batch)
                comm.reset_stats()
                with count_kernels() as calls:
                    state, m = fn(state, batch)
                checked = {"nodes": collective_nodes(traced),
                           "kernel_nodes": forward_kernel_nodes(traced),
                           "collectives": dict(comm.STATS["kinds"]),
                           "kernel_calls": calls}
            else:
                state, m = fn(state, batch)
            rows.append(tuple(float(m[k]) for k in
                              ("loss", "nll", "moe_aux", "grad_norm")))
    if strat is not None:
        state = TS.gather_state(state, model, strat)
    return {"rows": rows, "master": {k: v.numpy().copy() for k, v in
                                     flatten(state.master).items()},
            "choices": dict(choices), "router": router, "step": checked,
            "coords": None if mesh is None else dict(mesh.coords)}


def _router_grad(model, params, batch, strat):
    """The gradient of the loss by the first MoE layer's router (every
    layer, stacked), as the train step takes it (sharding_ctx, then the
    sum over the batch axes the router's layout does not shard)."""
    import torch
    from repro_torch.models.params import tree_map
    from repro_torch.sharding import comm
    from repro_torch.sharding.ctx import sharding_ctx
    from repro_torch.sharding.rules import spec_axes
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    router = live["main"]["b0_moe"]["moe"]["router"]
    sharder = None if strat is None else strat.sharder()
    with torch.enable_grad(), sharding_ctx(sharder):
        loss, _ = model.loss(live, batch)
        (g,) = torch.autograd.grad(loss, [router])
    if strat is not None:
        spec = strat.param_specs(model)["main"]["b0_moe"]["moe"]["router"]
        g = comm.all_reduce(g, tuple(a for a in strat.batch_axes
                                     if a not in spec_axes(spec)),
                            strat.mesh)
    return g.numpy().copy()


def family_steps(arch: str, strategy=None, mesh=None):
    """``family_run``'s (loss, grad norm) a step and whole master."""
    r = family_run(arch, strategy, mesh)
    return [(row[0], row[3]) for row in r["rows"]], r["master"]


def family_rank(mesh, cases):
    """``family_steps`` of every (arch, strategy) of ``cases`` here."""
    return {f"{a}-{s}": family_steps(a, s, mesh) for a, s in cases}


# case -> (arch, strategy, family_run's keywords);
# test_torch_train_families_sharded.py runs each on (1, 2) and
# FAMILIES_SHARDED_22 on (2, 2) too
FAMILIES_SHARDED = {
    "granite-dp_tp": ("granite-moe-3b-a800m", "dp_tp", {}),
    "granite-fsdp": ("granite-moe-3b-a800m", "fsdp", {}),
    # the one-hot einsum dispatch, with the same two copy_to points
    "granite-einsum-dp_tp": ("granite-moe-3b-a800m", "dp_tp",
                             {"dispatch": "einsum"}),
    # the recompute of each superblock keeps the layout and the routing
    "granite-dots-dp_tp": ("granite-moe-3b-a800m", "dp_tp",
                           {"remat": "dots"}),
    # two superblocks of 6 Mamba2 blocks and the shared block, then a
    # tail of 2 (the smoke config's 12 layers have no tail)
    "zamba2-dp_tp": ("zamba2-1.2b", "dp_tp", {"layers": 14}),
    "xlstm-dp_tp": ("xlstm-1.3b", "dp_tp", {}),
}
FAMILIES_SHARDED_22 = ("granite-dp_tp",)
# the case whose last step is traced on fake tensors on (1, 2)
FAMILIES_TRACED = "granite-dp_tp"


def families_rank(mesh, cases, traced=None):
    """``family_run`` of every case of ``cases`` on this rank (the case
    ``traced`` with its last step traced)."""
    out = {}
    for case in cases:
        arch, strategy, kw = FAMILIES_SHARDED[case]
        out[case] = family_run(arch, strategy, mesh, trace=case == traced,
                               **kw)
    return out


# ----------------------------------------------------------------------
# The rarer tp_serve layouts (test_torch_tp_layouts.py): 'data' > 1, an
# MoE model's experts over 'model', the rollback verify on a chunked
# pool, the object registry
# ----------------------------------------------------------------------
# case -> (arch, speculative mode or None, object registry); every case
# serves ``dup_requests`` on a paged pool of 32 pages of 32 rows (1024
# positions: chunked over 'model') with the tier-3 detectors and the
# tier-4 kernel counters, 4 slots (over 'data' 2 a rank)
LAYOUT_ARCHS = {"qwen": "qwen3-1.7b", "granite": "granite-moe-3b-a800m"}
LAYOUT_CASES = {
    "qwen-rollback": ("qwen", "rollback", False),
    "granite-paged": ("granite", None, False),
    "granite-rollback": ("granite", "rollback", False),
    "qwen-registry": ("qwen", None, True),
}
LAYOUT_POOL = dict(kv_layout="paged", max_len=256, num_pages=32,
                   page_size=32, kernel_counters=True)
LAYOUT_SPEC_K = 3


def layout_case(model, params, case: str, strategy=None, on_step=None):
    """One engine of a LAYOUT_CASES case over ``dup_requests``, run to
    its end (``on_step(engine)`` after each step): (engine, detectors,
    the registry's replica scan or None)."""
    import torch
    from repro_torch.configs.base import ProfilerConfig
    from repro_torch.core.detectors import ServingDetectors
    from repro_torch.core.objects import ObjectRegistry
    from repro_torch.core.replicas import ReplicaDetector
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.spec import NGramDrafter
    _, spec, objects = LAYOUT_CASES[case]
    kw = dict(LAYOUT_POOL)
    if spec:
        kw.update(drafter=NGramDrafter(), spec_k=LAYOUT_SPEC_K,
                  spec_rollback=spec == "rollback")
    reg = ObjectRegistry() if objects else None
    det = ServingDetectors(ProfilerConfig(enabled=True, num_watchpoints=8,
                                          seed=0), sites_per_step=4)
    eng = ServeEngine(model, params, num_slots=4, detectors=det,
                      kv_dtype=torch.float32, strategy=strategy,
                      registry=reg, **kw)
    for rid, toks, gen, arr in dup_requests(model.cfg.vocab_size):
        eng.submit(Request(rid=rid, tokens=toks, max_new_tokens=gen,
                           arrival=arr))
    steps = 0
    while eng.pending and steps < 300:
        eng.step()
        steps += 1
        if on_step is not None:
            on_step(eng)
    scan = None if reg is None else scan_of(ReplicaDetector(reg).scan())
    return eng, det, scan


def scan_of(prof):
    """A replica scan's comparable content: each finding's kind, canonical
    and duplicate objects (kind and name: the key without its
    registration site, which names each package's own file:line), count
    and bytes, sorted."""
    def names(keys):
        return tuple(k.rsplit("|", 1)[0] for k in keys)
    return sorted((f.kind, names(f.c1), names(f.c2), f.count, f.bytes)
                  for f in prof.findings)


def engine_result(eng, det, scan, dispatch=None):
    """What the layout tests compare of an engine run to its end."""
    return {
        "tokens": {k: v.generated for k, v in eng.finished.items()},
        "reuse": {k: v.reuse_len for k, v in eng.finished.items()},
        "stats": {k: v for k, v in eng.stats.items()
                  if k not in ("prefill_s", "decode_s", "draft_s",
                               "verify_s")},
        "pt": eng.kv.pt.copy(), "refcount": eng.kv.alloc.refcount.copy(),
        "report": report_of(det.report), "kernel": report_of(det.kernel),
        "scan": scan, "dispatch": dispatch,
    }


@contextlib.contextmanager
def count_dispatch():
    """Within: the port's MoE layer wrapped so each call also sums its
    ``dispatch_stats`` (rows total, routed, stored, dead) into the dict
    this yields; the layer is restored on exit."""
    from repro_torch.models import moe as Moe
    sums = {"calls": 0, "rows_total": 0, "rows_routed": 0,
            "rows_stored": 0, "dead_rows": 0}
    inner = Moe.apply_moe

    def apply_moe(p, cfg, x, **kw):
        st = Moe.dispatch_stats(p, cfg, x)
        sums["calls"] += 1
        for k in sums:
            if k != "calls":
                sums[k] += st[k]
        return inner(p, cfg, x, **kw)
    Moe.apply_moe = apply_moe
    try:
        yield sums
    finally:
        Moe.apply_moe = inner


def layout_rank(mesh, hosts, cases):
    """This rank's tp_serve engines of ``cases`` (``hosts``: the
    reference's weights by arch key): per case ``engine_result`` with the
    MoE dispatch sums, the sharded functions it ran, the pool pages of
    its chunk that held live data, the expert leaves' first dim, and the
    data splits taken."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import layers as Lyr
    from repro_torch.models.params import from_reference
    from repro_torch.models.zoo import build_model
    from repro_torch.serve import flash_decode as FD
    from repro_torch.sharding.rules import make_strategy
    calls = {"decode": 0, "verify": 0, "defer": 0, "split": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    for name, fn in (("decode", "decode_paged_attention_sharded"),
                     ("verify", "verify_paged_attention_sharded"),
                     ("defer", "defer_paged_attention_sharded")):
        setattr(FD, fn, counted(name, getattr(FD, fn)))
    Lyr._local_cache = counted("split", Lyr._local_cache)
    out = {}
    with count_dispatch() as dispatch:
        for case in cases:
            arch = LAYOUT_CASES[case][0]
            model = build_model(dataclasses.replace(
                registry.get_config(LAYOUT_ARCHS[arch]).smoke(),
                dtype="float32"))
            full = from_reference(hosts[arch], device="cpu")
            for k in list(calls) + list(dispatch):
                (calls if k in calls else dispatch)[k] = 0
            strategy = make_strategy("tp_serve", mesh)
            live = set()
            eng, det, scan = layout_case(
                model, full, case, strategy, on_step=lambda e: live.update(
                    int(p) for p in e.kv.pt.reshape(-1) if p >= 0))
            res = engine_result(eng, det, scan,
                                dict(dispatch) if arch == "granite" else None)
            first = next(iter(eng.cache["main"].values()))
            moe = eng.params["main"].get("b0_moe", {}).get("moe")
            res.update(calls=dict(calls), live=sorted(live),
                       local_pages=int(first["k"].shape[1]),
                       experts=None if moe is None else
                       int(moe["w_up"].shape[1]),
                       pool_pages=strategy.sharder().pool_pages)
            out[case] = res
    loop = None
    if mesh.shape["data"] > 1:
        # the dense family's token loop (a scalar write index) with the
        # slots split over 'data'
        calls["split"] = 0
        loop = loop_run(LAYOUT_ARCHS["qwen"], hosts["qwen"], mesh)[:2] \
            + (calls["split"],)
    return {"rank": mesh.rank, "coords": dict(mesh.coords), "cases": out,
            "loop": loop}


# ----------------------------------------------------------------------
# Token-loop families under tp_serve (test_torch_tp_loop.py): a cache of
# LOOP_LEN positions (chunked over 'model'), LOOP_CROSS frames or image
# tokens (chunked too), greedy steps from LOOP_PROMPT's first token
# ----------------------------------------------------------------------
LOOP_ARCHS = {"zamba2-1.2b": {}, "whisper-large-v3": {},
              "llama-3.2-vision-90b": {"num_layers": 5}}
LOOP_LEN, LOOP_CROSS, LOOP_BATCH, LOOP_STEPS = 1024, 1024, 2, 4


def loop_inputs(cfg):
    """(first tokens (B, 1) int32, init_cache's frames or image tokens as
    numpy) of a token-loop case, from seed 3."""
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg.vocab_size, size=(LOOP_BATCH, 1))
    kw = {}
    src = rng.standard_normal((LOOP_BATCH, LOOP_CROSS, cfg.d_model))
    if cfg.family == "audio":
        kw["frames"] = src.astype(np.float32)
    if cfg.family == "vlm":
        kw["img"] = src.astype(np.float32)
    return toks.astype(np.int32), kw


def loop_run(arch: str, host, mesh=None):
    """LOOP_STEPS greedy decode steps of ``arch``'s smoke config (f32, the
    reference's weights ``host``) through ``make_serve_step``, under
    tp_serve on ``mesh`` when given: (logits (steps, B, 1, V), tokens
    (B, steps), the sharded functions' calls)."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models.params import from_reference
    from repro_torch.models.zoo import build_model
    from repro_torch.serve import flash_decode as FD
    from repro_torch.serve.decode import shard_params
    from repro_torch.sharding.rules import make_strategy
    cfg = dataclasses.replace(registry.get_config(arch).smoke(),
                              dtype="float32", **LOOP_ARCHS.get(arch, {}))
    model = build_model(cfg)
    params = from_reference(host, device="cpu")
    strategy = None if mesh is None else make_strategy("tp_serve", mesh)
    sharder = None if strategy is None else strategy.sharder()
    if strategy is not None:
        _, params = shard_params(model, strategy, params)
    calls = {"dense": 0, "cross": 0}
    saved = {}
    for name, fn in (("dense", "decode_attention_sharded"),
                     ("cross", "cross_attention_sharded")):
        saved[fn] = getattr(FD, fn)

        def wrapped(*a, _inner=saved[fn], _name=name, **k):
            calls[_name] += 1
            return _inner(*a, **k)
        setattr(FD, fn, wrapped)
    try:
        return _loop_steps(model, params, strategy, sharder, cfg) + (calls,)
    finally:
        for fn, f in saved.items():
            setattr(FD, fn, f)


def _loop_steps(model, params, strategy, sharder, cfg):
    """``loop_run``'s greedy steps: (logits, tokens)."""
    import torch
    from repro_torch.serve.decode import make_serve_step
    from repro_torch.sharding.ctx import sharding_ctx
    toks, kw = loop_inputs(cfg)
    with sharding_ctx(sharder):
        cache = model.init_cache(params, LOOP_BATCH, LOOP_LEN,
                                 kv_dtype=torch.float32,
                                 **{k: torch.from_numpy(v)
                                    for k, v in kw.items()})
    logits, out = [], []
    inner = model.decode_step

    def recorded(*a, **k):
        lg, c = inner(*a, **k)
        logits.append(lg.numpy().copy())
        return lg, c
    model.decode_step = recorded
    step = make_serve_step(model, strategy)
    dparams = model.decode_params(params)
    tok = torch.from_numpy(toks)
    for _ in range(LOOP_STEPS):
        tok, cache = step(dparams, cache, tok)
        out.append(tok.numpy().copy())
    return np.stack(logits), np.concatenate(out, axis=1)


def loop_rank(mesh, hosts):
    """``loop_run`` of every LOOP_ARCHS arch on this rank."""
    return {arch: loop_run(arch, hosts[arch], mesh) for arch in LOOP_ARCHS}


def objects_rank(mesh, strategies):
    """The train driver's object scan at init (``objects=True``) under
    each strategy on this rank: qwen3's smoke config, one step."""
    from repro_torch.launch import train
    out = {}
    for st in strategies:
        _, prof = train.run("qwen3-1.7b", smoke=True, steps=1, batch=4,
                            seq=32, device="cpu", strategy=st, mesh=mesh,
                            objects=True)
        out[st] = scan_of(prof)
    return out
