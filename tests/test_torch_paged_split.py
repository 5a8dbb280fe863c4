"""The arithmetic of the redesigned paged kernels (B1 and B2), emulated on
the CPU and held against the reference's jnp oracles
(``repro.kernels.ref.paged_decode_ref`` / ``paged_window_ref``) at the
serving path's shapes: B 8, Hq 16, Hkv 8, D 128, page 16, M 11.

* The split history (``csrc/paged_split.cuh``: B1, and B2's short
  windows of f32 activations): each slot's history is cut by page index
  into splits of 2 pages, each split gives an f32 partial (max, sum,
  accumulator) in log2 units, the window's keys go to the split that
  holds idx, and the partials are combined in split order.
* The tensor-core route of B2 (``window_tc_kernel``: bf16 activations):
  keys in tiles of 32, history then window, an online softmax in log2
  units with P rounded to bf16 before P V; a window of one row tile (the
  verify width) splits its history as above, in splits of 4 pages.

Outputs within 1e-5 at float32 (the same f32 arithmetic summed in
another order) and 2e-2 at bfloat16 (one bf16 rounding of an output
below 4, and P's rounding); lse within the same of the port's plain
version (``repro_torch.kernels.ref``, itself held to the reference in
tests/test_torch_kernels_ref.py). The reference's Pallas kernels do not
run under the installed JAX, so its jnp oracles are the reference here.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as kref
from repro_torch.kernels import ref as pref

B, HQ, HKV, D, PS, M = 8, 16, 8, 128, 16, 11
G = HQ // HKV
P = B * M
NP = 2                                   # split kernel: pages per split
NS = -(-M // NP)                         # its splits per slot at M 11: 6
NP_TC = 4                                # tensor-core route: pages per split
NS_TC = -(-M // NP_TC)                   # its splits per slot at M 11: 3
TK = 32                                  # keys per tensor-core tile
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SCALE_LOG2 = (torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
              * torch.tensor(math.log2(math.e), dtype=torch.float32))

# decode positions: 1 to 6 splits of 32 rows (16, 37, 64, 100, 144, 175),
# mid-page (37, 100), the last row of the table (175), page boundaries
# (16, 64), a history that ends on an unmapped page (slot 2: page 6 =
# rows 96-111), an idle slot
DEC_IDX = np.array([144, 37, 100, 64, 159, 16, 175, -1], np.int32)
# verify windows of 5: the same spread, one crossing the table's end
W5_IDX = np.array([144, 37, 100, 60, 150, 9, 171, -6], np.int32)
# prefill chunks of 128: fresh (0) and prefix hits with history
S128_IDX = np.array([0, 0, 16, 33, 0, 0, 48, -129], np.int32)


def _table(seed=0):
    pt = np.random.default_rng(seed).permutation(P).reshape(B, M)
    pt = pt.astype(np.int32)
    pt[2, 6] = -1                        # slot 2's history ends unmapped
    pt[6, 10] = -1                       # slot 6's window end unmapped
    return pt


def _inputs(S, act, pool, seed):
    rng = np.random.default_rng(seed)
    f = {k: rng.standard_normal(shape).astype(np.float32) for k, shape in
         (("q", (B, S, HQ, D)), ("k", (B, S, HKV, D)), ("v", (B, S, HKV, D)),
          ("pk", (P, PS, HKV, D)), ("pv", (P, PS, HKV, D)))}
    jx = {k: jnp.asarray(v, DT[pool if k in ("pk", "pv") else act][0])
          for k, v in f.items()}
    tx = {k: torch.from_numpy(v).to(DT[pool if k in ("pk", "pv")
                                      else act][1])
          for k, v in f.items()}
    return jx, tx


def _keys(tx, pt, i0, b, h, store):
    """Slot b's history positions by split and its valid window keys, K
    and V as the kernels read them (history through the activation dtype,
    window keys through the pool dtype and back)."""
    act, pool = tx["q"].dtype, tx["pk"].dtype
    S = tx["q"].shape[1]
    hist = [p for p in range(min(max(i0, 0), M * PS)) if pt[b, p // PS] >= 0]

    def rows(ps_):
        if not ps_:
            return torch.zeros((0, D)), torch.zeros((0, D))
        pages = torch.as_tensor([int(pt[b, p // PS]) for p in ps_])
        offs = torch.as_tensor([p % PS for p in ps_])
        return (tx["pk"][pages, offs, h].to(act).float(),
                tx["pv"][pages, offs, h].to(act).float())
    win = [c for c in range(S) if 0 <= i0 + c < M * PS
           and (not store or pt[b, (i0 + c) // PS] >= 0)]
    wk = tx["k"][b, win, h].to(pool).to(act).float()
    wv = tx["v"][b, win, h].to(pool).to(act).float()
    return hist, rows, win, wk, wv


def _partial(qg, k, v, vis):
    """One split's f32 partial in log2 units: (max, sum, accumulator)."""
    s = torch.where(vis, (qg @ k.T) * SCALE_LOG2, -torch.inf)
    m = s.amax(-1) if s.shape[1] else torch.full((qg.shape[0],), -torch.inf)
    p = torch.where(vis, torch.exp2(s - torch.where(
        m == -torch.inf, 0.0, m)[:, None]), 0.0)
    return m, p.sum(-1), p @ v


def split_partials(tx, pt, i0, b, h, store):
    """Slot b, kv head h: the NS partials of the split kernel, in split
    order; the window's keys go to the split that holds i0."""
    q = tx["q"]
    S = q.shape[1]
    SR = NP * PS
    ws = min(max(i0, 0) // SR, NS - 1)
    r_of = torch.arange(S * G) // G              # query row i = r * G + g
    qg = q[b, :, h * G:(h + 1) * G].float().reshape(S * G, D)
    hist, rows, win, wk, wv = _keys(tx, pt, i0, b, h, store)
    parts = []
    for sp in range(NS):
        k, v = rows([p for p in hist if sp * SR <= p < (sp + 1) * SR])
        vis = torch.ones((S * G, k.shape[0]), dtype=torch.bool)
        if sp == ws:
            k, v = torch.cat([k, wk]), torch.cat([v, wv])
            vis = torch.cat([vis, torch.as_tensor(win, dtype=torch.long)[
                None, :] <= r_of[:, None]], 1)
        parts.append(_partial(qg, k, v, vis))
    return parts


def split_emulation(tx, pt, idx, store):
    """The split-history kernel's arithmetic: per-split partials combined
    in split order. Returns (out, lse) in the kernels' layouts."""
    q = tx["q"]
    S = q.shape[1]
    out = torch.zeros((B, S, HQ, D))
    lse = torch.full((B, HQ, S), pref.NEG_INF)
    for b in range(B):
        for h in range(HKV):
            parts = split_partials(tx, pt, int(idx[b]), b, h, store)
            mx = torch.stack([m for m, _, _ in parts]).amax(0)
            L, A = torch.zeros(S * G), torch.zeros((S * G, D))
            for m, l, acc in parts:              # in split order
                w = torch.where(l > 0, torch.exp2(m - mx), 0.0)
                L, A = L + l * w, A + acc * w[:, None]
            o = torch.where(L[:, None] > 0, A / L[:, None], 0.0)
            out[b, :, h * G:(h + 1) * G] = o.reshape(S, G, D)
            ls = torch.where(L > 0, (mx + torch.log2(L)) * math.log(2),
                             pref.NEG_INF)
            lse[b, h * G:(h + 1) * G] = ls.reshape(S, G).T
    return out.to(q.dtype), lse


def _tc_softmax(qg, tiles):
    """Online softmax over key tiles as the tensor-core kernel takes them:
    log2 units, P rounded to bf16 before P V, f32 sums. Returns the
    unnormalised (m, l, acc)."""
    n = qg.shape[0]
    m = torch.full((n,), -torch.inf)
    l, o = torch.zeros(n), torch.zeros((n, D))
    for k, v, vis in tiles:
        s = torch.where(vis, qg @ k.T, -torch.inf)
        smax = s.amax(-1) if s.shape[1] else torch.full((n,), -torch.inf)
        mn = torch.maximum(m, smax * SCALE_LOG2)
        mu = torch.where(mn == -torch.inf, 0.0, mn)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(s * SCALE_LOG2 - mu[:, None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[:, None] + p.to(torch.bfloat16).float() @ v
        m = mn
    return m, l, o


def tc_emulation(tx, pt, idx, store):
    """The tensor-core window kernel's arithmetic (bf16 activations): keys
    in tiles of 32, history then window, through _tc_softmax; a window of
    one row tile (S * G <= 64) splits its history into splits of NP_TC
    pages, the window's keys in the split that holds idx, combined in
    split order. Returns (out, lse)."""
    q = tx["q"]
    S = q.shape[1]
    out = torch.zeros((B, S, HQ, D))
    lse = torch.full((B, HQ, S), pref.NEG_INF)
    r_of = torch.arange(S * G) // G
    SR = NP_TC * PS
    ns = NS_TC if S * G <= 64 else 1
    for b in range(B):
        i0 = int(idx[b])
        hend = min(max(i0, 0), M * PS)
        ws = min(max(i0, 0) // SR, ns - 1)
        for h in range(HKV):
            qg = q[b, :, h * G:(h + 1) * G].float().reshape(S * G, D)
            hist, rows, win, wk, wv = _keys(tx, pt, i0, b, h, store)
            parts = []
            for sp in range(ns):
                hs = min(sp * SR, hend) if ns > 1 else 0
                he = min(hs + SR, hend) if ns > 1 else hend
                tiles = []
                for t0 in range(hs, he, TK):     # history tiles
                    k, v = rows([p for p in hist if t0 <= p < min(t0 + TK,
                                                                  he)])
                    tiles.append((k, v, torch.ones((S * G, k.shape[0]),
                                                   dtype=torch.bool)))
                for c0 in range(0, S if sp == ws else 0, TK):  # window
                    sel = [j for j, c in enumerate(win) if c0 <= c < c0 + TK]
                    cs = torch.as_tensor([win[j] for j in sel],
                                         dtype=torch.long)
                    tiles.append((wk[sel], wv[sel],
                                  cs[None, :] <= r_of[:, None]))
                parts.append(_tc_softmax(qg, tiles))
            mx = torch.stack([m for m, _, _ in parts]).amax(0)
            L, A = torch.zeros(S * G), torch.zeros((S * G, D))
            for m, l, acc in parts:              # in split order
                w = torch.where(l > 0, torch.exp2(m - mx), 0.0)
                L, A = L + l * w, A + acc * w[:, None]
            res = torch.where(L[:, None] > 0, A / L[:, None], 0.0)
            out[b, :, h * G:(h + 1) * G] = res.reshape(S, G, D)
            ls = torch.where(L > 0, (mx + torch.log2(L)) * math.log(2),
                             pref.NEG_INF)
            lse[b, h * G:(h + 1) * G] = ls.reshape(S, G).T
    return out.to(q.dtype), lse


def _oracle(jx, tx, pt, idx, S, store):
    """The reference's out (jnp oracle) and the plain version's lse."""
    jpt, jidx = jnp.asarray(pt), jnp.asarray(idx)
    tpt, tidx = torch.from_numpy(pt), torch.from_numpy(idx)
    pk, pv = tx["pk"].clone(), tx["pv"].clone()
    if S == 1:
        want = kref.paged_decode_ref(jx["q"], jx["k"], jx["v"], jx["pk"],
                                     jx["pv"], jpt, jidx, tol=0.0)[0]
        _, lse, _, _, _ = pref.paged_decode_ref(tx["q"], tx["k"], tx["v"],
                                                pk, pv, tpt, tidx)
        lse = lse[..., None]
    else:
        want = kref.paged_window_ref(jx["q"], jx["k"], jx["v"], jx["pk"],
                                     jx["pv"], jpt, jidx, store=store,
                                     tol=0.0)[0]
        _, lse, _, _, _ = pref.paged_window_ref(
            tx["q"], tx["k"], tx["v"], pk, pv, tpt, tidx, store=store)
    return np.asarray(want.astype(jnp.float32)), lse


def _check(got, want_out, want_lse, idx, act):
    out, lse = got
    live = (want_lse > pref.NEG_INF / 2).numpy()      # (B, Hq, S)
    live_o = live.transpose(0, 2, 1)[..., None]       # (B, S, Hq, 1)
    tol = TOL[act]
    diff = np.abs(out.float().numpy() - want_out)
    assert float(np.where(live_o, diff, 0).max()) <= tol
    assert float(np.where(live, np.abs(lse.numpy() - want_lse.numpy()),
                          0).max()) <= tol
    # rows that attend nothing: 0 and NEG_INF, as the kernels return them
    assert float(np.where(live_o, 0, np.abs(out.float().numpy())).max()) == 0
    assert (lse.numpy()[~live] == pref.NEG_INF).all()
    assert live[idx >= 0].any() and not live[idx < 0].any()


PAIRS = [("float32", "float32"), ("bfloat16", "float32"),
         ("bfloat16", "bfloat16")]


@pytest.mark.parametrize("act,pool", PAIRS)
def test_split_decode_matches_reference(act, pool):
    """B1: the decode through the split history at positions spanning 1, 2
    and 3 splits, against ``paged_decode_ref``."""
    jx, tx = _inputs(1, act, pool, seed=1)
    pt = _table()
    want_out, want_lse = _oracle(jx, tx, pt, DEC_IDX, 1, True)
    got = split_emulation(tx, pt, DEC_IDX, store=True)
    _check(got, want_out, want_lse, DEC_IDX, act)


@pytest.mark.parametrize("act,pool", PAIRS)
@pytest.mark.parametrize("store", [True, False])
def test_split_verify_window_matches_reference(act, pool, store):
    """B2 at W = 5 (verify, overwrite and defer) through the split
    history, against ``paged_window_ref``."""
    jx, tx = _inputs(5, act, pool, seed=5)
    pt = _table(1)
    want_out, want_lse = _oracle(jx, tx, pt, W5_IDX, 5, store)
    got = split_emulation(tx, pt, W5_IDX, store=store)
    _check(got, want_out, want_lse, W5_IDX, act)


@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
@pytest.mark.parametrize("store", [True, False])
def test_tc_prefill_rounding_matches_reference(pool, store):
    """B2's tensor-core route at the prefill (S 128, bf16 activations):
    fresh slots at 0, prefix hits with history, an idle slot; rounding P
    to bf16 stays within the bf16 tolerance of ``paged_window_ref``."""
    jx, tx = _inputs(128, "bfloat16", pool, seed=128)
    pt = _table(2)
    want_out, want_lse = _oracle(jx, tx, pt, S128_IDX, 128, store)
    got = tc_emulation(tx, pt, S128_IDX, store=store)
    _check(got, want_out, want_lse, S128_IDX, "bfloat16")


@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
@pytest.mark.parametrize("store", [True, False])
def test_tc_verify_window_matches_reference(pool, store):
    """The tensor-core route at the verify width (W = 5, bf16 activations:
    one row tile, so the history is split 3 ways and combined in split
    order): within the bf16 tolerance of ``paged_window_ref``."""
    jx, tx = _inputs(5, "bfloat16", pool, seed=6)
    pt = _table(3)
    want_out, want_lse = _oracle(jx, tx, pt, W5_IDX, 5, store)
    got = tc_emulation(tx, pt, W5_IDX, store=store)
    _check(got, want_out, want_lse, W5_IDX, "bfloat16")


@pytest.mark.parametrize("i0,splits", [(0, 1), (16, 1), (37, 2), (64, 3),
                                       (100, 4), (144, 5), (175, 6)])
def test_decode_history_spans_splits(i0, splits):
    """A decode at i0 (history [0, i0) and the new row) has live rows in
    exactly the splits of 2 pages up to the one that holds i0; the others
    contribute l = 0: NS = 6 at M 11."""
    _, tx = _inputs(1, "float32", "float32", seed=8)
    pt = np.random.default_rng(5).permutation(P).reshape(B, M)
    parts = split_partials(tx, pt.astype(np.int32), i0, 0, 0, True)
    assert len(parts) == NS == 6
    assert [bool((l > 0).all()) for _, l, _ in parts] == [
        sp < splits for sp in range(NS)]


@pytest.mark.parametrize("S,store", [(1, True), (5, False)])
def test_slot_result_independent_of_other_slots(S, store):
    """A slot's out and lse do not change, bit for bit, when the other
    slots' history lengths change: splits follow page index, not the
    batch's longest history."""
    _, tx = _inputs(S, "bfloat16", "float32", seed=7)
    pt = _table(4)
    idx = (DEC_IDX if S == 1 else W5_IDX).copy()
    out0, lse0 = split_emulation(tx, pt, idx, store)
    other = idx.copy()
    other[1:] = np.array([5, 170, 0, 33, -S - 1, 90, 120], np.int32)
    out1, lse1 = split_emulation(tx, pt, other, store)
    assert torch.equal(out0[0], out1[0]) and torch.equal(lse0[0], lse1[0])
