"""Tier 0 of the port (``repro_torch.core.graph_lint``) against the
reference's (``repro.core.jaxpr_lint``): the golden corpus of
tests/test_jaxpr_lint.py re-expressed in PyTorch's idiom, each case run
through both linters side by side.

Each waste rule gets a planted-positive program and a clean twin that
differs only in the property the rule checks; the twin must produce no
finding of that kind. The findings' kinds, counts and bytes must equal
the reference's on the same case, and the port's findings carry the
``file:line`` of this file (the reference's lose theirs under JAX 0.9.0:
ROADMAP § C). The torch idiom of the corpus:

* ``dynamic_update_slice(x, u, (3,))`` is a store into a clone,
  ``y = x.clone(); y[3:8] = u`` (``copy_`` into a view);
  ``x.at[i].set(v)`` is ``y[i] = v`` (``index_put_``);
* ``dynamic_slice(x, (3,), (5,))`` is a materialised slice,
  ``x[3:8].clone()`` (a view alone reads nothing, as in tier 1); ``jnp.
  take`` is ``table[idx]`` (``index``);
* a ``scan`` is a Python loop over the same trips, whose unrolled loads
  the port counts as the reference weights them by trip count.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.jaxpr_lint import lint_fn as ref_lint_fn
from repro_torch.core.findings import TIER_STATIC, WasteProfile, merge
from repro_torch.core.graph_lint import lint_fn, lint_graph
from repro_torch.core.graph_trace import abstract_mode, trace_program

HERE = os.path.basename(__file__)


def kinds(prof):
    return sorted({f.kind for f in prof.findings})


def only(prof, kind):
    fs = [f for f in prof.findings if f.kind == kind]
    assert fs, f"no {kind} finding; got {kinds(prof)}"
    return fs


def assert_here(finding):
    """Provenance points into this test file at a real line."""
    f = finding.meta.get("file", "")
    assert os.path.basename(f) == HERE, f"provenance file {f!r}"
    assert finding.meta.get("line", 0) > 0


def rows(prof):
    """What both linters must agree on: (kind, count, bytes) per finding."""
    return sorted((f.kind, f.count, f.bytes) for f in prof.findings)


# ----------------------------------------------------------------------
# the corpus: (reference program, its inputs, torch twin, its inputs)
# ----------------------------------------------------------------------
def _dus(x, u, i):
    return jax.lax.dynamic_update_slice(x, u, (i,))


def j_dead_overwrite(x, u1, u2):
    return _dus(_dus(x, u1, 3), u2, 3)


def t_dead_overwrite(x, u1, u2):
    y = x.clone()
    y[3:8] = u1                        # dead: fully overwritten
    y[3:8] = u2
    return y


def j_dead_distinct(x, u1, u2):
    return _dus(_dus(x, u1, 0), u2, 9)


def t_dead_distinct(x, u1, u2):
    y = x.clone()
    y[0:5] = u1
    y[9:14] = u2
    return y


def j_dead_never_read(x, u):
    _ = _dus(x, u, 3)
    return x.sum()


def t_dead_never_read(x, u):
    y = x.clone()
    y[3:8] = u                         # y is never read again
    return x.sum()


def j_zero_add(x):
    return x + 0.0


def t_zero_add(x):
    return x + 0.0                     # provably x


def j_one_add(x):
    return x + 1.0


def t_one_add(x):
    return x + 1.0


def j_writeback(x):
    s = jax.lax.dynamic_slice(x, (3,), (5,))
    return _dus(x, s, 3)


def t_writeback(x):
    s = x[3:8].clone()
    y = x.clone()
    y[3:8] = s                         # resident value
    return y


def j_modified_writeback(x):
    s = jax.lax.dynamic_slice(x, (3,), (5,))
    return _dus(x, s * 2.0, 3)


def t_modified_writeback(x):
    s = x[3:8].clone()
    y = x.clone()
    y[3:8] = s * 2.0
    return y


def j_moved(x):
    s = jax.lax.dynamic_slice(x, (0,), (5,))
    return _dus(x, s, 9)


def t_moved(x):
    s = x[0:5].clone()
    y = x.clone()
    y[9:14] = s                        # moved, not silent
    return y


def j_scatter_back(x, i):
    return x.at[i].set(x[i])


def t_scatter_back(x, i):
    y = x.clone()
    y[i] = x[i]                        # gather -> scatter back
    return y


def j_scatter_changed(x, i):
    return x.at[i].set(x[i] + 1.0)


def t_scatter_changed(x, i):
    y = x.clone()
    y[i] = x[i] + 1.0
    return y


def j_invariant_gather(table, idx, xs):
    def body(c, x):
        row = jnp.take(table, idx, axis=0)
        return c + row.sum() + x, None
    out, _ = jax.lax.scan(body, 0.0, xs)
    return out


def t_invariant_gather(table, idx, xs):
    sums = []
    for k in range(xs.shape[0]):
        row = table[idx]                        # invariant per trip
        sums.append(row.sum() + xs[k])
    return torch.stack(sums).sum()


def j_varying_gather(table, xs):
    def body(c, x):
        row = jnp.take(table, x.astype(jnp.int32), axis=0)
        return c + row.sum(), None
    out, _ = jax.lax.scan(body, 0.0, xs)
    return out


def t_varying_gather(table, xs):
    sums = []
    for k in range(xs.shape[0]):
        row = table[xs[k:k + 1].long()]        # a new index each trip
        sums.append(row.sum())
    return torch.stack(sums).sum()


def j_dup_slice(x):
    a = jax.lax.dynamic_slice(x, (2,), (5,))
    b = jax.lax.dynamic_slice(x, (2,), (5,))
    return a + b


def t_dup_slice(x):
    a = x[2:7].clone()
    b = x[2:7].clone()                 # identical load
    return a + b


def j_distinct_slices(x):
    a = jax.lax.dynamic_slice(x, (0,), (5,))
    b = jax.lax.dynamic_slice(x, (9,), (5,))
    return a + b


def t_distinct_slices(x):
    a = x[0:5].clone()
    b = x[9:14].clone()
    return a + b


def j_moe_dead(params, x):
    h = x @ params["experts"]["e0"]["w"]
    return h.sum() + params["bias"].sum()


def t_moe_dead(params, x):
    h = x @ params["experts"]["e0"]["w"]       # expert 1 never dispatched
    return h.sum() + params["bias"].sum()


def j_moe_used(params, x):
    h = x @ params["experts"]["e0"]["w"] + x @ params["experts"]["e1"]["w"]
    return h.sum() + params["bias"].sum()


def t_moe_used(params, x):
    h = x @ params["experts"]["e0"]["w"] + x @ params["experts"]["e1"]["w"]
    return h.sum() + params["bias"].sum()


def j_zeros_add(x):
    return x + jnp.zeros((3, 5), jnp.float32)


def t_zeros_add(x):
    z = torch.zeros((3, 5), dtype=torch.float32)   # a filled constant
    return x + z


def j_checked(x, u):
    return _dus(_dus(x, u, 3), u, 3)


def t_checked(x, u):
    y = x.clone()
    y[3:8] = u
    y[3:8] = u
    return y


def _moe_params():
    return {"experts": {"e0": {"w": np.ones((7, 7), np.float32)},
                        "e1": {"w": np.ones((7, 7), np.float32)}},
            "bias": np.zeros(7, np.float32)}


Z17, O17, O5 = (np.zeros(17, np.float32), np.ones(17, np.float32),
                np.ones(5, np.float32))
I2 = np.array([2, 11])
# case -> (reference fn, torch twin, inputs as numpy pytrees)
CORPUS = {
    "dead_store_overwritten_region":
        (j_dead_overwrite, t_dead_overwrite, (Z17, O5, O5)),
    "dead_store_clean_twin_distinct_offsets":
        (j_dead_distinct, t_dead_distinct, (Z17, O5, O5)),
    "dead_store_result_never_read":
        (j_dead_never_read, t_dead_never_read, (Z17, O5)),
    "silent_store_zero_add_identity":
        (j_zero_add, t_zero_add, (np.zeros((3, 5), np.float32),)),
    "silent_store_clean_twin_nonidentity":
        (j_one_add, t_one_add, (np.zeros((3, 5), np.float32),)),
    "silent_store_slice_written_back_same_offsets":
        (j_writeback, t_writeback, (O17,)),
    "silent_store_clean_twin_modified_before_writeback":
        (j_modified_writeback, t_modified_writeback, (O17,)),
    "silent_store_clean_twin_different_offsets":
        (j_moved, t_moved, (O17,)),
    "silent_store_scatter_writeback":
        (j_scatter_back, t_scatter_back, (O17, I2)),
    "silent_store_scatter_clean_twin":
        (j_scatter_changed, t_scatter_changed, (O17, I2)),
    "redundant_load_loop_invariant_gather_in_scan":
        (j_invariant_gather, t_invariant_gather,
         (np.ones((13, 7), np.float32), np.array([1, 4]),
          np.arange(6.0, dtype=np.float32))),
    "redundant_load_clean_twin_varying_index":
        (j_varying_gather, t_varying_gather,
         (np.ones((13, 7), np.float32), np.arange(6.0, dtype=np.float32))),
    "redundant_load_duplicate_gather_same_scope":
        (j_dup_slice, t_dup_slice, (O17,)),
    "redundant_load_clean_twin_distinct_slices":
        (j_distinct_slices, t_distinct_slices, (O17,)),
    "dead_param_moe_expert_never_dispatched":
        (j_moe_dead, t_moe_dead, (_moe_params(), np.ones((3, 7), np.float32))),
    "dead_param_clean_twin_all_used":
        (j_moe_used, t_moe_used, (_moe_params(), np.ones((3, 7), np.float32))),
    "identity_chain_through_convert_and_broadcast":
        (j_zeros_add, t_zeros_add, (np.ones((3, 5), np.float32),)),
    "checked_counters_populate_fractions":
        (j_checked, t_checked, (Z17, O5)),
}
# each clean twin: the kind it must not produce
CLEAN = {
    "dead_store_clean_twin_distinct_offsets": "dead_store",
    "silent_store_clean_twin_nonidentity": "silent_store",
    "silent_store_clean_twin_modified_before_writeback": "silent_store",
    "silent_store_clean_twin_different_offsets": "silent_store",
    "silent_store_scatter_clean_twin": "silent_store",
    "redundant_load_clean_twin_varying_index": "redundant_load",
    "redundant_load_clean_twin_distinct_slices": "redundant_load",
    "dead_param_clean_twin_all_used": "dead_param",
}


def _tree(f, tree):
    if isinstance(tree, dict):
        return {k: _tree(f, v) for k, v in tree.items()}
    return f(tree)


def run_both(case, subject="t"):
    jfn, tfn, args = CORPUS[case]
    ref = ref_lint_fn(jfn, *[_tree(jnp.asarray, a) for a in args],
                      subject=subject)
    port = lint_fn(tfn, *[_tree(torch.as_tensor, a) for a in args],
                   subject=subject)
    return ref, port


@pytest.mark.parametrize("case", sorted(CORPUS))
def test_corpus_matches_reference(case):
    """Kinds, counts and bytes of every finding equal the reference's;
    a clean twin has no finding of its kind; every finding that names a
    site names this file."""
    ref, port = run_both(case)
    assert rows(port) == rows(ref), (rows(port), rows(ref))
    if case in CLEAN:
        assert not [f for f in port.findings if f.kind == CLEAN[case]]
    for f in port.findings:
        assert f.tier == TIER_STATIC
        if f.kind != "dead_param":
            assert_here(f)


def test_dead_store_overwritten_region():
    _, prof = run_both("dead_store_overwritten_region")
    ds = only(prof, "dead_store")
    assert len(ds) == 1
    assert ds[0].bytes == 5 * 4                      # the dead update
    assert ds[0].c2, "C2 must name the overwriting store"
    assert ds[0].meta["line"] == t_dead_overwrite.__code__.co_firstlineno + 2


def test_dead_store_distinct_offsets_both_sites_checked():
    _, prof = run_both("dead_store_clean_twin_distinct_offsets")
    assert prof.checked.get("dead_store", 0) == 2


def test_dead_store_result_never_read():
    _, prof = run_both("dead_store_result_never_read")
    ds = only(prof, "dead_store")
    assert "never read" in ds[0].meta["rule"]


def test_silent_store_identity_and_writeback():
    _, prof = run_both("silent_store_zero_add_identity")
    assert only(prof, "silent_store")[0].bytes == 3 * 5 * 4
    _, prof = run_both("silent_store_slice_written_back_same_offsets")
    assert "resident" in only(prof, "silent_store")[0].meta["rule"]
    _, prof = run_both("silent_store_scatter_writeback")
    assert "silent_store" in kinds(prof)


def test_redundant_load_loop_invariant_gather():
    _, prof = run_both("redundant_load_loop_invariant_gather_in_scan")
    rl = only(prof, "redundant_load")
    # re-executed trips - 1 = 5 extra trips of a (2,7) f32 gather
    assert rl[0].bytes == 5 * 2 * 7 * 4 and rl[0].count == 5
    assert "loop" in rl[0].meta["rule"] and "6" in rl[0].meta["rule"]
    assert rl[0].fraction == pytest.approx(1 - 1 / 6)


def test_redundant_load_duplicate_same_scope():
    _, prof = run_both("redundant_load_duplicate_gather_same_scope")
    rl = only(prof, "redundant_load")
    assert rl[0].bytes == 5 * 4 and "2x" in rl[0].meta["rule"]


def test_dead_param_names_the_buffer():
    _, prof = run_both("dead_param_moe_expert_never_dispatched",
                       subject="moe")
    (dp,) = only(prof, "dead_param")
    assert dp.bytes == 7 * 7 * 4
    assert "e1" in dp.meta["path"] and dp.meta["subject"] == "moe"
    _, prof = run_both("dead_param_clean_twin_all_used", subject="moe")
    assert prof.checked.get("dead_param", 0) == 4     # every placeholder


def test_checked_counters_populate_fractions():
    _, prof = run_both("checked_counters_populate_fractions")
    assert prof.fractions()["dead_store"] == 0.5      # 1 of 2 store sites


# ----------------------------------------------------------- infrastructure
def test_lint_runs_abstract_no_allocation():
    """Fake tensors in, graph out: the same findings as on real inputs,
    at a width no test could allocate."""
    mode = abstract_mode()
    with mode:
        x = torch.empty(17)
        u = torch.empty(5)
        big = torch.empty(1 << 40, dtype=torch.bfloat16)   # 2 TiB
    prof = lint_fn(t_dead_overwrite, x, u, u, subject="abstract")
    assert "dead_store" in kinds(prof)

    def f(w):
        return w + 0.0
    prof = lint_fn(f, big, subject="abstract")
    assert only(prof, "silent_store")[0].bytes == 2.0 * (1 << 40)


def test_lint_graph_entry_point_and_tier():
    traced = trace_program(lambda x: x + 0.0, torch.ones(4))
    prof = lint_graph(traced, subject="direct")
    assert prof.tiers == [TIER_STATIC]
    assert all(f.tier == TIER_STATIC for f in prof.findings)
    assert prof.meta["nodes"] == traced.nodes and traced.seconds > 0


def test_tier0_merges_with_other_tiers():
    p0 = lint_fn(lambda x: x + 0.0, torch.ones(4), subject="t")
    p3 = WasteProfile(tier=3)
    p3.add_pair("silent_store", 3, ("leaf:a",), ("step",), 64.0)
    merged = merge(p0, p3)
    assert merged.tiers == [TIER_STATIC, 3]
    ss = [f for f in merged.findings if f.kind == "silent_store"]
    assert len(ss) == 2                               # distinct keys coexist
    rt = WasteProfile.from_json(merged.to_json())
    assert rt == merged
