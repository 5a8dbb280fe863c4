"""Tier 1 of the port (``repro_torch.core.interpreter``) against the
reference's (``repro.core.interpreter``): torch twins of the reference's
tier-1 corpus (tests/test_core.py) meet the reference tests' own
thresholds, and each twin also runs through the reference's
``profile_fn`` on the same inputs.

The two event streams are alike but not the same program. The port
records aten operations of an eager run, the reference jaxpr equations:
a jnp literal is no buffer, a scan carry or slice is a fresh buffer per
iteration where the port reads a view (``keys[i]``) at its own storage,
and the port never frees ``fn``'s arguments where the reference recycles
them after their last use. So addresses differ, and with them the traps
that cross a recycled address. Where the streams coincide event for event
in kind, extent and value (the clean chain, the loop-invariant recompute
and the FP-drift programs: checked below, event by event), totals and
checked/flagged counts must be equal; where only the element totals
coincide (the linear search, the dead stores), each fraction must agree
within FRACTION_TOL.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ProfilerConfig as RefConfig
from repro.core.interpreter import JxInterpreter as RefInterpreter
from repro.core.interpreter import profile_fn as ref_profile_fn
from repro.core.report import dump_json as ref_dump_json
from repro.core.report import load_json as ref_load_json
from repro_torch.configs.base import ProfilerConfig
from repro_torch.core.events import LOAD, STORE
from repro_torch.core.interpreter import JxInterpreter, Report, profile_fn
from repro_torch.core.report import dump_json, load_json
from repro_torch.kernels import ops

# fractions of sampled traps: at period 20 each program arms ~50-100
# watchpoints, so one trap classified differently moves a fraction by
# 1-2%; a recycled address that differs between the streams moves a few
FRACTION_TOL = 0.1

CFG = dict(period=20, num_watchpoints=4)


# ----------------------------------------------------------------------
# the corpus: reference program, torch twin, inputs (numpy)
# ----------------------------------------------------------------------
def ref_linear_search(keys, arr):
    def body(c, k):
        return c + jnp.any(arr == k).astype(jnp.int32), None
    out, _ = jax.lax.scan(body, jnp.int32(0), keys)
    return out


# the twins' initial carries: made outside the run, as the reference's
# literal initial carry becomes a buffer without a store
ZERO_I32 = torch.zeros((), dtype=torch.int32)
ZERO_F32 = torch.zeros(())


def linear_search(keys, arr):
    c = ZERO_I32
    for k in keys:
        c = c + (arr == k).any().to(torch.int32)
    return c


def ref_recompute(keys, x):
    def body(c, k):
        w = jnp.exp(x)                     # loop-invariant
        return c + w.sum() * k, None
    out, _ = jax.lax.scan(body, jnp.float32(0), keys)
    return out


def recompute(keys, x):
    c = ZERO_F32
    for k in keys:
        w = torch.exp(x)                   # loop-invariant
        c = c + w.sum() * k
    return c


def ref_wasteful(x):
    acc = jnp.float32(0)
    for i in range(20):
        w = jnp.exp(x) * (i + 1)           # stored, never loaded
        acc = acc + x.sum()
    return acc, w


def wasteful(x):
    acc = 0.0                              # a literal, as in the jaxpr
    for i in range(20):
        w = torch.exp(x) * (i + 1)         # stored, never loaded
        acc = x.sum() + acc
    return acc, w


def ref_chain(x):
    for _ in range(6):
        x = jnp.tanh(x * 1.1 + 0.3)
    return x.sum()


def chain(x):
    for _ in range(6):
        x = torch.tanh(x * 1.1 + 0.3)
    return x.sum()


def ref_drift(keys, x, eps):
    def body(c, k):
        w = x * (1.0 + eps * k)            # changes by eps each iter
        return c + w.sum(), None
    out, _ = jax.lax.scan(body, jnp.float32(0), keys)
    return out


def drift(keys, x, eps):
    c = ZERO_F32
    for k in keys:
        w = x * (1.0 + eps * k)            # changes by eps each iter
        c = c + w.sum()
    return c


SEARCH_ARGS = (np.arange(48, dtype=np.int32) % 7, np.arange(256, dtype=np.int32))
CORPUS = {
    "linear_search": (ref_linear_search, linear_search, SEARCH_ARGS),
    "recompute": (ref_recompute, recompute,
                  (np.ones(24, np.float32),
                   np.linspace(0, 1, 256, dtype=np.float32))),
    "wasteful": (ref_wasteful, wasteful,
                 (np.linspace(0, 1, 512, dtype=np.float32),)),
    "chain": (ref_chain, chain, (np.linspace(0, 1, 2048, dtype=np.float32),)),
    "drift_small": (ref_drift, drift,
                    (np.arange(24.0, dtype=np.float32),
                     np.linspace(1, 2, 128, dtype=np.float32),
                     np.float32(1e-5))),
    "drift_big": (ref_drift, drift,
                  (np.arange(24.0, dtype=np.float32),
                   np.linspace(1, 2, 128, dtype=np.float32),
                   np.float32(0.5))),
}
# the twins whose streams coincide with the reference's in the kind,
# extent and value of every event, and of those the one whose counts do
# too (its addresses differ, the reference recycling the argument's, but
# no trap crosses a recycled address)
SAME_STREAM = ("chain", "recompute", "drift_small", "drift_big")
COINCIDE = ("chain",)


def _port(name, cfg=CFG, **kw):
    _, fn, args = CORPUS[name]
    return profile_fn(fn, *[torch.as_tensor(a) for a in args],
                      cfg=ProfilerConfig(enabled=True, **cfg), **kw)


def _ref(name, cfg=CFG, **kw):
    fn, _, args = CORPUS[name]
    return ref_profile_fn(fn, *[jnp.asarray(a) for a in args],
                          cfg=RefConfig(enabled=True, **cfg), **kw)


# ----------------------------------------------------------------------
# the reference's thresholds (tests/test_core.py)
# ----------------------------------------------------------------------
def test_silent_loads_linear_search():
    rep = _port("linear_search")
    assert rep.fractions()["silent_load"] > 0.5
    assert rep.silent_loads.total_count > 0
    (c1, c2), _ = rep.silent_loads.top(1)[0]
    assert len(c1) >= 2 and len(c2) >= 2
    # user frames, then the operation: this file's twin, then aten's eq
    assert c1[-2].startswith("test_torch_interpreter.py:")
    assert c1[-2].endswith(":linear_search") and c1[-1] == "eq"


def test_silent_stores_loop_invariant_recompute():
    assert _port("recompute").fractions()["silent_store"] > 0.5


def test_dead_stores_unused_values():
    assert _port("wasteful").fractions()["dead_store"] > 0.3


def test_efficient_program_is_clean():
    fr = _port("chain").fractions()
    assert fr["silent_load"] < 0.15
    assert fr["dead_store"] < 0.15


def test_fp_tolerance_controls_silent_store():
    small = _port("drift_small").fractions()["silent_store"]
    big = _port("drift_big").fractions()["silent_store"]
    assert small > big


def test_fractions_stable_across_periods():
    fr = [_port("linear_search", cfg=dict(period=p, num_watchpoints=4))
          .fractions()["silent_load"] for p in (10, 40, 160)]
    assert max(fr) - min(fr) < 0.35, fr


# ----------------------------------------------------------------------
# against the reference's profile_fn on the same inputs
# ----------------------------------------------------------------------
def _streams(name):
    """Both recorded traces of a twin (epochs=2 keeps the trace)."""
    fn, twin, args = CORPUS[name]
    ref = RefInterpreter(RefConfig(enabled=True, **CFG))
    ref.profile(fn, *[jnp.asarray(a) for a in args], epochs=2)
    port = JxInterpreter(ProfilerConfig(enabled=True, **CFG))
    port.profile(twin, *[torch.as_tensor(a) for a in args], epochs=2)
    return list(ref.trace), list(port.trace)


@pytest.mark.parametrize("name", SAME_STREAM)
def test_streams_coincide_in_kind_extent_and_value(name):
    ref_evs, evs = _streams(name)
    assert [(e.kind, e.nelems, e.itemsize) for e in evs] == \
        [(e.kind, e.nelems, e.itemsize) for e in ref_evs]
    for e, r in zip(evs, ref_evs):
        np.testing.assert_allclose(np.asarray(e.values).reshape(-1),
                                   np.asarray(r.values).reshape(-1),
                                   rtol=1e-6)


@pytest.mark.parametrize("name", COINCIDE)
def test_coinciding_stream_gives_equal_counts(name):
    ref, port = _ref(name), _port(name)
    assert port.totals == ref.totals
    assert port.checked == ref.checked
    assert port.flagged == ref.flagged


@pytest.mark.parametrize("name", sorted(set(CORPUS) - set(COINCIDE)))
def test_other_streams_agree_within_tolerance(name):
    ref, port = _ref(name), _port(name)
    assert port.totals == ref.totals
    fr, ref_fr = port.fractions(), ref.fractions()
    assert set(fr) == set(ref_fr)
    for kind in fr:
        assert abs(fr[kind] - ref_fr[kind]) <= FRACTION_TOL, (kind, fr,
                                                              ref_fr)


# ----------------------------------------------------------------------
# trace→replay, epochs, JSON (tests/test_findings.py)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("epochs", [2, 4])
def test_trace_replay_identical_to_rerecording(epochs):
    re_rep = _port("linear_search", epochs=epochs, replay=False)
    rp_rep = _port("linear_search", epochs=epochs, replay=True)
    assert rp_rep == re_rep
    assert rp_rep.fractions() == re_rep.fractions()


def test_multi_epoch_accumulates():
    one = _port("linear_search")
    four = _port("linear_search", epochs=4)
    assert four.total_load_events == 4 * one.total_load_events
    assert sum(four.checked.values()) > sum(one.checked.values())
    assert Report is type(four)


def test_profile_json_round_trips_across_packages(tmp_path):
    """A port tier-1 profile loads with the reference's load_json, and a
    reference tier-1 profile with the port's, unchanged."""
    port = _port("linear_search")
    path = str(tmp_path / "port.json")
    dump_json(port, path)
    assert ref_load_json(path).to_dict() == port.to_dict()
    ref = _ref("linear_search")
    path = str(tmp_path / "ref.json")
    ref_dump_json(ref, path)
    assert load_json(path).to_dict() == ref.to_dict()


# ----------------------------------------------------------------------
# recording rules
# ----------------------------------------------------------------------
def test_in_place_write_after_load_keeps_the_loaded_value():
    """x is stored (copy_), then loaded and written again in place (add_):
    the earlier events keep the value x had then (a copy taken before the
    write), so the silent-store trap at the second write compares y with
    y + 1 and finds nothing silent. Reading x's storage instead would
    compare y + 1 with itself."""
    y = torch.linspace(1, 2, 64)

    def fn(x, y):
        x.copy_(y)
        x.add_(1.0)
        return x.sum()

    interp = JxInterpreter(ProfilerConfig(enabled=True, period=1,
                                          detect=("silent_store",)))
    rep = interp.profile(fn, torch.zeros(64), y, epochs=2)
    evs = [(e.kind, e.ctx[-1], e) for e in interp.trace if e.nelems == 64]
    assert [k[:2] for k in evs] == [(LOAD, "copy_"), (STORE, "copy_"),
                                    (LOAD, "add_"), (STORE, "add_"),
                                    (LOAD, "sum")]
    torch.testing.assert_close(evs[1][2].values, y, rtol=0, atol=0)
    torch.testing.assert_close(evs[2][2].values, y, rtol=0, atol=0)
    torch.testing.assert_close(evs[3][2].values, y + 1, rtol=0, atol=0)
    assert len({e.address for _, _, e in evs[1:]}) == 1
    assert interp.stats["snapshot_bytes"] == 64 * 4
    assert rep.checked["silent_store"] > 0
    assert rep.flagged.get("silent_store", 0) == 0


def test_views_and_empty_record_no_events():
    def fn(x):
        y = x.t()[1:].transpose(0, 1).unsqueeze(0).expand(2, -1, -1)
        return y, x.view(-1), x.unbind(0), torch.empty(4)

    interp = JxInterpreter()
    interp.profile(fn, torch.ones(3, 4))
    assert interp.stats["events"] == 0 and interp.stats["views"] >= 6


def test_unmarked_alias_is_a_view():
    """A 3-d matmul reaches the dispatcher as view, mm, _unsafe_view; the
    last shares mm's storage though its schema marks no alias, so it
    records nothing: one LOAD per operand and one STORE, by mm."""
    interp = JxInterpreter()
    interp.profile(torch.matmul, torch.ones(2, 3, 4), torch.ones(4, 5))
    assert [(e.kind, e.ctx[-1], e.nelems) for e in interp.trace] == [
        (LOAD, "mm", 24), (LOAD, "mm", 20), (STORE, "mm", 30)]
    assert interp.stats["ops"] == 1 and interp.stats["views"] == 2


def test_index_put_stores_the_destination_without_loading_it():
    cache = torch.zeros(6, 4)

    def fn(rows):
        cache[torch.tensor([1, 3])] = rows
        return cache.sum()

    interp = JxInterpreter()
    interp.profile(fn, torch.ones(2, 4))
    kinds = [(e.kind, e.nelems, e.ctx[-1]) for e in interp.trace]
    assert (STORE, 24, "index_put_") in kinds
    assert (LOAD, 24, "index_put_") not in kinds
    assert (LOAD, 24, "sum") in kinds


def test_kernel_entry_point_records_as_one_op():
    """ops.rmsnorm on CPU tensors (the plain version) is ONE operation:
    a LOAD per tensor input, a STORE for its output, context ending in
    ``ops.rmsnorm``; the plain version's own aten operations are not
    recorded. Its result is the entry point's outside a recording."""
    x = torch.randn(3, 16)
    scale = torch.rand(16)
    interp = JxInterpreter()
    interp.profile(lambda x, s: ops.rmsnorm(x, s, 1e-6), x, scale)
    evs = list(interp.trace)
    assert interp.stats["ops"] == interp.stats["kernel_ops"] == 1
    assert [(e.kind, e.nelems) for e in evs] == [(LOAD, 48), (LOAD, 16),
                                                  (STORE, 48)]
    assert all(e.ctx[-1] == "ops.rmsnorm" for e in evs)
    assert evs[0].ctx[-2].startswith("test_torch_interpreter.py:")
    torch.testing.assert_close(evs[2].values, ops.rmsnorm(x, scale, 1e-6),
                               rtol=0, atol=0)


def test_paged_decode_records_its_pools_as_written():
    """ops.paged_decode writes its pools in place: each pool is loaded
    (the history) and stored once, after a copy of what earlier events
    saw; the counters block is a new output."""
    B, H, D, P, ps = 2, 2, 8, 6, 4
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, 1, H, D, generator=g)
    kn = torch.randn(B, 1, H, D, generator=g)
    vn = torch.randn(B, 1, H, D, generator=g)
    pool_k = torch.randn(P, ps, H, D, generator=g)
    pool_v = torch.randn(P, ps, H, D, generator=g)
    pt = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    idx = torch.tensor([5, 2], dtype=torch.int32)

    def fn(q):
        before = pool_k.sum()
        out, _, _, cnt = ops.paged_decode(q, kn, vn, pool_k, pool_v, pt,
                                          idx, counters=True)
        return out, cnt, before

    interp = JxInterpreter()
    interp.profile(fn, q)
    evs = [e for e in interp.trace if e.ctx[-1] == "ops.paged_decode"]
    assert interp.stats["kernel_ops"] == 1
    assert [e.kind for e in evs] == [LOAD] * 7 + [STORE] * 4
    pool_n = P * ps * H * D
    assert [e.nelems for e in evs[-2:]] == [pool_n, pool_n]
    # the earlier sum's and the kernel's loads of a pool share one copy
    assert interp.stats["snapshot_bytes"] == 2 * pool_n * 4


def test_outside_a_recording_entry_points_are_unchanged():
    x = torch.randn(4, 8)
    scale = torch.rand(8)
    from repro_torch.kernels import ref
    torch.testing.assert_close(ops.rmsnorm(x, scale, 1e-6),
                               ref.rmsnorm_ref(x, scale, 1e-6),
                               rtol=0, atol=0)
    assert ops.rmsnorm.__name__ == "rmsnorm"
