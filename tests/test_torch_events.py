"""The port's event substrate (``repro_torch.core.events``) against the
reference's: the same ``MemEvent`` streams — recycled addresses, shorter
events at a watched address, NaNs, integer and float values, every
``detect`` subset, epoch resets — through ``repro.core.events.EventEngine``
and the port's must give equal profiles (``to_dict()``, watchpoint stats
included), exactly. The port's engine is also fed the same values as
tensors (contiguous and strided) and must not notice."""
import collections
import itertools

import numpy as np
import pytest
import torch
from _hypo import given, settings, st

from repro.configs.base import ProfilerConfig as RefConfig
from repro.core import events as ref_events
from repro.core.reservoir import Watchpoint as RefWatchpoint
from repro_torch.configs.base import ProfilerConfig
from repro_torch.core import events
from repro_torch.core.reservoir import ReservoirWatchpoints, Watchpoint

KINDS = ("dead_store", "silent_store", "silent_load")
DETECTS = [c for n in range(len(KINDS) + 1)
           for c in itertools.combinations(KINDS, n)]


def _stream(seed: int, n: int = 120):
    """A seeded event stream: (kind, address, nelems, itemsize, values,
    ctx) with values a numpy array whose size may fall short of nelems.
    Addresses come from a small pool (recycling, ties); an address's
    extent varies (shorter events at a watched address); values repeat
    (silent), drift by less or more than 1%, carry NaNs, and are float32,
    float64 or int32."""
    rng = np.random.RandomState(seed)
    out = []
    last = {}
    # each address keeps a dtype and a usual extent
    pool = {0: (np.float32, 16), 16: (np.float64, 3), 64: (np.float32, 40),
            200: (np.int32, 8), 1000: (np.float32, 1)}
    for i in range(n):
        addr = int(rng.choice(list(pool)))
        dtype, nelems = pool[addr]
        if rng.rand() < 0.15:                   # a shorter event there
            nelems = int(rng.randint(1, nelems + 1))
        prev = last.get((addr, nelems))
        r = rng.rand()
        if prev is not None and r < 0.5:
            vals = prev.copy()                          # silent
        elif prev is not None and r < 0.7 and dtype != np.int32:
            vals = prev * (1 + rng.choice([1e-4, 0.5]))  # small / big drift
        elif dtype == np.int32:
            vals = rng.randint(0, 3, size=nelems).astype(np.int32)
        else:
            vals = rng.randn(nelems).astype(dtype)
        if dtype != np.int32 and rng.rand() < 0.1:
            vals = vals.copy()
            vals[int(rng.randint(nelems))] = np.nan
        last[(addr, nelems)] = vals
        if rng.rand() < 0.05:                   # payload shorter than extent
            vals = vals[:max(nelems // 2, 1)]
        kind = events.STORE if rng.rand() < 0.5 else events.LOAD
        ctx = (f"f:{int(rng.randint(4))}", f"op{int(rng.randint(3))}")
        out.append((kind, addr, nelems, np.dtype(dtype).itemsize, vals, ctx))
    return out


def _as_tensor(vals, strided: bool):
    t = torch.from_numpy(np.ascontiguousarray(vals))
    if strided and t.numel() % 2 == 0 and t.numel() > 2:
        # the same C-order elements as a non-contiguous view
        t = t.reshape(2, -1).t().contiguous().t()
    return t


def _run(stream, cfg_kw, *, ref: bool, values: str = "numpy",
         epochs: int = 1):
    """Feed `stream` to one engine for `epochs` epochs (reset between);
    return the finalized profile as a dict."""
    if ref:
        eng = ref_events.EventEngine(RefConfig(enabled=True, **cfg_kw))
        mk = ref_events.MemEvent
    else:
        eng = events.EventEngine(ProfilerConfig(enabled=True, **cfg_kw))
        mk = events.MemEvent
    evs = []
    for kind, addr, nelems, isz, vals, ctx in stream:
        if values != "numpy":
            vals = _as_tensor(vals, strided=values == "strided")
        evs.append(mk(kind=kind, address=addr, nelems=nelems, itemsize=isz,
                      values=vals, ctx=ctx))
    for e in range(epochs):
        if e:
            eng.reset_epoch()
        for ev in evs:
            eng.on_event(ev)
    return eng.finalize().to_dict()


@pytest.mark.parametrize("detect", DETECTS, ids=lambda d: "+".join(d) or "none")
@pytest.mark.parametrize("tol", [0.01, 0.0])
def test_engine_equals_reference_for_every_detect_subset(detect, tol):
    """Every `detect` subset, both tolerances, two seeds and two epochs:
    the port's profile equals the reference's, numpy or tensor values."""
    for seed in (0, 1):
        stream = _stream(seed)
        kw = dict(period=3, num_watchpoints=3, seed=seed, detect=detect,
                  fp_tolerance=tol)
        want = _run(stream, kw, ref=True, epochs=2)
        for values in ("numpy", "tensor", "strided"):
            got = _run(stream, kw, ref=False, values=values, epochs=2)
            assert got == want, (seed, values)


@given(st.integers(0, 10_000), st.integers(1, 12), st.integers(1, 4),
       st.integers(0, len(DETECTS) - 1))
@settings(max_examples=30, deadline=None)
def test_engine_equals_reference_property(seed, period, nslots, di):
    kw = dict(period=period, num_watchpoints=nslots, seed=seed,
              detect=DETECTS[di])
    stream = _stream(seed, n=60)
    assert _run(stream, kw, ref=False) == _run(stream, kw, ref=True)


def test_trace_replay_equals_live_feed():
    """Replaying an EventTrace gives what feeding its events one by one
    gives, and the reference engine's replay of the same stream."""
    stream = _stream(7)
    kw = dict(period=4, num_watchpoints=4, seed=7)
    trace = events.EventTrace()
    ref_trace = ref_events.EventTrace()
    for kind, addr, nelems, isz, vals, ctx in stream:
        trace.append(events.MemEvent(kind, addr, nelems, isz, vals, ctx))
        ref_trace.append(ref_events.MemEvent(kind, addr, nelems, isz, vals,
                                             ctx))
    assert trace.element_events == ref_trace.element_events
    eng = events.EventEngine(ProfilerConfig(enabled=True, **kw))
    ref = ref_events.EventEngine(RefConfig(enabled=True, **kw))
    for e in range(3):
        if e:
            eng.reset_epoch()
            ref.reset_epoch()
        eng.replay(trace)
        ref.replay(ref_trace)
    assert eng.finalize().to_dict() == ref.finalize().to_dict()
    assert eng.finalize().to_dict() == _run(stream, kw, ref=False, epochs=3)


@pytest.mark.parametrize("period", [1, 7, 5000])
def test_sampler_gaps_equal_reference(period):
    """The sampler draws the reference's gaps and samples the
    reference's offsets, across resets and events of every size."""
    ours = events.GeometricSampler(period, np.random.RandomState(3))
    ref = ref_events.GeometricSampler(period, np.random.RandomState(3))
    rng = np.random.RandomState(0)
    for i in range(300):
        n = int(rng.choice([0, 1, 5, 100, 20_000]))
        if i % 50 == 0:
            ours.reset()
            ref.reset()
        assert ours.advance(n) == ref.advance(n)


@pytest.mark.parametrize("a,b,tol", [
    (0.0, 0.0, 0.01), (0.0, 1.0, 0.01), (1.0, 1.005, 0.01),
    (1.005, 1.0, 0.01), (np.nan, np.nan, 0.01), (1.0, 1.0, 0.0),
    (1.0, 1.0000001, 0.0), (-2.0, -2.01, 0.01), (3, 3, 0.01), (3, 4, 0.5)])
def test_approx_equal_matches_reference(a, b, tol):
    dt = np.int32 if isinstance(a, int) else np.float32
    want = ref_events.approx_equal(dt(a), dt(b), tol)
    assert events.approx_equal(dt(a), dt(b), tol) == want


# ----------------------------------------------------------------------
# the reference's trap edge cases (tests/test_core.py, test_substrate.py)
# ----------------------------------------------------------------------
def _store_ev(mod, addr, values, ctx=("s",)):
    values = np.asarray(values, np.float32)
    return mod.MemEvent(kind=mod.STORE, address=addr, nelems=values.size,
                        itemsize=4, values=values, ctx=ctx)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_value_at_outside_extent_is_none(as_tensor):
    vals = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    ev = events.MemEvent(events.STORE, 0, 4, 4,
                         torch.from_numpy(vals) if as_tensor else vals, ("s",))
    assert float(ev.value_at(3)) == 4.0
    assert ev.value_at(4) is None          # no clamping to the last element
    assert ev.value_at(100) is None
    assert ev.values_at([100, 0, 4, 2]) == [None, 1.0, None, 3.0]
    assert events.MemEvent(events.STORE, 0, 4, 4, None,
                           ("s",)).value_at(0) is None


@pytest.mark.parametrize("mod", [ref_events, events], ids=["ref", "port"])
def test_shorter_event_at_watched_address_disarms_without_classify(mod):
    cfg_cls = RefConfig if mod is ref_events else ProfilerConfig
    wp_cls = RefWatchpoint if mod is ref_events else Watchpoint
    eng = mod.EventEngine(cfg_cls(enabled=True, period=10_000,
                                  num_watchpoints=4,
                                  detect=("silent_store",)))
    eng.wp[mod.STORE].on_sample(wp_cls(
        address=7, offset=5, size=4, value=np.float32(5.0),
        context=("arm",), trap_type="W_TRAP", meta="silent_store"))
    eng.on_event(_store_ev(mod, 7, [5.0, 5.0], ctx=("short",)))
    assert eng.wp[mod.STORE].armed() == []
    assert eng.profile.checked.get("silent_store", 0) == 0
    eng.wp[mod.STORE].on_sample(wp_cls(
        address=7, offset=1, size=4, value=np.float32(5.0),
        context=("arm",), trap_type="W_TRAP", meta="silent_store"))
    eng.on_event(_store_ev(mod, 7, [0.0, 5.0], ctx=("short",)))
    assert eng.profile.checked["silent_store"] == 1
    assert eng.profile.flagged["silent_store"] == 1
    # a payload shorter than the extent skips (never clamps) the compare
    eng2 = mod.EventEngine(cfg_cls(enabled=True, period=10_000,
                                   num_watchpoints=4,
                                   detect=("silent_load",)))
    eng2.wp[mod.LOAD].on_sample(wp_cls(
        address=3, offset=6, size=4, value=np.float32(1.0),
        context=("arm",), trap_type="RW_TRAP", meta="silent_load"))
    eng2.on_event(mod.MemEvent(kind=mod.LOAD, address=3, nelems=8,
                               itemsize=4, values=np.ones(4, np.float32),
                               ctx=("l",)))
    assert eng2.wp[mod.LOAD].armed() == []
    assert eng2.profile.checked.get("silent_load", 0) == 0


def _tie_profile(mod, cfg_cls):
    eng = mod.EventEngine(cfg_cls(enabled=True, period=1, num_watchpoints=4,
                                  seed=0))
    vals = np.arange(16.0, dtype=np.float32)
    eng.on_event(mod.MemEvent(kind=mod.STORE, address=100, nelems=16,
                              itemsize=4, values=vals, ctx=("writerA",)))
    armed = [(w.offset, w.meta) for w in eng.wp[mod.STORE].armed()]
    eng.on_event(mod.MemEvent(kind=mod.STORE, address=100, nelems=8,
                              itemsize=4, values=vals[:8], ctx=("writerB",)))
    return eng, armed


def test_stale_ties_disarm_as_in_reference():
    """Equal-address ties with stale watchpoints resolve as in the
    reference: the same armed set, the same profile."""
    eng, armed = _tie_profile(events, ProfilerConfig)
    ref, ref_armed = _tie_profile(ref_events, RefConfig)
    assert armed == ref_armed
    assert sum(1 for off, _ in armed if off >= 8) >= 1
    assert eng.finalize().to_dict() == ref.finalize().to_dict()
    in_extent = sum(1 for off, _ in armed if off < 8)
    prof = eng.profile
    assert (prof.checked.get("dead_store", 0)
            + prof.checked.get("silent_store", 0)) == in_extent


@given(st.integers(1, 60), st.integers(0, 10_000))
@settings(max_examples=30, deadline=None)
def test_store_sampling_arms_one_watchpoint_per_sample(k, seed):
    cfg = ProfilerConfig(enabled=True, period=1, num_watchpoints=1,
                         seed=seed, detect=("dead_store", "silent_store"))
    eng = events.EventEngine(cfg)
    for i in range(k):       # distinct addresses: no traps interfere
        eng.on_event(_store_ev(events, 100 + i, [float(i)], ctx=(f"c{i}",)))
    s = eng.wp[events.STORE].stats
    assert s["armed"] + s["replaced"] + s["rejected"] == k
    armed = eng.wp[events.STORE].armed()
    assert len(armed) == 1 and 100 <= armed[0].address < 100 + k
    assert armed[0].meta in ("dead_store", "silent_store")


def test_store_reservoir_survival_uniform():
    k, trials = 6, 600
    counts = collections.Counter()
    for t in range(trials):
        eng = events.EventEngine(ProfilerConfig(
            enabled=True, period=1, num_watchpoints=1, seed=t,
            detect=("dead_store", "silent_store")))
        for i in range(k):
            eng.on_event(_store_ev(events, 100 + i, [float(i)],
                                   ctx=(f"c{i}",)))
        counts[eng.wp[events.STORE].armed()[0].address - 100] += 1
    expect = trials / k
    for i in range(k):
        assert abs(counts[i] - expect) < 0.35 * expect, (i, counts[i])


def test_reservoir_matching_and_disarm_all():
    rw = ReservoirWatchpoints(3, 0)
    for i in range(3):
        rw.on_sample(Watchpoint(address=i % 2, offset=0, size=4, value=i,
                                context=(f"c{i}",), trap_type="W_TRAP"))
    assert [w.value for w in rw.matching(lambda w: w.address == 0)] == [0, 2]
    rw.disarm_all()
    assert rw.armed() == [] and rw.counts == [0, 0, 0]
    assert rw.on_sample(Watchpoint(address=5, offset=0, size=4, value=5,
                                   context=("c",), trap_type="W_TRAP"))


def test_digest_of_tensor_equals_numpy():
    vals = np.arange(12, dtype=np.float32).reshape(3, 4)
    a = events.MemEvent(events.LOAD, 0, 12, 4, vals, ("x",))
    b = events.MemEvent(events.LOAD, 0, 12, 4, torch.from_numpy(vals),
                        ("x",))
    ref = ref_events.MemEvent(events.LOAD, 0, 12, 4, vals, ("x",))
    assert a.digest() == b.digest() == ref.digest()
