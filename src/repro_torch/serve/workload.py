"""Trace-driven serving workload generator (DESIGN.md § Fleet tier).

Production serving is judged under traffic, not single batches: arrival
bursts, mixed prompt lengths, and — the fleet router's whole reason to
exist — duplicated prefixes (system prompts, few-shot headers) arriving
interleaved across the replica group. This module generates such traces
**seeded and replayable**: the same seed yields the same byte-identical
trace, and a trace round-trips through JSON so a measured run can be
re-measured on another revision or another routing policy.

Trace schema (version 1):

    {"version": 1,
     "meta":    {generator knobs, seed, ...},
     "requests": [{"rid": str, "arrival": int (scheduler tick),
                   "tokens": [int, ...], "max_new_tokens": int,
                   "prefix_id": int | null}, ...]}

`prefix_id` names which shared-prefix pool the prompt was drawn from
(null = unique prompt) — consumers use it to report hit-rate honesty,
the engines never see it.

Port of src/repro/serve/workload.py (host-side numpy, unchanged).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

ARRIVALS = ("poisson", "bursty", "uniform")


@dataclass
class TraceRequest:
    rid: str
    arrival: int                       # scheduler tick the request lands
    tokens: np.ndarray                 # (L,) int32 prompt
    max_new_tokens: int
    prefix_id: Optional[int] = None    # shared-prefix pool id, if any

    def to_dict(self) -> Dict:
        return {"rid": self.rid, "arrival": int(self.arrival),
                "tokens": [int(t) for t in self.tokens],
                "max_new_tokens": int(self.max_new_tokens),
                "prefix_id": self.prefix_id}

    @classmethod
    def from_dict(cls, d: Dict) -> "TraceRequest":
        return cls(rid=str(d["rid"]), arrival=int(d["arrival"]),
                   tokens=np.asarray(d["tokens"], np.int32),
                   max_new_tokens=int(d["max_new_tokens"]),
                   prefix_id=d.get("prefix_id"))


@dataclass
class Trace:
    requests: List[TraceRequest]
    meta: Dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def max_prompt_len(self) -> int:
        return max(int(r.tokens.size) for r in self.requests)

    @property
    def max_new_tokens(self) -> int:
        return max(int(r.max_new_tokens) for r in self.requests)

    def dup_fraction(self) -> float:
        """Fraction of requests drawn from a shared-prefix pool."""
        if not self.requests:
            return 0.0
        return sum(r.prefix_id is not None
                   for r in self.requests) / len(self.requests)

    def to_dict(self) -> Dict:
        return {"version": 1, "meta": dict(self.meta),
                "requests": [r.to_dict() for r in self.requests]}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict) -> "Trace":
        assert int(d.get("version", 1)) == 1, "unknown trace version"
        return cls(requests=[TraceRequest.from_dict(r)
                             for r in d.get("requests", [])],
                   meta=dict(d.get("meta", {})))

    @classmethod
    def from_json(cls, s: str) -> "Trace":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=1))
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls.from_json(f.read())


def _arrival_ticks(rng: np.random.RandomState, n: int, arrival: str,
                   rate: float, burst_size: int, burst_gap: int
                   ) -> List[int]:
    """Arrival tick per request, non-decreasing.

    poisson: exponential inter-arrivals at `rate` requests/tick
    (rounded to ticks); bursty: groups of `burst_size` land on the same
    tick, groups `burst_gap` ticks apart; uniform: one request every
    round(1/rate) ticks."""
    if arrival == "poisson":
        gaps = rng.exponential(1.0 / max(rate, 1e-9), size=n)
        return np.floor(np.cumsum(gaps)).astype(int).tolist()
    if arrival == "bursty":
        return [(i // max(burst_size, 1)) * max(burst_gap, 1)
                for i in range(n)]
    if arrival == "uniform":
        step = max(int(round(1.0 / max(rate, 1e-9))), 1)
        return [i * step for i in range(n)]
    raise ValueError(f"arrival must be one of {ARRIVALS}, got {arrival!r}")


def make_trace(*, n_requests: int, vocab_size: int, seed: int = 0,
               arrival: str = "poisson", rate: float = 1.0,
               burst_size: int = 4, burst_gap: int = 4,
               prompt_len: "tuple[int, int]" = (16, 48),
               gen_len: "tuple[int, int]" = (4, 16),
               dup_rate: float = 0.5, n_prefixes: int = 2,
               prefix_len: int = 24) -> Trace:
    """Seeded, replayable request trace.

    With probability `dup_rate` a prompt starts with one of `n_prefixes`
    shared prefixes of `prefix_len` tokens (drawn once per trace) and
    continues with a unique suffix; otherwise it is fully unique.
    Prompt/generation lengths are uniform over the inclusive ranges.
    The same knobs + seed always produce the same trace."""
    assert n_requests >= 1 and vocab_size > 1
    lo, hi = prompt_len
    assert 2 <= lo <= hi
    rng = np.random.RandomState(seed)
    pools = [rng.randint(0, vocab_size, size=prefix_len).astype(np.int32)
             for _ in range(max(n_prefixes, 1))]
    arrivals = _arrival_ticks(rng, n_requests, arrival, rate,
                              burst_size, burst_gap)
    reqs: List[TraceRequest] = []
    for i in range(n_requests):
        L = int(rng.randint(lo, hi + 1))
        dup = bool(rng.rand() < dup_rate)
        if dup:
            pid = int(rng.randint(len(pools)))
            head = pools[pid][:min(prefix_len, L - 1)]
            tail = rng.randint(0, vocab_size,
                               size=L - head.size).astype(np.int32)
            toks = np.concatenate([head, tail])
        else:
            pid = None
            toks = rng.randint(0, vocab_size, size=L).astype(np.int32)
        g = int(rng.randint(gen_len[0], gen_len[1] + 1))
        reqs.append(TraceRequest(rid=f"t{i}", arrival=int(arrivals[i]),
                                 tokens=toks, max_new_tokens=g,
                                 prefix_id=pid))
    meta = {"seed": seed, "arrival": arrival, "rate": rate,
            "burst_size": burst_size, "burst_gap": burst_gap,
            "prompt_len": list(prompt_len), "gen_len": list(gen_len),
            "dup_rate": dup_rate, "n_prefixes": n_prefixes,
            "prefix_len": prefix_len, "n_requests": n_requests,
            "vocab_size": vocab_size}
    return Trace(requests=reqs, meta=meta)


def duplicated_prefix_trace(*, n_requests: int, vocab_size: int,
                            seed: int = 0, prompt_len: int = 32,
                            prefix_len: int = 24, gen: int = 8,
                            burst_size: int = 2, burst_gap: int = 2
                            ) -> Trace:
    """The fleet acceptance workload: heavily duplicated prefixes in
    staggered bursts — the traffic shape where prefix-aware routing
    must beat random placement on TTFT and fleet Def.-3 bytes."""
    return make_trace(n_requests=n_requests, vocab_size=vocab_size,
                      seed=seed, arrival="bursty", burst_size=burst_size,
                      burst_gap=burst_gap,
                      prompt_len=(prompt_len, prompt_len),
                      gen_len=(gen, gen), dup_rate=0.8, n_prefixes=1,
                      prefix_len=prefix_len)
