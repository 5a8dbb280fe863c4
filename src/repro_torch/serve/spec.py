"""Draft proposers for speculative decoding: a cheap drafter guesses the
next k tokens, the target model verifies them all in ONE width-(k+1)
forward, and every rejected draft token is a KV-cache store thrown away
(a Def.-1 dead store by construction). The engine measures that waste at
the ``rejected_draft_store`` site and, in the paged layout, eliminates it
by committing only the accepted prefix (``LM.commit_verify``).

Counterpart of src/repro/serve/spec.py: the same drafters, proposing the
same token ids for the same histories. Drafters are host-side:

  propose(history, k) -> np.ndarray   up to k int32 tokens continuing
                                      `history` (prompt + tokens emitted
                                      so far); fewer (or zero) is fine
  observe(tokens)                     optional: learn a finished
                                      request's full sequence

  NGramDrafter   self-speculative prompt lookup over the history and a
                 bounded corpus of recently served sequences.
  LMDrafter      a draft LM proposes greedily (bucketed prefill + k
                 decode steps); the target model as its own draft
                 accepts everything.
  ReplayDrafter  oracle over known continuations (accept rate 1.0).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Iterable, List, Sequence

import numpy as np
import torch


def _as_tokens(x) -> np.ndarray:
    arr = np.asarray(x, np.int32).reshape(-1)
    return arr


def _last_occurrence(seq: np.ndarray, pat: np.ndarray,
                     before: int) -> int:
    """Index AFTER the last occurrence of `pat` in seq[:before] that ends
    strictly before `before`, or -1. (The drafter wants the continuation
    that FOLLOWS the match, so a match flush at the search frontier —
    the pattern matching itself — is useless and excluded via `before`.)

    Byte-level C search (`bytes.rfind` over the int32 buffer, keeping
    only element-aligned hits): the drafter runs on the host inside the
    decode loop, so its lookup must cost microseconds, not a numpy
    sliding-window materialization per tick per slot."""
    n = pat.size
    hi = min(before, seq.size)
    if n == 0 or hi < n:
        return -1
    item = seq.dtype.itemsize
    hay = np.ascontiguousarray(seq[:hi]).tobytes()
    needle = np.ascontiguousarray(pat).tobytes()
    i = hay.rfind(needle)
    while i >= 0 and i % item:
        # unaligned byte hit (a token boundary straddle): keep searching
        # leftward, allowing overlap with the discarded hit
        i = hay.rfind(needle, 0, i + len(needle) - 1)
    if i < 0:
        return -1
    return i // item + n


class NGramDrafter:
    """Prompt-lookup self-speculation over the history + a served corpus.

    For n from `max_n` down to `min_n`, the history's tail n-gram is
    searched in the history itself (excluding the trivial tail match)
    and then in recently observed sequences; the first hit's
    continuation (up to k tokens) is the draft. A duplicated prompt
    whose donor already ran therefore drafts the donor's exact greedy
    continuation — which the verify forward accepts in full.
    """

    def __init__(self, max_n: int = 3, min_n: int = 2,
                 corpus_window: int = 32):
        assert 1 <= min_n <= max_n
        self.max_n = max_n
        self.min_n = min_n
        self._corpus: Deque[np.ndarray] = deque(maxlen=max(1, corpus_window))

    def observe(self, tokens) -> None:
        """Record a served sequence (prompt + continuation) for lookup."""
        toks = _as_tokens(tokens)
        if toks.size:
            self._corpus.appendleft(toks)

    def propose(self, history, k: int) -> np.ndarray:
        hist = _as_tokens(history)
        if k <= 0:
            return np.zeros(0, np.int32)
        for n in range(self.max_n, self.min_n - 1, -1):
            if hist.size < n:
                continue
            pat = hist[-n:]
            # the history itself first (self-speculation), then the
            # corpus most-recent-first; within a sequence the LAST
            # occurrence wins (the freshest context)
            end = _last_occurrence(hist, pat, hist.size - 1)
            if end >= 0 and end < hist.size:
                return hist[end:end + k].copy()
            for seq in self._corpus:
                end = _last_occurrence(seq, pat, seq.size)
                if end == seq.size:
                    # flush at the sequence end: no continuation there,
                    # but an EARLIER occurrence may still have one
                    end = _last_occurrence(seq, pat, seq.size - 1)
                if 0 <= end < seq.size:
                    return seq[end:end + k].copy()
        return np.zeros(0, np.int32)


class ReplayDrafter:
    """Oracle drafter over known full sequences (prompt + continuation).

    `propose` finds the sequence the history is a strict prefix of and
    returns its next k tokens — accept-rate 1.0 when the sequences came
    from the same greedy model. It isolates the verify/rollback
    machinery's cost from drafter quality (``--draft oracle``).
    """

    def __init__(self, sequences: Iterable[Sequence[int]] = ()):
        self._seqs: List[np.ndarray] = [_as_tokens(s) for s in sequences]

    def observe(self, tokens) -> None:
        toks = _as_tokens(tokens)
        if toks.size:
            self._seqs.append(toks)

    def propose(self, history, k: int) -> np.ndarray:
        hist = _as_tokens(history)
        if k <= 0:
            return np.zeros(0, np.int32)
        for seq in self._seqs:
            if seq.size > hist.size and np.array_equal(seq[:hist.size],
                                                       hist):
                return seq[hist.size:hist.size + k].copy()
        return np.zeros(0, np.int32)


class LMDrafter:
    """Greedy draft-LM proposer (the classic two-model speculative setup),
    over the port's ``LM``.

    Stateless across calls: each proposal prefills the full history into
    a fresh dense cache at the power-of-two bucket of its length, then
    runs k-1 greedy decode steps. Using the TARGET model as its own draft
    gives accept rate 1.0, which the tests use to pin the acceptance
    rule."""

    def __init__(self, model, params, max_ctx: int = 512):
        self.model = model
        self.params = params
        self.max_ctx = max_ctx
        self._kv_dtype = torch.float32

    def observe(self, tokens) -> None:  # stateless: nothing to learn
        pass

    def propose(self, history, k: int) -> np.ndarray:
        from repro_torch.serve.engine import _bucket
        hist = _as_tokens(history)
        if k <= 0 or hist.size == 0 or hist.size + k + 1 > self.max_ctx:
            return np.zeros(0, np.int32)
        dev = self.params["embed"].device
        P = _bucket(hist.size)
        toks = np.zeros((1, P), np.int32)
        toks[0, :hist.size] = hist
        cache = self.model.init_cache(self.params, 1, P + k + 1,
                                      kv_dtype=self._kv_dtype)
        cache = self.model.with_cache_index(
            cache, torch.zeros((1,), dtype=torch.int32, device=dev))
        lg, cache = self.model.prefill(
            self.params, cache, torch.as_tensor(toks, device=dev),
            lengths=torch.tensor([hist.size], dtype=torch.int32,
                                 device=dev))
        cur = lg[:, hist.size - 1:hist.size].argmax(-1).to(torch.int32)
        out = [int(cur[0, 0])]
        for _ in range(k - 1):
            lg, cache = self.model.decode_step(self.params, cache, cur)
            cur = lg[:, -1:].argmax(-1).to(torch.int32)
            out.append(int(cur[0, 0]))
        return np.asarray(out, np.int32)


def make_drafter(kind: str, *, model=None, params=None,
                 sequences: Iterable[Sequence[int]] = ()):
    """Drafter factory for drivers (`launch/serve.py --draft ...`)."""
    if kind == "ngram":
        return NGramDrafter()
    if kind == "oracle":
        return ReplayDrafter(sequences)
    if kind == "lm":
        if model is None or params is None:
            raise ValueError("the lm drafter needs a model and params")
        return LMDrafter(model, params)
    raise ValueError(f"unknown drafter kind {kind!r}")
