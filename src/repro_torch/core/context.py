"""Calling contexts and ⟨C1,C2⟩ pair bookkeeping (paper §5.5-§5.6).

A context is a tuple of frame labels, outermost first, ending at the
operation — the analogue of ``packageA.classB.methodC:line -> ... ->
String.equals():line``. ``context_of_op`` builds it for an operation of
a concrete run (tier 1): the user frames on the Python stack when the
operation is dispatched, from the profiled function's entry inward, then
the operation's name — the counterpart of the reference's
``context_of_eqn`` over a jaxpr equation's traceback. The frames outside
the profiled function (its caller's) are left out, so that one program
profiled from two call sites gives contexts that coalesce (§5.6).
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

# frames of torch itself and of the tier-1 recorder are not user frames;
# the recorder's ``record`` is where the profiled function was entered
_TORCH = os.path.dirname(torch.__file__) + os.sep
_RECORDER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "interpreter.py")
_ENTRY = "record"
# (code object, line) -> "file:line:function", None for an internal
# frame, or _ENTRY for the recorder's entry frame
_LABELS: Dict[Tuple[object, int], Optional[str]] = {}


def _label(frame) -> Optional[str]:
    code = frame.f_code
    key = (code, frame.f_lineno)
    try:
        return _LABELS[key]
    except KeyError:
        pass
    path = code.co_filename
    if path == _RECORDER:
        label = _ENTRY if code.co_name == _ENTRY else None
    elif path.startswith(_TORCH):
        label = None
    else:
        label = f"{os.path.basename(path)}:{frame.f_lineno}:{code.co_name}"
    _LABELS[key] = label
    return label


def context_of_op(op: str, max_frames: int = 12) -> Tuple[str, ...]:
    """Calling context of an operation dispatched now: the innermost
    `max_frames` user frames (``file:line:function``, outermost first)
    inside the recorded function, then `op`. Frames are walked with
    ``sys._getframe`` (no source file is read) and their labels cached by
    (code object, line)."""
    frames = []
    f = sys._getframe(1)
    while f is not None and len(frames) < max_frames:
        label = _label(f)
        if label is _ENTRY:
            break
        if label is not None:
            frames.append(label)
        f = f.f_back
    frames.reverse()                      # outermost -> innermost
    frames.append(op)
    return tuple(frames)


def fmt_context(ctx: Tuple[str, ...]) -> str:
    return " -> ".join(ctx)


@dataclass
class PairStats:
    count: int = 0
    bytes: float = 0.0


class PairTable:
    """⟨C_watch, C_trap⟩ -> stats, mergeable across shards (§5.6: two pairs
    coalesce iff both contexts match)."""

    def __init__(self):
        self.pairs: Dict[Tuple[Tuple[str, ...], Tuple[str, ...]], PairStats] = {}

    def add(self, c1, c2, nbytes: float) -> None:
        st = self.pairs.setdefault((c1, c2), PairStats())
        st.count += 1
        st.bytes += nbytes

    def merge(self, other: "PairTable") -> "PairTable":
        for k, v in other.pairs.items():
            st = self.pairs.setdefault(k, PairStats())
            st.count += v.count
            st.bytes += v.bytes
        return self

    def top(self, k: int = 10):
        items = sorted(self.pairs.items(), key=lambda kv: -kv[1].bytes)
        return items[:k]

    @property
    def total_count(self) -> int:
        return sum(v.count for v in self.pairs.values())
