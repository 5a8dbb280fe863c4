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
from typing import Dict, List, Optional, Tuple

import torch

# frames of torch itself, of this file, of the tier-1 recorder, of the
# abstract tracer, of the kernels' trace-time twins and of the
# collectives (a collective's frame is its caller's, the code that
# placed it) are not user frames; the recorder's ``record`` and the
# tracer's ``_traced`` are where the profiled function was entered
_TORCH = os.path.dirname(torch.__file__) + os.sep
_HERE = os.path.dirname(os.path.abspath(__file__))
_INTERNAL = frozenset({
    os.path.join(_HERE, "context.py"),
    os.path.join(_HERE, "interpreter.py"),
    os.path.join(_HERE, "graph_trace.py"),
    os.path.join(os.path.dirname(_HERE), "kernels", "traced.py"),
    os.path.join(os.path.dirname(_HERE), "sharding", "comm.py")})
_ENTRIES = frozenset({(os.path.join(_HERE, "interpreter.py"), "record"),
                      (os.path.join(_HERE, "graph_trace.py"), "_traced")})
_ENTRY = "<entry>"
# (code object, line) -> "file:line:function", None for an internal
# frame, or _ENTRY for an entry frame
_LABELS: Dict[Tuple[object, int], Optional[str]] = {}


def _label(frame) -> Optional[str]:
    code = frame.f_code
    key = (code, frame.f_lineno)
    try:
        return _LABELS[key]
    except KeyError:
        pass
    path = code.co_filename
    if (path, code.co_name) in _ENTRIES:
        label = _ENTRY
    elif path in _INTERNAL or path.startswith(_TORCH):
        label = None
    else:
        label = f"{os.path.basename(path)}:{frame.f_lineno}:{code.co_name}"
    _LABELS[key] = label
    return label


def user_frames(max_frames: int = 12) -> List[Tuple[str, str, int]]:
    """The innermost `max_frames` user frames on the stack now, innermost
    first, inside the profiled function: ``(label, path, line)``. Frames
    are walked with ``sys._getframe`` (no source file is read) and their
    labels cached by (code object, line)."""
    frames = []
    f = sys._getframe(1)
    while f is not None and len(frames) < max_frames:
        label = _label(f)
        if label is _ENTRY:
            break
        if label is not None:
            frames.append((label, f.f_code.co_filename, f.f_lineno))
        f = f.f_back
    return frames


def context_of_op(op: str, max_frames: int = 12) -> Tuple[str, ...]:
    """Calling context of an operation dispatched now: the innermost
    `max_frames` user frames (``file:line:function``, outermost first)
    inside the recorded function, then `op`."""
    return context_of_frames(user_frames(max_frames), op)


def context_of_frames(frames, op: str) -> Tuple[str, ...]:
    """A context from ``user_frames``' list and the operation's name."""
    return tuple([label for label, _, _ in reversed(frames)] + [op])


def context_of_node(node) -> Tuple[str, ...]:
    """Calling context of a node of an abstract trace
    (``core/graph_trace.py``), the counterpart of the reference's
    ``context_of_eqn``: the user frames the tracer stamped on it, then
    its operation (``ops.<name>`` for a kernel node)."""
    ctx = node.meta.get("context")
    if ctx is not None:
        return ctx
    return (getattr(node.target, "__name__", str(node.target)),)


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
