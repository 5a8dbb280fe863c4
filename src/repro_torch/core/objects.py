"""DJXPerf-style object registry: allocation-site provenance for every
long-lived buffer in the system (DESIGN.md § Object tier).

Port of src/repro/core/objects.py. JXPerf bills waste to flat
addresses; DJXPerf (arXiv 2104.03388) showed the actionable unit is the
*object*, the allocation a developer can rename, resize or delete. Every
KV pool page, parameter tensor, optimizer-state leaf and speculative
draft window registers an :class:`ObjectRecord` carrying

- a stable human-readable name (``replica0/kv/page7``,
  ``replica0/params/main.b0_dense.attn.wq.w``),
- its kind (``kv_page`` / ``param`` / ``opt_state`` / ``draft_window``),
- its byte size and the **allocation site** (file:line:function of the
  registering caller: ``PageAllocator.alloc``, ``params.init_tree``,
  ``adamw.init``), and
- an optional zero-argument ``reader`` returning the current contents.
  Here a reader returns the tensor itself (on its device), not a host
  copy, so `core/replicas.py` digests it where it lives.

The registry is pure bookkeeping (one dict insert per alloc).
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

OBJECT_KINDS = ("kv_page", "param", "opt_state", "draft_window")


@dataclass
class ObjectRecord:
    """One registered long-lived buffer with allocation-site provenance."""
    oid: int
    name: str
    kind: str
    nbytes: int
    file: str
    line: int
    func: str
    meta: Dict[str, Any] = field(default_factory=dict)
    reader: Optional[Callable[[], Any]] = None

    @property
    def site(self) -> str:
        """Machine-portable allocation site (file basename)."""
        return f"{os.path.basename(self.file)}:{self.line}"

    @property
    def object_key(self) -> str:
        """Stable key the WasteProfile object table coalesces on
        (kind|name|alloc-site)."""
        return f"{self.kind}|{self.name}|{self.site}"

    @property
    def owner(self) -> str:
        """Leading path segment of the name (fleet replica / subsystem)."""
        return self.name.split("/", 1)[0]


class ObjectRegistry:
    """Live-object table. register() captures the caller's file:line as
    the allocation site; release() retires an object (freed page,
    dropped window) so replica scans only see live buffers."""

    def __init__(self) -> None:
        self._records: Dict[int, ObjectRecord] = {}
        self._next_oid = 0

    def __len__(self) -> int:
        return len(self._records)

    def register(self, name: str, kind: str, nbytes: int, *,
                 reader: Optional[Callable[[], Any]] = None,
                 meta: Optional[Dict[str, Any]] = None,
                 depth: int = 1) -> ObjectRecord:
        """Register one object; the allocation site is the caller's
        frame (``depth`` frames up: pass 2 from a helper that registers
        on someone else's behalf)."""
        assert kind in OBJECT_KINDS, kind
        fr = sys._getframe(depth)
        rec = ObjectRecord(oid=self._next_oid, name=name, kind=kind,
                           nbytes=int(nbytes), file=fr.f_code.co_filename,
                           line=fr.f_lineno, func=fr.f_code.co_name,
                           meta=dict(meta or {}), reader=reader)
        self._next_oid += 1
        self._records[rec.oid] = rec
        return rec

    def release(self, oid: int) -> None:
        self._records.pop(oid, None)

    def get(self, oid: int) -> Optional[ObjectRecord]:
        return self._records.get(oid)

    def live(self, kind: Optional[str] = None) -> List[ObjectRecord]:
        recs = [r for r in self._records.values()
                if kind is None or r.kind == kind]
        return sorted(recs, key=lambda r: r.name)

    def nbytes_live(self, kind: Optional[str] = None) -> int:
        return sum(r.nbytes for r in self.live(kind))


def _leaves_with_path(tree, path=()):
    """(path, leaf) of a nested-dict tree in jax's flattening order:
    dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (str(k),))
    else:
        yield path, tree


def register_tree(registry: Optional[ObjectRegistry], owner: str, tree,
                  *, kind: str = "param",
                  meta: Optional[Dict[str, Any]] = None,
                  specs=None, mesh=None) -> List[ObjectRecord]:
    """Register every tensor leaf of a nested-dict tree under
    ``owner/<path>``, ``<path>`` the keys joined by dots (the reference's
    ``jax.tree_util.keystr`` names, in its sorted-key order).

    With ``specs`` (the tree's spec tree) and ``mesh`` the leaves are this
    rank's blocks of sharded leaves: each registers the whole leaf's byte
    size, and its reader gives a ``replicas.ShardedLeaf``, whose digest
    gathers its sampled spans from their owners.

    The fleet driver registers the (shared, in-process) parameter tree
    once per replica, which is the layout a multi-host fleet would
    materialize; the replica detector then reports those copies as the
    bit-identical weight replicas they would be."""
    if registry is None:
        return []
    spec_of = dict(_leaves_with_path(specs)) if specs is not None else {}
    out = []
    for path, leaf in _leaves_with_path(tree):
        if not hasattr(leaf, "nbytes"):
            continue
        nbytes, reader = int(leaf.nbytes), (lambda a=leaf: a)
        if specs is not None:
            from repro_torch.core.replicas import ShardedLeaf
            whole = ShardedLeaf(leaf, spec_of[path], mesh)
            nbytes, reader = whole.nbytes, (lambda a=whole: a)
        out.append(registry.register(
            f"{owner}/" + ".".join(path), kind, nbytes, reader=reader,
            meta=meta, depth=2))
    return out
