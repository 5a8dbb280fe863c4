"""OJXPerf-style replica-object detection (DESIGN.md § Object tier).

Port of src/repro/core/replicas.py. OJXPerf (arXiv 2203.12712) samples
object contents and reports bit-identical *replica* objects, memory a
dedup would reclaim. The detector content-hashes every live object in a
`core/objects.py` registry (sampled, chunked digests, so the scan stays
light at fleet scale) and emits one tier-5 finding per replica group:

- ``replica_kv_page``: duplicate KV pool pages, the duplicated-prefix
  pages the ``PrefixIndex`` missed (same-burst admissions whose prefixes
  were not yet registered, or reuse cut at mismatched page boundaries).
  Fix: content-addressed page routing and admission (``content_dedup``
  on the router and the engine).
- ``replica_param``: weight tensors replicated across fleet replicas.
  Fix: a shared weight arena mapped once per host.
- ``replica_opt_state``: bit-identical optimizer-state leaves (freshly
  zero-initialized moments). Fix: dedup or lazy-materialize.

Every finding carries the duplicate's allocation site (file:line from
the registry) for the SARIF ``physicalLocation``, the member object keys
as its ⟨C1,C2⟩, and a ``meta["fix"]`` naming the dedup. Replica bytes are
also billed to the duplicate objects in the profile's object table.

A CUDA tensor is digested on its device: its sampled chunks are
gathered there and only they (at most 32 KiB) are copied to the host,
and the all-zero test of a KV page runs there too. The digest equals
the reference's for the same bytes, shape and dtype.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.findings import TIER_OBJECT, Finding, WasteProfile
from repro_torch.core.objects import ObjectRecord, ObjectRegistry

# object kind -> replica finding kind
REPLICA_KINDS = {
    "kv_page": "replica_kv_page",
    "param": "replica_param",
    "opt_state": "replica_opt_state",
    "draft_window": "replica_draft_window",
}

FIXES = {
    "replica_kv_page": ("content-addressed page dedup: route and admit "
                        "same-content prefixes to the owning replica so "
                        "the PrefixIndex shares one physical page "
                        "(engine/router content_dedup)"),
    "replica_param": ("shared weight arena: map one parameter copy and "
                      "hand every replica a view"),
    "replica_opt_state": ("dedup identical optimizer-state leaves "
                          "(zero-init moments): lazy-materialize on "
                          "first non-zero update"),
    "replica_draft_window": ("share one draft window per replica batch "
                             "instead of per slot"),
}

# digest the whole buffer below this size; sample chunks above it
_FULL_BELOW = 1 << 16
_CHUNK = 4096
_N_STRIDED = 6


def _sample_spans(nbytes: int):
    """(offset, length) of the byte spans a digest hashes, in order."""
    if nbytes <= _FULL_BELOW:
        return [(0, nbytes)]
    step = max((nbytes - 2 * _CHUNK) // (_N_STRIDED + 1), 1)
    return ([(0, _CHUNK), (nbytes - _CHUNK, _CHUNK)]
            + [(_CHUNK + i * step, _CHUNK)
               for i in range(1, _N_STRIDED + 1)])


class ShardedLeaf:
    """A leaf that lives in blocks on the ranks of a mesh: this rank's
    ``block`` of it under ``spec`` (sharding/rules.py). A registry reader
    returns one for a sharded parameter or optimizer leaf; its digest is
    the whole leaf's, every sampled span gathered from the ranks that
    hold it (``read_spans``). Every rank of the mesh must digest the same
    leaves in the same order."""

    def __init__(self, block: torch.Tensor, spec, mesh):
        from repro_torch.sharding.rules import global_shape
        self.block, self.spec, self.mesh = block, spec, mesh
        self.shape = global_shape(block.shape, spec, mesh)
        self.dtype = block.dtype
        self.nbytes = int(np.prod(self.shape)) * block.element_size()

    def read_spans(self, spans) -> List[bytes]:
        """The whole leaf's bytes at each (offset, length) of ``spans``:
        the elements they cover are picked from this rank's block where
        it holds them (once over the ranks that hold the same block,
        ``owns_block``), and summed over the mesh as integers, which
        puts each byte of each element together from its one owner."""
        from repro_torch.sharding import comm
        from repro_torch.sharding.rules import _names, owns_block
        t, mesh = self.block.detach(), self.mesh
        isz, dev = t.element_size(), t.device
        ranges = [(o // isz, (o + n - 1) // isz + 1) for o, n in spans]
        flat = torch.cat([torch.arange(a, b, device=dev)
                          for a, b in ranges])
        holds = torch.full_like(flat, owns_block(self.spec, mesh),
                                dtype=torch.bool)
        local = torch.zeros_like(flat)
        rest = flat
        for dim in reversed(range(len(self.shape))):
            at_dim = torch.remainder(rest, self.shape[dim])
            rest = torch.div(rest, self.shape[dim], rounding_mode="floor")
            entry = (tuple(self.spec)[dim] if dim < len(tuple(self.spec))
                     else None)
            names = _names(entry)
            blk = t.shape[dim]
            if names:
                at = mesh.index(names)
                holds &= torch.div(at_dim, blk, rounding_mode="floor") == at
                at_dim = at_dim - at * blk
            stride = int(np.prod(t.shape[dim + 1:]))
            local += at_dim.clamp(0, blk - 1) * stride
        vals = t.contiguous().reshape(-1)[local]
        got = vals.reshape(-1, 1).view(torch.uint8).to(torch.int32)
        got = torch.where(holds[:, None], got, 0).reshape(-1)
        got = comm.all_reduce(got, mesh.axis_names, mesh)
        got = got.to(torch.uint8).cpu().numpy().tobytes()
        out, at = [], 0
        for (o, n), (a, b) in zip(spans, ranges):
            lo = at + o - a * isz
            out.append(got[lo:lo + n])
            at += (b - a) * isz
        return out


def _header_and_bytes(a):
    """(numpy-spelled header, the sampled bytes) of an array or tensor, or
    of a ``ShardedLeaf`` (the whole leaf's)."""
    if isinstance(a, ShardedLeaf):
        header = (f"{tuple(int(n) for n in a.shape)}|"
                  f"{str(a.dtype).replace('torch.', '')}|{a.nbytes}")
        return header, a.read_spans(_sample_spans(a.nbytes))
    if isinstance(a, torch.Tensor):
        t = a.detach()
        nbytes = t.numel() * t.element_size()
        # numpy's spelling: a tuple shape, numpy's (and ml_dtypes') dtype
        # names, which are torch's without the "torch." prefix
        header = (f"{tuple(int(n) for n in t.shape)}|"
                  f"{str(t.dtype).replace('torch.', '')}|{nbytes}")
        buf = t.contiguous().reshape(-1).view(torch.uint8)
        spans = _sample_spans(nbytes)
        if len(spans) == 1:
            return header, [buf.cpu().numpy().tobytes()]
        got = torch.cat([buf[o:o + n] for o, n in spans]).cpu().numpy()
        return header, [got[i * _CHUNK:(i + 1) * _CHUNK].tobytes()
                        for i in range(len(spans))]
    a = np.ascontiguousarray(np.asarray(a))
    buf = a.view(np.uint8).reshape(-1)
    return (f"{a.shape}|{a.dtype}|{a.nbytes}",
            [buf[o:o + n].tobytes() for o, n in _sample_spans(a.nbytes)])


def object_digest(arr) -> str:
    """Content digest of one object's bytes, shape/dtype-qualified.

    Small objects hash fully; large ones hash head + tail + strided
    interior chunks (OJXPerf's sampling trade: identical buffers always
    digest equal, while a collision between different buffers needs them
    to agree on every sampled chunk AND shape/dtype/nbytes). ``arr`` is a
    numpy array or a tensor on any device."""
    header, chunks = _header_and_bytes(arr)
    h = hashlib.blake2b(digest_size=12)
    h.update(header.encode())
    for c in chunks:
        h.update(c)
    return h.hexdigest()


def _all_zero(buf) -> bool:
    if isinstance(buf, torch.Tensor):
        return not bool(buf.any())
    return not np.asarray(buf).any()


class ReplicaDetector:
    """Scan a registry for bit-identical live objects (per kind)."""

    def __init__(self, registry: ObjectRegistry, *, min_bytes: int = 1):
        self.registry = registry
        self.min_bytes = min_bytes

    def scan(self) -> WasteProfile:
        prof = WasteProfile(tier=TIER_OBJECT)
        for kind, fkind in REPLICA_KINDS.items():
            groups: Dict[str, List[ObjectRecord]] = {}
            for rec in self.registry.live(kind):
                if rec.reader is None or rec.nbytes < self.min_bytes:
                    continue
                buf = rec.reader()
                if kind == "kv_page" and _all_zero(buf):
                    # all-zero KV pages are unwritten budget capacity
                    # (pages cover prompt+gen up front), not content a
                    # prefix dedup could share. Zero PARAM/OPT leaves
                    # stay in: identical zero moments are the
                    # lazy-materialize finding.
                    continue
                prof.observe(fkind, False)  # checked; flag below
                groups.setdefault(object_digest(buf), []).append(rec)
            for digest, members in sorted(groups.items()):
                if len(members) < 2:
                    continue
                members.sort(key=lambda r: r.name)
                canon, dups = members[0], members[1:]
                owners = sorted({r.owner for r in members})
                waste = float(sum(r.nbytes for r in dups))
                # flip the pre-counted observations for the duplicates
                prof.flagged[fkind] = (prof.flagged.get(fkind, 0)
                                       + len(dups))
                prof.add(Finding(
                    kind=fkind, tier=TIER_OBJECT,
                    c1=(canon.object_key,),
                    c2=tuple(r.object_key for r in dups),
                    count=len(dups), bytes=waste,
                    fraction=len(dups) / len(members),
                    meta={"fix": FIXES[fkind],
                          "file": dups[0].file, "line": dups[0].line,
                          "digest": digest,
                          "replicas": owners,
                          "cross_replica": len(owners) > 1}))
                for r in dups:
                    prof.bill_object(r, "replica", r.nbytes)
        prof.bump_total("replica_bytes",
                        sum(f.bytes for f in prof.findings))
        return prof


def cross_replica_bytes(prof: WasteProfile,
                        kind: Optional[str] = None) -> float:
    """Replica bytes whose members span more than one owner: the
    fleet-level dedup opportunity (0 after content dedup)."""
    return sum(f.bytes for f in prof.findings
               if f.tier == TIER_OBJECT
               and f.meta.get("cross_replica")
               and (kind is None or f.kind == kind))
