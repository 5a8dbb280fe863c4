"""Collectives over a named mesh axis (the port's stand-ins for the
reference's ``pmax``/``psum`` in shard_map bodies and for the transfers
GSPMD inserts).

Every function takes a rank-local tensor, the mesh (launch/mesh.py) and
the axes to communicate over, and returns a new tensor; over axes of one
rank it returns its input. Under NCCL (each rank on a card of its own)
CUDA tensors go to the collective as they are. Under gloo (the CPU, or
ranks sharing one card, which NCCL refuses) a CUDA tensor is copied to
the host, reduced or gathered there, and copied back: ``STATS`` counts
those bytes (both ways), and the calls and seconds of every collective.

Reductions of floating tensors run in float32 (a bf16 tensor is widened
first, the result cast back); gathers and broadcasts move the bits as
they are. Every rank of a group gets the same bits back.
"""
from __future__ import annotations

import time

import torch

# per process: collectives run, their seconds, bytes staged through the
# host for gloo (device -> host and back)
STATS = {"calls": 0, "seconds": 0.0, "staged_bytes": 0}


def reset_stats() -> None:
    STATS.update(calls=0, seconds=0.0, staged_bytes=0)


def _dist():
    import torch.distributed as dist
    return dist


def _staged(mesh, t: torch.Tensor) -> bool:
    return mesh.backend != "nccl" and t.device.type != "cpu"


def _to_wire(mesh, t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    if _staged(mesh, t):
        STATS["staged_bytes"] += t.numel() * t.element_size()
        return t.cpu()
    return t


def _from_wire(mesh, w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if w.device != like.device:
        STATS["staged_bytes"] += w.numel() * w.element_size()
        return w.to(like.device)
    return w


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A view of t whose dtype every backend moves (bf16 and bool as
    bytes)."""
    flat = t.contiguous().reshape(-1)
    if t.dtype in (torch.bfloat16, torch.bool):
        return flat.view(torch.uint8)
    return flat


class _Timed:
    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        STATS["calls"] += 1
        STATS["seconds"] += time.perf_counter() - self.t0


def all_reduce(t: torch.Tensor, axes, mesh, op: str = "sum") -> torch.Tensor:
    """Sum (``op="sum"``) or maximum (``"max"``) of t over the ranks of
    ``axes``; floating tensors reduce in float32."""
    if mesh.axis_size(axes) == 1:
        return t
    dist = _dist()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    with _Timed():
        x = t.float() if t.is_floating_point() else t
        w = _to_wire(mesh, x)
        if w is x or w.data_ptr() == x.data_ptr():
            w = w.clone()
        dist.all_reduce(w, op=red, group=mesh.group(axes))
        return _from_wire(mesh, w, t).to(t.dtype)


def all_gather(t: torch.Tensor, axes, mesh, dim: int = -1) -> torch.Tensor:
    """The ranks' tensors of ``axes`` (equal shapes) concatenated along
    ``dim`` in the order of their index over ``axes``."""
    n = mesh.axis_size(axes)
    if n == 1:
        return t
    dist = _dist()
    with _Timed():
        w = _to_wire(mesh, _bits(t))
        parts = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w, group=mesh.group(axes))
        parts = [_from_wire(mesh, p, t).view(t.dtype).view(t.shape)
                 for p in parts]
        return torch.cat(parts, dim=dim)


def broadcast(t: torch.Tensor, src: int, axes, mesh) -> torch.Tensor:
    """The tensor of the rank at index ``src`` over ``axes``, on every
    rank of them (t gives the shape and dtype elsewhere)."""
    if mesh.axis_size(axes) == 1:
        return t
    dist = _dist()
    with _Timed():
        w = _to_wire(mesh, _bits(t)).clone()
        dist.broadcast(w, src=mesh.peers(axes)[src],
                       group=mesh.group(axes))
        return _from_wire(mesh, w, t).view(t.dtype).view(t.shape)
