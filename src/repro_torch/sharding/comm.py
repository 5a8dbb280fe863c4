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
first, the result cast back: on the host when staged, so a bf16 tensor
crosses to the host and back in bf16); gathers and broadcasts move the
bits as they are. Every rank of a group gets the same bits back. A
row-parallel product's partial sums (``reduce_from``) add in rank order
(``ordered_sum``), so that equal rows stay equal; bulk sums take the
ring all-reduce.

The differentiable collectives below are what the tensor-parallel and
fsdp training forwards place where GSPMD would put a collective
(Megatron's conjugate pairs): ``reduce_from`` sums partial products
(backward: identity), ``copy_to`` feeds a replicated tensor into
rank-local products (backward: all-reduce), ``gather_from`` and
``block_of`` move between a dim's blocks and the whole dim (backward:
this rank's block, an all-gather), ``gather_weight`` gathers a
fsdp-sharded weight (backward: reduce-scatter), ``mean_over`` makes a
rank's loss the mean over the ranks (backward: 1/n). Without grad
they cost what the plain collectives cost.

Under an abstract trace (``core/graph_trace.py``: the tensor is a fake
tensor) a collective runs no process group and counts nothing in
``STATS``: it emits the ``torch.ops._c10d_functional`` operation that
the program asks for, and its ``wait_tensor``, so that it is a node of
the trace with the shapes the real call gives — ``all_reduce`` as
``all_reduce``, ``all_gather`` as ``all_gather_into_tensor``,
``reduce_scatter`` as ``reduce_scatter_tensor`` (gloo runs it as a whole
all-reduce; the trace models what NCCL would run), ``ordered_sum`` as
an all-gather and the adds in rank order, ``broadcast`` as
``broadcast``. The group is named by ``group_name``, which carries the
group's size for the cost model's ring (``core/graph_cost.py``). The
differentiable collectives call these in their forward and backward, so
a traced step's backward holds its collectives too. A mesh with no
process group (``launch/mesh.py:Mesh(..., rank=r)``) traces so.
"""
from __future__ import annotations

import time
from collections import Counter

import torch
from torch._subclasses.fake_tensor import FakeTensor

# per process: collectives run, their seconds, bytes staged through the
# host for gloo (device -> host and back), and the calls by the kind a
# trace records them as ("all-reduce", "all-gather", "reduce-scatter",
# "broadcast"; ordered_sum is an all-gather)
STATS = {"calls": 0, "seconds": 0.0, "staged_bytes": 0, "kinds": Counter()}


def reset_stats() -> None:
    STATS.update(calls=0, seconds=0.0, staged_bytes=0, kinds=Counter())


def group_name(mesh, axes) -> str:
    """The name a traced collective gives its group: the axes and, after
    a slash, the group's size (``"data,model/4"``), which
    ``core/graph_cost.py:group_size`` reads back."""
    return f"{','.join(mesh.axes_of(axes))}/{mesh.axis_size(axes)}"


def _c10d():
    return torch.ops._c10d_functional


def _node(x: torch.Tensor) -> torch.Tensor:
    return _c10d().wait_tensor(x)


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


def _wide(w: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The wire tensor ``w`` of ``t`` as the reduction's buffer: float32
    for a floating t, and never t's own storage (the reduction writes
    it)."""
    x = w.float() if t.is_floating_point() else w
    if x.data_ptr() == t.data_ptr():
        x = x.clone()
    return x


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A view of t whose dtype every backend moves (bf16 and bool as
    bytes)."""
    flat = t.contiguous().reshape(-1)
    if t.dtype in (torch.bfloat16, torch.bool):
        return flat.view(torch.uint8)
    return flat


class _Timed:
    def __init__(self, kind: str):
        self.kind = kind

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        STATS["calls"] += 1
        STATS["kinds"][self.kind] += 1
        STATS["seconds"] += time.perf_counter() - self.t0


def all_reduce(t: torch.Tensor, axes, mesh, op: str = "sum") -> torch.Tensor:
    """Sum (``op="sum"``) or maximum (``"max"``) of t over the ranks of
    ``axes``; floating tensors reduce in float32."""
    if mesh.axis_size(axes) == 1:
        return t
    if isinstance(t, FakeTensor):
        w = t.float() if t.is_floating_point() else t
        return _node(_c10d().all_reduce(w.contiguous(), op, group_name(
            mesh, axes))).to(t.dtype)
    dist = _dist()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    with _Timed("all-reduce"):
        w = _wide(_to_wire(mesh, t), t)
        dist.all_reduce(w, op=red, group=mesh.group(axes))
        return _from_wire(mesh, w.to(t.dtype), t)


def all_gather(t: torch.Tensor, axes, mesh, dim: int = -1) -> torch.Tensor:
    """The ranks' tensors of ``axes`` (equal shapes) concatenated along
    ``dim`` in the order of their index over ``axes``."""
    n = mesh.axis_size(axes)
    if n == 1:
        return t
    if isinstance(t, FakeTensor):
        whole = _gathered(t, axes, mesh)
        return whole if dim % t.ndim == 0 else torch.cat(
            whole.chunk(n, dim=0), dim=dim)
    dist = _dist()
    with _Timed("all-gather"):
        w = _to_wire(mesh, _bits(t))
        parts = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w, group=mesh.group(axes))
        parts = [_from_wire(mesh, p, t).view(t.dtype).view(t.shape)
                 for p in parts]
        return torch.cat(parts, dim=dim)


def _gathered(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The traced all-gather of t: the ranks' tensors stacked along dim
    0 (``all_gather_into_tensor``'s layout)."""
    return _node(_c10d().all_gather_into_tensor(
        t.contiguous(), mesh.axis_size(axes), group_name(mesh, axes)))


def reduce_scatter(t: torch.Tensor, axes, mesh, dim: int = 0
                   ) -> torch.Tensor:
    """This rank's block (by its index over ``axes``) along ``dim`` of the
    sum of t over the ranks of ``axes``: ``all_reduce``'s sum, of which
    only the block comes back from the host when staged."""
    n = mesh.axis_size(axes)
    if n == 1:
        return t
    if isinstance(t, FakeTensor):
        w = (t.float() if t.is_floating_point() else t).movedim(dim, 0)
        out = _node(_c10d().reduce_scatter_tensor(
            w.contiguous(), "sum", n, group_name(mesh, axes)))
        return out.movedim(0, dim).to(t.dtype).contiguous()
    dist = _dist()
    with _Timed("reduce-scatter"):
        w = _wide(_to_wire(mesh, t), t)
        dist.all_reduce(w, group=mesh.group(axes))
        blk = w.shape[dim] // n
        w = w.narrow(dim, mesh.index(axes) * blk, blk)
        return _from_wire(mesh, w.to(t.dtype).contiguous(), t)


def ordered_sum(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The sum of t over the ranks of ``axes`` added in rank order, in
    float32 for a floating t. Every element's terms add in one order, so
    equal rows of partial products come back with equal bits; a ring
    all-reduce (``all_reduce``) does not promise that over more than two
    ranks, since it adds an element's terms in an order set by the
    element's offset, and the replica scan compares such rows. Its wire
    is an all-gather (n copies of t), which costs bulk sums about twice
    the ring's time (PERF.md), so gradients keep ``all_reduce``."""
    n = mesh.axis_size(axes)
    if n == 1:
        return t
    if isinstance(t, FakeTensor):
        parts = _gathered(t.reshape((1,) + tuple(t.shape)), axes, mesh)
        acc = None
        for x in parts.unbind(0):
            x = x.float() if t.is_floating_point() else x
            acc = x if acc is None else acc + x
        return acc.to(t.dtype)
    dist = _dist()
    with _Timed("all-gather"):
        w = _to_wire(mesh, _bits(t))
        parts = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w, group=mesh.group(axes))
        acc = None
        for part in parts:
            x = part.view(t.dtype).view(t.shape)
            x = x.float() if t.is_floating_point() else x
            acc = x if acc is None else acc + x
        return _from_wire(mesh, acc.to(t.dtype), t)


def broadcast(t: torch.Tensor, src: int, axes, mesh) -> torch.Tensor:
    """The tensor of the rank at index ``src`` over ``axes``, on every
    rank of them (t gives the shape and dtype elsewhere)."""
    if mesh.axis_size(axes) == 1:
        return t
    if isinstance(t, FakeTensor):
        return _node(_c10d().broadcast(t.contiguous(), src,
                                       group_name(mesh, axes)))
    dist = _dist()
    with _Timed("broadcast"):
        w = _to_wire(mesh, _bits(t)).clone()
        dist.broadcast(w, src=mesh.peers(axes)[src],
                       group=mesh.group(axes))
        return _from_wire(mesh, w, t).view(t.dtype).view(t.shape)


# ----------------------------------------------------------------------
# Differentiable collectives (training under a strategy)
# ----------------------------------------------------------------------
def _block(t: torch.Tensor, axes, mesh, dim: int) -> torch.Tensor:
    n = mesh.axis_size(axes)
    blk = t.shape[dim] // n
    return t.narrow(dim, mesh.index(axes) * blk, blk)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes, mesh):
        return ordered_sum(t, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axes, ctx.mesh), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes, mesh, dim):
        ctx.axes, ctx.mesh, ctx.dim = axes, mesh, dim
        return all_gather(t, axes, mesh, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (_block(g, ctx.axes, ctx.mesh, ctx.dim).contiguous(), None,
                None, None)


class _BlockOf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes, mesh, dim):
        ctx.axes, ctx.mesh, ctx.dim = axes, mesh, dim
        return _block(t, axes, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axes, ctx.mesh, dim=ctx.dim), None, None, None


class _GatherWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes, mesh, dim):
        ctx.axes, ctx.mesh, ctx.dim = axes, mesh, dim
        return all_gather(t, axes, mesh, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.axes, ctx.mesh, ctx.dim), None, None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes, mesh):
        ctx.n = mesh.axis_size(axes)
        return all_reduce(t, axes, mesh) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def _dim(t: torch.Tensor, dim: int) -> int:
    return dim % t.ndim


def reduce_from(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The sum of the ranks' partial tensors (a row-parallel product);
    the gradient passes to each partial as it is."""
    if mesh.axis_size(axes) == 1:
        return t
    return _ReduceFrom.apply(t, axes, mesh)


def copy_to(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """t (the same on every rank of ``axes``) as the input of rank-local
    products (a column-parallel projection): the identity, whose
    gradient is the sum of the ranks' gradients."""
    if mesh.axis_size(axes) == 1:
        return t
    return _CopyTo.apply(t, axes, mesh)


def gather_from(t: torch.Tensor, axes, mesh, dim: int = -1) -> torch.Tensor:
    """The ranks' blocks of a dim concatenated (``all_gather``); the
    whole result is the same on every rank, so its gradient's block is
    this rank's."""
    if mesh.axis_size(axes) == 1:
        return t
    return _GatherFrom.apply(t, axes, mesh, _dim(t, dim))


def block_of(t: torch.Tensor, axes, mesh, dim: int = -1) -> torch.Tensor:
    """This rank's block of a dim of t (the same on every rank of
    ``axes``): a view; the gradient is the ranks' blocks gathered."""
    if mesh.axis_size(axes) == 1:
        return t
    return _BlockOf.apply(t, axes, mesh, _dim(t, dim))


def gather_weight(t: torch.Tensor, axes, mesh, dim: int) -> torch.Tensor:
    """A fsdp-sharded leaf whole (``all_gather`` of the ranks' blocks
    along ``dim``); each rank's gradient of the whole leaf is its own
    batch's, so the backward sums them and keeps this rank's block
    (``reduce_scatter``)."""
    if mesh.axis_size(axes) == 1:
        return t
    return _GatherWeight.apply(t, axes, mesh, _dim(t, dim))


def mean_over(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The mean of t over the ranks of ``axes`` (a data-parallel loss:
    each rank's is its batch's); the gradient of each rank's t is 1/n."""
    if mesh.axis_size(axes) == 1:
        return t
    return _MeanOver.apply(t, axes, mesh)
