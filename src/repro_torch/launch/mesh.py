"""Device meshes and the rank launcher.

Port of src/repro/launch/mesh.py. JAX shards from one controller over a
mesh of devices; PyTorch shards by running one process per rank. A
``Mesh`` here keeps the reference's names on top — ``.shape`` is the
reference's ``{axis: size}`` dict, ``axis_names`` its axes — and adds
what one rank needs: its coordinates, its device and one process group
per set of axes (``group``), made by ``join``. A mesh made by the
builders below is abstract (no processes): it serves spec computation at
production sizes, and a mesh of one rank needs no process group at all.
An abstract mesh at any ``rank`` also traces that rank's step on fake
tensors (``core/graph_trace.py``): its specs, ``rank_batch`` and cache
chunks are that rank's, and its collectives are nodes of the trace
(``sharding/comm.py``), so no process is joined.

``launch`` starts one process per rank (spawned, never forked: a parent
that has initialised CUDA cannot fork), joins them into a mesh and runs
a function on each, returning each rank's result.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import pickle
import queue as _queue
import shutil
import tempfile
import time
import traceback
import uuid
from typing import Any, Callable, Dict, Optional, Sequence, Tuple


class Mesh:
    """A named grid of ranks, seen from one rank (``rank``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 rank: int = 0, device=None, backend: Optional[str] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} vs axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(n) for n in shape)))
        self.size = int(math.prod(self.shape.values()))
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.coords = self._unravel(rank)
        self.device = device
        self.backend = backend
        self._groups: Dict[Tuple[str, ...], Any] = {}

    def _unravel(self, rank: int) -> Dict[str, int]:
        out = {}
        for a in reversed(self.axis_names):
            rank, out[a] = divmod(rank, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def _ravel(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    @staticmethod
    def axes_of(axes) -> Tuple[str, ...]:
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def axis_size(self, axes) -> int:
        return int(math.prod(self.shape[a] for a in self.axes_of(axes)))

    def index(self, axes) -> int:
        """This rank's index over ``axes`` taken together, row-major (the
        reference's ``_axis_index`` in a shard_map body)."""
        i = 0
        for a in self.axes_of(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def peers(self, axes) -> Tuple[int, ...]:
        """The global ranks that share every coordinate with this rank
        except ``axes``, in the order of their index over ``axes``."""
        axes = self.axes_of(axes)
        out = []
        for vals in itertools.product(*(range(self.shape[a])
                                        for a in axes)):
            c = dict(self.coords)
            c.update(zip(axes, vals))
            out.append(self._ravel(c))
        return tuple(out)

    def group(self, axes):
        """The process group of this rank's peers over ``axes`` (None for
        an axis set of one rank)."""
        axes = self.axes_of(axes)
        if self.axis_size(axes) == 1:
            return None
        key = tuple(a for a in self.axis_names if a in axes)
        if key != axes:
            raise ValueError(f"axes {axes} out of mesh order "
                             f"{self.axis_names}")
        if key not in self._groups:
            raise RuntimeError(f"mesh has no process group over {key}: "
                               f"an abstract mesh, or not joined")
        return self._groups[key]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"backend={self.backend})")


# ----------------------------------------------------------------------
# The reference's builders (abstract meshes: shapes, no processes)
# ----------------------------------------------------------------------
def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_host_mesh() -> Mesh:
    """One-rank mesh (data=1, model=1): runs with no process group."""
    return Mesh((1, 1), ("data", "model"))


def elastic_shape(num_devices: int) -> Tuple[int, int]:
    """Best-effort (data, model) shape from a surviving device count."""
    model = 16
    while model > 1 and num_devices % model:
        model //= 2
    return num_devices // model, model


def make_elastic_mesh(num_devices: int, *, rank: int = 0) -> Mesh:
    """The (data, model) mesh of ``elastic_shape`` (the elastic-restart
    path, checkpoint/elastic.py), seen from ``rank``."""
    return Mesh(elastic_shape(num_devices), ("data", "model"), rank=rank)


# ----------------------------------------------------------------------
# Processes
# ----------------------------------------------------------------------
def default_backend(device) -> str:
    """NCCL when every rank has a card of its own, else gloo (NCCL refuses
    two ranks on one device; collectives on CUDA tensors then go through
    the host, sharding/comm.py)."""
    if isinstance(device, (list, tuple)):
        devs = [str(d) for d in device]
        if all(d.startswith("cuda") for d in devs) \
                and len(set(devs)) == len(devs):
            return "nccl"
    return "gloo"


def join(shape: Sequence[int], axis_names: Sequence[str], rank: int, *,
         init_method: str, backend: str = "gloo", device=None,
         timeout_s: float = 600.0) -> Mesh:
    """Join this process to the mesh as ``rank``: the default process
    group, then one group per set of axes of more than one rank (every
    rank creates every group, in one order)."""
    import torch.distributed as dist
    mesh = Mesh(shape, axis_names, rank=rank, device=device,
                backend=backend)
    if mesh.size == 1:
        return mesh
    dist.init_process_group(backend, init_method=init_method,
                            world_size=mesh.size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    names = mesh.axis_names
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(names, k):
            if mesh.axis_size(axes) == 1:
                continue
            others = [a for a in names if a not in axes]
            for vals in itertools.product(*(range(mesh.shape[a])
                                            for a in others)):
                base = dict(zip(others, vals))
                ranks = []
                for avals in itertools.product(*(range(mesh.shape[a])
                                                 for a in axes)):
                    c = dict(base)
                    c.update(zip(axes, avals))
                    ranks.append(mesh._ravel(c))
                g = dist.new_group(sorted(ranks), backend=backend)
                if rank in ranks:
                    mesh._groups[axes] = g
    return mesh


def leave(mesh: Mesh) -> None:
    import torch.distributed as dist
    if mesh.size > 1 and dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank, shape, axis_names, init_method, backend, devices,
               threads, fn, args, results):
    import torch
    try:
        dev = devices[rank]
        if str(dev).startswith("cuda"):
            torch.cuda.set_device(torch.device(dev))
        torch.set_num_threads(threads)
        mesh = join(shape, axis_names, rank, init_method=init_method,
                    backend=backend, device=torch.device(dev))
        try:
            out = fn(mesh, *args)
        finally:
            leave(mesh)
        # pickled here by value: through the queue a tensor's storage
        # would be shared by a file descriptor that this process serves,
        # and it exits right after
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:                      # reported to the parent
        results.put((rank, False, traceback.format_exc()))


def launch(fn: Callable, shape: Sequence[int],
           axis_names: Sequence[str] = ("data", "model"), *,
           args: Tuple = (), device="cpu", backend: Optional[str] = None,
           init_dir: Optional[str] = None, threads: int = 1,
           timeout_s: float = 900.0) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a ``shape`` mesh, one
    spawned process a rank, and return the ranks' results in rank order.

    ``device``: one device for every rank (e.g. "cpu", or "cuda:0" for
    ranks sharing one card) or a list, one a rank. The ranks meet through
    a ``file://`` store in ``init_dir`` (a fresh temporary directory when
    None), so concurrent launches never share a port. ``fn`` and its
    results must pickle; a rank that raises ends every rank, and the
    parent raises with that rank's traceback."""
    import torch.multiprocessing as mp
    n = int(math.prod(shape))
    devices = (list(device) if isinstance(device, (list, tuple))
               else [device] * n)
    backend = backend or default_backend(devices)
    tmp = init_dir or tempfile.mkdtemp(prefix="mesh_")
    init = "file://" + os.path.join(tmp, f"store_{uuid.uuid4().hex}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        r, tuple(shape), tuple(axis_names), init, backend, devices, threads,
        fn, args, results), daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < n:
            try:
                rank, ok, val = results.get(timeout=1.0)
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:       # a rank that died before it could report
                    raise RuntimeError(f"mesh launch: rank {dead[0]} "
                                       f"exited with code "
                                       f"{procs[dead[0]].exitcode}")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"mesh launch: no result within "
                                       f"{timeout_s} s ({sorted(out)} "
                                       f"done)")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{val}")
            out[rank] = pickle.loads(val)
    finally:
        for p in procs:
            p.join(timeout=30 if len(out) == n else 1)
            if p.is_alive():
                p.terminate()
                p.join()
        if init_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(n)]
