"""Sharding strategies: logical param/activation axes -> specs.

Port of src/repro/sharding/rules.py (DESIGN.md §4): the same three
strategies and the same spec trees, leaf for leaf.

* ``dp_tp``  — batch over ("pod","data"); Megatron column/row TP over
  "model" on flattened feature dims.
* ``fsdp``   — weights/master/moments sharded over ("data","model")
  (largest divisible dim per leaf, ZeRO-3 style); pure-DP compute.
* ``tp_serve`` — decoding. Megatron TP weights; KV cache sharded over
  "model" by sequence chunks (pages of a paged pool), each shard's
  partial attention combined by log-sum-exp (serve/flash_decode.py).
  Weight-gathered serving spreads the weights over ("data","model").

Divisibility rule: a dim is only sharded if the mesh axis divides it —
otherwise it stays replicated (never implicit padding). Small leaves
(< 16Ki elements) replicate.

A spec is a ``PS``: a tuple of one entry per dim (None, an axis name or
a tuple of names), which compares equal, axis for axis, to the
reference's ``PartitionSpec``. ``local_slice``/``shard_tree`` cut a full
leaf (tree) down to what one rank of a mesh holds under its spec: the
weights of a rank, and a rank's share of a restored checkpoint.
``reshard`` moves a rank's leaf from one spec to another (the sharded
train step's param layout <-> its ZeRO optimizer layout), collectively.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import params as P
from repro_torch.sharding.ctx import Sharder

# priority order in which dims of one leaf may claim a mesh axis
_PRIORITY = ("experts", "vocab", "ffn", "q_feat", "kv_feat", "ssm_inner",
             "embed")
_SMALL = 16384  # leaves under 16Ki elements stay replicated


class PS(tuple):
    """A partition spec: one entry per leading dim (None = replicated, an
    axis name, or a tuple of names whose sizes multiply)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "PS(" + ", ".join(repr(p) for p in self) + ")"


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        return int(math.prod(mesh.shape[a] for a in name))
    return int(mesh.shape[name])


def _dp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


def _shape(x) -> Tuple[int, ...]:
    return tuple(x) if isinstance(x, tuple) else tuple(x.shape)


def leaf_spec_tp(axes: Tuple[Optional[str], ...], shape, mesh) -> PS:
    """Megatron TP: shard the highest-priority divisible feature dim on
    'model'."""
    if int(math.prod(shape)) < _SMALL:
        return PS()
    best, best_rank = None, len(_PRIORITY)
    for i, ax in enumerate(axes):
        if ax in _PRIORITY:
            rank = _PRIORITY.index(ax)
            if rank < best_rank and shape[i] % mesh.shape["model"] == 0:
                # embed only ranks for row-parallel second dims; skip
                # embed on dim 0 of 2D weights (column-parallel layout)
                if ax == "embed" and i == 0 and len(shape) > 1:
                    continue
                best, best_rank = i, rank
    spec = [None] * len(shape)
    if best is not None:
        spec[best] = "model"
    return PS(*spec)


def leaf_spec_fsdp(axes, shape, mesh) -> PS:
    """ZeRO-3: shard the largest divisible dim over (data,model) combined,
    else over 'model' alone, else replicate."""
    if int(math.prod(shape)) < _SMALL:
        return PS()
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    combined = (_axis_size(mesh, ("data", "model"))
                if "data" in mesh.shape else None)
    for i in order:
        if axes[i] == "layers":
            continue
        if combined and shape[i] % combined == 0:
            spec = [None] * len(shape)
            spec[i] = ("data", "model")
            return PS(*spec)
    for i in order:
        if axes[i] == "layers":
            continue
        if shape[i] % mesh.shape["model"] == 0:
            spec = [None] * len(shape)
            spec[i] = "model"
            return PS(*spec)
    return PS()


def map2(fn, a, *rest):
    """``fn`` over the leaves of nested-dict trees of one structure (two
    or more), leaf by leaf."""
    if isinstance(a, dict):
        for b in rest:
            if set(a) != set(b):
                raise ValueError(f"trees differ: {sorted(a)} vs "
                                 f"{sorted(b)}")
        return {k: map2(fn, a[k], *(b[k] for b in rest)) for k in a}
    return fn(a, *rest)


def _tree_specs(axes_tree, abstract_params, mesh, leaf_fn):
    """Spec tree of a parameter tree: ``abstract_params``' leaves are
    anything with a ``shape`` (declarations, tensors, fake tensors)."""
    return map2(lambda ax, p: leaf_fn(ax, _shape(p), mesh), axes_tree,
                 abstract_params)


class Strategy:
    name: str = "base"

    def __init__(self, mesh):
        self.mesh = mesh
        self.dp = _dp_axes(mesh)
        self._sharder: Optional[Sharder] = None

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """Mesh axes the global batch is sharded over."""
        return self.dp

    # ---- param specs -------------------------------------------------
    def param_specs(self, model) -> Any:
        raise NotImplementedError

    def opt_specs(self, model) -> Any:
        """Fully-sharded specs for master/m/v (ZeRO-1)."""
        return _tree_specs(model.param_axes(), model.decl(), self.mesh,
                           leaf_spec_fsdp)

    # ---- activation specs --------------------------------------------
    def act_specs(self) -> dict:
        raise NotImplementedError

    def sharder(self) -> Sharder:
        """This strategy's one Sharder (it records the global extents of
        the cache allocated under it, which every step factory of the
        same strategy then reads)."""
        if self._sharder is None:
            self._sharder = Sharder(self.mesh, self.act_specs(),
                                    self.batch_axes)
        return self._sharder

    # ---- data specs ----------------------------------------------------
    def batch_spec(self) -> PS:
        return PS(self.dp)


class DpTp(Strategy):
    name = "dp_tp"

    def param_specs(self, model):
        return _tree_specs(model.param_axes(), model.decl(), self.mesh,
                           leaf_spec_tp)

    def act_specs(self):
        dp = self.dp
        return {
            "btd": PS(dp, None, None),
            "btf": PS(dp, None, "model"),
            "btv": PS(dp, None, "model"),
            "head_w": PS("model", None),
            "becd": PS(dp, "model", None, None),
            "becf": PS(dp, "model", None, None),
            "btd_dec": PS(dp, None, None),
        }


class Fsdp(Strategy):
    name = "fsdp"

    @property
    def batch_axes(self):
        # weights are gathered per block: compute is pure DP over every
        # chip, the batch shards over (pod, data, model)
        return self.dp + ("model",)

    def param_specs(self, model):
        return _tree_specs(model.param_axes(), model.decl(), self.mesh,
                           leaf_spec_fsdp)

    def act_specs(self):
        bd = self.batch_axes
        return {
            "btd": PS(bd, None, None),
            "btf": PS(bd, None, None),
            "btv": PS(bd, None, None),
            "bshd": PS(bd, None, None, None),
            "bskv": PS(bd, None, None, None),
            "bshp": PS(bd, None, None, None),
            "becd": PS(bd, None, None, None),
            "becf": PS(bd, None, None, None),
            "btd_dec": PS(bd, None, None),
        }


class TpServe(Strategy):
    name = "tp_serve"

    def __init__(self, mesh, weight_gathered: bool = False):
        super().__init__(mesh)
        self.weight_gathered = weight_gathered

    def param_specs(self, model):
        fn = leaf_spec_fsdp if self.weight_gathered else leaf_spec_tp
        return _tree_specs(model.param_axes(), model.decl(), self.mesh, fn)

    def cache_specs(self, cache_abstract, batch: int) -> Any:
        """Stacked caches are (L, B, S, ...): batch over dp when
        divisible, KV sequence chunks over 'model'. When the batch cannot
        shard, the sequence spreads over ('data','model') instead."""
        dp = self.dp
        mesh = self.mesh
        dpn = int(math.prod(mesh.shape[a] for a in dp))

        def leaf(x):
            shape = _shape(x)
            # stacked layout: (L, B, S, ...); per-layer layout: (B, S, ...)
            if len(shape) >= 2 and shape[1] == batch:
                bdim = 1
            elif len(shape) >= 1 and shape[0] == batch:
                bdim = 0
            else:
                return PS()
            sdim = bdim + 1
            spec = [None] * len(shape)
            batch_ok = batch % dpn == 0
            if batch_ok:
                spec[bdim] = dp
            if len(shape) >= sdim + 2 and shape[sdim] >= 1024:
                if batch_ok and shape[sdim] % mesh.shape["model"] == 0:
                    spec[sdim] = "model"
                elif not batch_ok:
                    full = dp + ("model",)
                    n = int(math.prod(mesh.shape[a] for a in full))
                    if shape[sdim] % n == 0:
                        spec[sdim] = full
                    elif shape[sdim] % mesh.shape["model"] == 0:
                        spec[sdim] = "model"
            return PS(*spec)
        return P.tree_map(leaf, cache_abstract)

    def paged_cache_specs(self, cache_abstract, batch: int) -> Any:
        """Paged-pool analogue of cache_specs: the page dimension of each
        (L, P, page, Hkv, D) pool chunks over 'model'; page tables and
        indices shard over dp with the slot batch when divisible."""
        mesh = self.mesh
        dp = self.dp
        dpn = int(math.prod(mesh.shape[a] for a in dp))
        batch_ok = batch % dpn == 0

        def leaf(x):
            shape = _shape(x)
            if len(shape) == 5:            # stacked pool (L,P,page,Hkv,D)
                pages, ps = shape[1], shape[2]
                if pages * ps >= 1024 and pages % mesh.shape["model"] == 0:
                    return PS(None, "model", None, None, None)
                return PS()
            if len(shape) >= 2 and shape[1] == batch:   # (L,B[,M]) pt/idx
                return PS(None, dp if batch_ok else None,
                          *([None] * (len(shape) - 2)))
            return PS()
        return P.tree_map(leaf, cache_abstract)

    def act_specs(self):
        dp = self.dp
        return {
            "btd": PS(dp, None, None),
            "btf": PS(dp, None, "model"),
            "btv": PS(dp, None, "model"),
            "head_w": PS("model", None),
            "bshd": PS(dp, None, None, None),
            "bskv": PS(dp, None, None, None),
            "bshp": PS(dp, None, None, None),
            "becd": PS(dp, "model", None, None),
            "becf": PS(dp, "model", None, None),
            "btd_dec": PS(dp, None, None),
        }


def make_strategy(name: str, mesh, **kw) -> Strategy:
    return {"dp_tp": DpTp, "fsdp": Fsdp, "tp_serve": TpServe}[name](mesh, **kw)


# ----------------------------------------------------------------------
# A rank's share of a leaf
# ----------------------------------------------------------------------
def local_slice(x, spec, mesh, coords: Optional[Dict[str, int]] = None):
    """The slice of the full leaf ``x`` (a tensor or numpy array) that the
    rank at ``coords`` (default: ``mesh.coords``) holds under ``spec``:
    each sharded dim is cut into as many equal contiguous blocks as its
    axes have ranks together, the block index counted row-major over the
    axes in the order the spec names them (a NamedSharding's layout).
    A view where ``x`` allows one."""
    coords = mesh.coords if coords is None else coords
    index = []
    for dim, entry in enumerate(tuple(spec)):
        names = _names(entry)
        if not names:
            index.append(slice(None))
            continue
        n, at = 1, 0
        for a in names:
            n *= mesh.shape[a]
            at = at * mesh.shape[a] + coords[a]
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"divide over {names} ({n})")
        blk = size // n
        index.append(slice(at * blk, (at + 1) * blk))
    return x[tuple(index)] if index else x


def shard_tree(tree, specs, mesh, coords: Optional[Dict[str, int]] = None):
    """``local_slice`` over a nested-dict tree and its spec tree."""
    return map2(lambda x, s: local_slice(x, s, mesh, coords), tree, specs)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards over, in the order it names them."""
    return tuple(a for entry in tuple(spec) for a in _names(entry))


def global_shape(local_shape, spec, mesh) -> Tuple[int, ...]:
    """The whole leaf's shape of a rank's block under ``spec``."""
    shape = list(local_shape)
    for dim, entry in enumerate(tuple(spec)):
        for a in _names(entry):
            shape[dim] *= mesh.shape[a]
    return tuple(shape)


def owns_block(spec, mesh) -> bool:
    """True on the one rank of each group of ranks that hold the same
    block under ``spec``: index 0 of every axis the spec leaves
    replicated (how a block is counted once in a sum over the mesh)."""
    named = set(spec_axes(spec))
    return all(mesh.coords[a] == 0 for a in mesh.axis_names
               if a not in named)


def _effective(spec, mesh) -> Tuple[Tuple[str, ...], ...]:
    """A spec without its axes of one rank: two specs whose effective
    forms are equal place every block on the same rank (on a (1, 2)
    mesh, ("data", "model") and "model" are one layout)."""
    out = [tuple(a for a in _names(e) if mesh.shape[a] > 1)
           for e in tuple(spec)]
    while out and not out[-1]:
        out.pop()
    return tuple(out)


def reshard(x, src_spec, dst_spec, mesh):
    """This rank's block under ``dst_spec`` of the leaf whose block under
    ``src_spec`` it holds (``x``): every sharded dim of ``src_spec``
    all-gathered whole (sharding/comm.py), then ``local_slice`` by
    ``dst_spec`` (``PS()``: the whole leaf). Every rank of the mesh
    must call it, in the same order. ``x`` itself where the two specs
    place the blocks alike (``_effective``) or the whole leaf is asked of
    a whole leaf, else a dense tensor of its own (never a view that would
    keep a gathered leaf alive)."""
    from repro_torch.sharding import comm
    if _effective(src_spec, mesh) == _effective(dst_spec, mesh):
        return x
    for dim, entry in enumerate(tuple(src_spec)):
        names = _names(entry)
        if names:
            x = comm.all_gather(x, names, mesh, dim=dim)
    out = local_slice(x, dst_spec, mesh)
    if out.numel() != x.numel():
        out = out.clone(memory_format=torch.contiguous_format)
    return out
