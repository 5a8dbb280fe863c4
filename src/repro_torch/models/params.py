"""Parameter declaration machinery.

Models *declare* their parameters as trees (nested dicts) of
:class:`ParamDecl` (shape + logical axis names + initializer). The
materialized parameters are the same tree of tensors, so a parameter
tree of the reference (``jax.device_get(LM.init(key))``, nested dicts of
numpy arrays) loads 1:1 through :func:`from_reference`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"            # normal | zeros | ones
    # stddev scale; None => 1/sqrt(fan_in) with fan_in = shape[-2] (or [-1])
    scale: Optional[float] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


def is_decl(x: Any) -> bool:
    return isinstance(x, ParamDecl)


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested-dict tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _leaf_init(decl: ParamDecl, generator: torch.Generator, dtype,
               device) -> torch.Tensor:
    if decl.init == "zeros":
        return torch.zeros(decl.shape, dtype=dtype, device=device)
    if decl.init == "ones":
        return torch.ones(decl.shape, dtype=dtype, device=device)
    if decl.scale is not None:
        std = decl.scale
    else:
        fan_in = decl.shape[-2] if len(decl.shape) >= 2 else max(decl.shape[-1], 1)
        std = 1.0 / np.sqrt(max(fan_in, 1))
    x = torch.randn(decl.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * std).to(dtype)


def init_tree(decls: Any, *, generator: torch.Generator, dtype,
              device, registry=None, owner: str = "params") -> Any:
    """Materialize a declaration tree on ``device``, drawing every normal
    leaf from ``generator`` (which must live on that device).

    With an `ObjectRegistry` (core/objects.py) every leaf registers as a
    live ``param`` object under ``owner/<path>``; THIS call is the
    allocation site the object tier reports."""
    tree = tree_map(lambda d: _leaf_init(d, generator, dtype, device), decls)
    if registry is not None:
        from repro_torch.core.objects import register_tree
        register_tree(registry, owner, tree, kind="param")
    return tree


def abstract_tree(decls: Any, *, dtype, device, mode) -> Any:
    """Fake tensors matching ``init_tree`` (the same leaves, shapes and
    dtype, on ``device``), made under ``mode``, a fake-tensor mode
    (``core/graph_trace.py:abstract_mode``): no storage, so a tree of any
    width costs no memory. Built from the shapes alone, with no
    generator draw."""
    with mode:
        return tree_map(lambda d: torch.empty(d.shape, dtype=dtype,
                                              device=device), decls)


def axes_tree(decls: Any) -> Any:
    """Logical axes tree matching ``init_tree``'s structure."""
    return tree_map(lambda d: d.axes, decls)


def count_tree(decls: Any) -> int:
    return sum(d.size for d in tree_leaves(decls))


def stack_decls(decls: Any, n: int) -> Any:
    """Declaration tree for ``n`` stacked copies of a block (one leading
    ``layers`` axis, the reference's scanned storage)."""
    return tree_map(lambda d: dataclasses.replace(
        d, shape=(n,) + d.shape, axes=("layers",) + d.axes), decls)


def from_reference(tree: Any, *, device, dtype=None) -> Any:
    """The reference's parameter tree — nested dicts of numpy arrays, as
    ``jax.device_get(LM.init(key))`` gives it — as tensors on ``device``
    (in ``dtype`` when given, else the arrays' own dtype)."""
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":            # ml_dtypes has no torch twin
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        return t.to(device=device, dtype=dtype or t.dtype)
    return tree_map(one, tree)


# ----------------------------------------------------------------------
# Declaration helpers
# ----------------------------------------------------------------------
def linear(d_in: int, d_out: int, in_ax: Optional[str], out_ax: Optional[str],
           init: str = "normal", scale: Optional[float] = None) -> Dict[str, ParamDecl]:
    return {"w": ParamDecl((d_in, d_out), (in_ax, out_ax), init, scale)}


def norm(d: int, ax: Optional[str] = "embed") -> Dict[str, ParamDecl]:
    return {"scale": ParamDecl((d,), (ax,), "ones")}
