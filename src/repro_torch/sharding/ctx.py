"""Activation-sharding context.

Port of src/repro/sharding/ctx.py. Models are written mesh-agnostic and
call ``shard(x, kind)`` at layer boundaries; the active strategy (set by
the step factories in ``repro_torch.serve.decode``) maps each activation
kind to a spec. With no strategy active, ``shard`` is the identity.

The reference constrains a global array and leaves the layout to GSPMD.
Here every rank holds its own tensors and the model code places each
collective explicitly (``sharding/comm.py``), so ``shard`` changes no
value: ``Sharder.spec_for`` says which spec the reference would apply,
under the same divisibility rule (undersized shapes stay replicated).

A Sharder also records the global extents of the cache allocated under
it (``pool_pages``, ``seq_len``, ``cross_len``): a rank's pool holds
only its chunk, so the layers cannot read the global page count off the
tensor they get; and, for serving, the spec tree of the params the
steps run on (``param_specs``, bound by the serving, train and eval
step factories), from which the layers that run a block of a leaf or
take it whole learn which leaves are blocks.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

_SHARDER: contextvars.ContextVar = contextvars.ContextVar("sharder",
                                                          default=None)


class Sharder:
    """Maps activation kinds -> spec under a given mesh."""

    def __init__(self, mesh, act_specs, batch_axes=("data",)):
        self.mesh = mesh
        self.act_specs = dict(act_specs)
        self.batch_axes = tuple(batch_axes)
        # global extents of the cache allocated under this sharder: pool
        # pages of a paged cache, positions of a dense one, the cross K/V
        # positions (frames, image tokens) of a chunked cross cache
        # (None: none)
        self.pool_pages: Optional[int] = None
        self.seq_len: Optional[int] = None
        self.cross_len: Optional[int] = None
        # the spec tree of the params the steps run on
        # (serve.decode.shard_params, the train and eval step factories):
        # which leaves are a rank's blocks, and of which dim (None: not
        # bound, every leaf as given)
        self.param_specs = None
        # whether the steps run each rank's forward on its block of the
        # batch's rows over ``batch_axes`` (the train and eval steps,
        # ``train/step.py:rank_batch``); the serving steps split the
        # slots themselves (models/layers.py ``data_rows``) or run the
        # whole batch on every rank
        self.rank_rows = False

    def _divisible(self, shape, spec) -> bool:
        for dim, names in zip(shape, tuple(spec) + (None,) * len(shape)):
            if names is None:
                continue
            names = names if isinstance(names, tuple) else (names,)
            n = 1
            for a in names:
                n *= self.mesh.shape[a]
            if dim % n:
                return False
        return True

    def spec_for(self, shape, kind: str):
        """The spec the reference's ``constrain`` applies to an array of
        ``shape`` of this kind, or None where it leaves it alone."""
        spec = self.act_specs.get(kind)
        if spec is None:
            return None
        if len(spec) > len(shape) or not self._divisible(shape, spec):
            # never pad implicitly: undersized shapes stay replicated
            return None
        return spec

    def constrain(self, x, kind: str):
        """Rank-local tensors already hold their layout: x unchanged."""
        return x

    def bind_extent(self, attr: str, value: int) -> None:
        """Record a global cache extent; a second cache of another extent
        under the same sharder would make the layers' plans ambiguous."""
        cur = getattr(self, attr)
        if cur is not None and cur != value:
            raise ValueError(f"sharder already holds a cache with {attr} "
                             f"{cur}, not {value}")
        setattr(self, attr, value)


    def bind_params(self, specs, rank_rows: bool = False) -> None:
        """Record the spec tree of the params the steps run on, and
        whether those steps run each rank on its rows (``rank_rows``)."""
        self.param_specs = specs
        self.rank_rows = rank_rows


@contextlib.contextmanager
def sharding_ctx(sharder: Optional[Sharder]):
    tok = _SHARDER.set(sharder)
    try:
        yield
    finally:
        _SHARDER.reset(tok)


def shard(x, kind: str):
    s = _SHARDER.get()
    if s is None:
        return x
    return s.constrain(x, kind)


def current_sharder() -> Optional[Sharder]:
    return _SHARDER.get()
