"""Atomic, async-capable checkpointing.

Port of src/repro/checkpoint/checkpointer.py, in its layout: ``<dir>/
step_<N>/`` holds one ``.npy`` per leaf of the tree and an
``index.json`` with each leaf's key path, shape and dtype and the step.
A leaf's key is the string ``jax.tree_util.keystr`` gives the same leaf
of the reference's tree (``.params['embed']``, ``.step``: a NamedTuple
field is ``.name``, a dict key ``['key']``, a sequence index ``[i]``), so
a checkpoint written by either package restores in the other. bfloat16
leaves are stored widened to float32 (lossless) with the true dtype
recorded.

Writes land in ``step_<N>.tmp`` and are renamed atomically, so a crash
mid-write never corrupts the latest checkpoint; ``save_async`` copies the
tree to the host before it returns (the train step updates the state in
place) and writes on a background thread. ``keep`` bounds the steps kept.

Restore is mesh-agnostic: leaves are read whole and placed on the
template's device and dtype, or, given a spec tree and a mesh, cut to
the rank's slice (``sharding.rules.local_slice``: the elastic-restart
path, checkpoint/elastic.py).
"""
from __future__ import annotations

import json
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree, is_leaf=None, prefix: str = "") -> Dict[str, Any]:
    """key path -> leaf, keys as ``jax.tree_util.keystr`` spells them."""
    if is_leaf is not None and is_leaf(tree):
        return {prefix: tree}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], is_leaf, f"{prefix}[{k!r}]"))
        return out
    if _is_namedtuple(tree):
        out = {}
        for name in tree._fields:
            out.update(flatten(getattr(tree, name), is_leaf,
                               f"{prefix}.{name}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, is_leaf, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def _rebuild(template, fn, prefix: str = ""):
    """``template``'s structure with each leaf replaced by fn(key, leaf)."""
    if isinstance(template, dict):
        return {k: _rebuild(v, fn, f"{prefix}[{k!r}]")
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(
            _rebuild(getattr(template, n), fn, f"{prefix}.{n}")
            for n in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, fn, f"{prefix}[{i}]")
                              for i, v in enumerate(template))
    return fn(prefix, template)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def _to_host(x) -> np.ndarray:
    """A leaf as a host numpy array of its own (never a view of memory
    the caller may write next); bf16 widened to float32."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(x)


def _sanitize(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any) -> Path:
        self.wait()
        return self._save_sync(step, self._snapshot(tree))

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        host = self._snapshot(tree)          # copied before returning
        self._thread = threading.Thread(
            target=self._save_sync, args=(step, host), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @staticmethod
    def _snapshot(tree) -> Dict[str, Any]:
        """key -> (host array, true dtype name)."""
        return {k: (_to_host(v), _dtype_name(v))
                for k, v in flatten(tree).items()}

    def _save_sync(self, step: int, host: Dict[str, Any]) -> Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        index: Dict[str, Any] = {"step": step, "leaves": {}}
        for key, (arr, true_dtype) in host.items():
            fname = _sanitize(key) + ".npy"
            np.save(tmp / fname, arr)
            index["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                    "dtype": true_dtype}
        (tmp / "index.json").write_text(json.dumps(index))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                      # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "index.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                specs: Any = None, mesh=None, device=None) -> Any:
        """Restore into the structure of ``template``, whose leaves give
        each leaf's full shape, dtype and (unless ``device`` is given)
        device: tensors, fake tensors, or numpy arrays (read back as
        numpy). With a matching ``specs`` tree (sharding/rules.py ``PS``
        leaves) and a ``mesh``, each leaf comes back as the slice the
        mesh's rank holds (elastic: any mesh, not only the one that wrote
        the checkpoint)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step:08d}"
        index = json.loads((path / "index.json").read_text())
        spec_map = None
        if specs is not None:
            from repro_torch.sharding.rules import PS, local_slice
            spec_map = flatten(specs, is_leaf=lambda x: isinstance(x, PS))

        def one(key, tmpl):
            meta = index["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = np.load(path / meta["file"])
            if list(arr.shape) != list(tmpl.shape):
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {arr.shape} vs "
                    f"template {tuple(tmpl.shape)}")
            if spec_map is not None:
                # np.array, not ascontiguousarray: that makes a 0-d leaf
                # (the step) 1-d
                arr = np.array(local_slice(arr, spec_map[key], mesh),
                               order="C")
            if not isinstance(tmpl, torch.Tensor):
                return arr.astype(np.asarray(tmpl).dtype)
            dev = device if device is not None else tmpl.device
            return torch.from_numpy(arr).to(device=dev, dtype=tmpl.dtype)
        return _rebuild(template, one)
