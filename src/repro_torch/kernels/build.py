"""Builds the hand-written CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, loaded with
``ctypes``. Libraries land in ``build/repro_torch_kernels/`` at the root
of the checkout, named by a digest of the sources and flags, so a
changed source is rebuilt and an unchanged one is loaded as it is.
Nothing is compiled when this module is imported; a missing ``nvcc`` or
a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("paged_decode", "paged_window", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> loaded library (a process-wide cache of what dlopen holds anyway)
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: the name carries a
    digest of the source, the shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the libraries of ``names`` that are not built yet, one nvcc
    process per source, all started together. Returns each compiled
    source's ``ptxas`` report (registers, shared memory, spills)."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [compiler, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            os.unlink(tmp)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed, with
    ``argtypes`` set from ``signatures`` (C function -> argument types);
    every C function returns an int status."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


# ----------------------------------------------------------------------
# Binding helpers shared by the kernel wrappers
# ----------------------------------------------------------------------
PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float


def dtype_code(t) -> int:
    """The C side's element-type code: 0 = float32, 1 = bfloat16."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, "
                        f"not {t.dtype}")
    return codes[t.dtype]


def check_paged(what: str, q, k, v, pool_k, pool_v, pt, idx) -> None:
    """The paged kernels' operands: q (B, S, Hq, D) and k/v (B, S, Hkv,
    D) in one float type, pools (P, page, Hkv, D) in one float type, pt
    (B, M) and idx (B,) int32 — all contiguous, on q's CUDA device; D a
    multiple of 8 up to 32, or 64 or 128; the float operands 16-byte
    aligned (the kernels read them by 16-byte copies)."""
    B, S, Hq, D = q.shape
    Hkv = pool_k.shape[2]
    if (k.shape != (B, S, Hkv, D) or v.shape != k.shape
            or pool_k.ndim != 4 or pool_v.shape != pool_k.shape
            or pool_k.shape[3] != D or Hq % Hkv or pt.ndim != 2
            or pt.shape[0] != B or idx.shape != (B,)):
        raise ValueError(
            f"{what} shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, pools {tuple(pool_k.shape)}/"
            f"{tuple(pool_v.shape)}, pt {tuple(pt.shape)}, idx "
            f"{tuple(idx.shape)}")
    if D % 8 or not (D <= 32 or D in (64, 128)):
        raise ValueError(f"{what}: head_dim {D} is not a multiple of 8 up "
                         f"to 32, or 64 or 128")
    if pt.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError(f"{what}: pt and idx must be int32")
    if k.dtype != q.dtype or v.dtype != q.dtype or pool_v.dtype != pool_k.dtype:
        raise TypeError(f"{what}: q/k/v share one dtype, the pools another")
    for t in (q, pool_k):
        dtype_code(t)                   # float32 or bfloat16, else TypeError
    for name, t in (("q", q), ("k", k), ("v", v), ("pool_k", pool_k),
                    ("pool_v", pool_v), ("pt", pt), ("idx", idx)):
        if t.device != q.device or q.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}, the kernel "
                             f"runs on the CUDA device {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.is_floating_point() and t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


# (C function, sizes) -> (ticket ints, partial floats)
_WORKSPACE: Dict[tuple, Tuple[int, int]] = {}


def workspace(lib: ctypes.CDLL, fn: str, device, B: int,
              *sizes: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """What a paged kernel's launch needs beside its operands, as the C
    function ``fn`` of ``lib`` reports it for ``(B, *sizes)`` (asked once
    per shape): one zeroed int32 buffer holding the (B, 3) store counters
    and then the split route's tickets, and the split partials' float
    buffer (None when the route has none), both from torch's caching
    allocator."""
    key = (fn, B) + sizes
    need = _WORKSPACE.get(key)
    if need is None:
        out = (ctypes.c_int64 * 2)()
        launched(getattr(lib, fn)(B, *sizes, out), fn)
        need = _WORKSPACE[key] = (int(out[0]), int(out[1]))
    ints = torch.zeros(3 * B + need[0], dtype=torch.int32, device=device)
    part = (torch.empty(need[1], dtype=torch.float32, device=device)
            if need[1] else None)
    return ints, part


def launched(rc: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
