"""Silent compare: the count of elements where ``b`` is a silent overwrite
of ``a``, |a - b| <= tol * max(|a|, |b|) (exact equality at tol 0), NaN
never silent — the value comparison of the tier-3 training detectors
(paper Defs. 2-3).

Replaces: src/repro/kernels/silent_compare.py:silent_compare (the Pallas
kernel ``_silent_kernel``). Plain version: ``ref.silent_compare_ref``.

CUDA tensors go to the Triton kernel below; CPU tensors go to the plain
version. There is no other path: a tensor on any other device raises.

What bounds it on the H100: bytes, 2 reads per element and one
comparison (a parameter leaf of 152064 x 2048 bf16 is 1.25 GB read). The
kernel reads both operands in their own dtype and converts in registers
(no f32 copies and no NaN padding, which the Pallas version makes), masks
the ragged tail, and keeps one int32 count per lane; each program writes
one int64 partial and one small sum adds them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

BLOCK = 4096           # elements per tile (16 per thread at 8 warps)
PROGRAMS_PER_SM = 4    # grid-stride programs: enough to fill the card

_KERNEL = None


def _kernel():
    """The ``@triton.jit`` kernel, compiled by Triton at its first launch
    (triton is imported here, not when this module is imported)."""
    global _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language as tl

        @triton.jit
        def silent_count_kernel(a_ptr, b_ptr, part_ptr, n, num_tiles, tol,
                                EXACT: tl.constexpr, BLOCK: tl.constexpr):
            pid = tl.program_id(0)
            lanes = tl.arange(0, BLOCK)
            acc = tl.zeros([BLOCK], dtype=tl.int32)
            for t in range(pid, num_tiles, tl.num_programs(0)):
                offs = t.to(tl.int64) * BLOCK + lanes
                inside = offs < n
                a = tl.load(a_ptr + offs, mask=inside, other=0.0).to(tl.float32)
                b = tl.load(b_ptr + offs, mask=inside, other=0.0).to(tl.float32)
                if EXACT:
                    eq = a == b
                else:
                    eq = tl.abs(a - b) <= tol * tl.maximum(tl.abs(a), tl.abs(b))
                # NaN compares unequal to itself: never silent
                eq = eq & (a == a) & (b == b) & inside
                acc += eq.to(tl.int32)
            tl.store(part_ptr + pid, tl.sum(acc.to(tl.int64), axis=0))

        _KERNEL = silent_count_kernel
    return _KERNEL


def silent_compare(a: torch.Tensor, b: torch.Tensor,
                   tol: float = 0.01) -> torch.Tensor:
    """Count silent elements between ``a`` and ``b`` (same shape, any
    float dtypes, compared in f32). Returns a 0-d int32 tensor on their
    device, as the reference returns an int32 count."""
    if a.shape != b.shape:
        raise ValueError(f"silent_compare: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ref.silent_compare_ref(a, b, tol)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"silent_compare runs on CUDA or CPU tensors, not "
                         f"{a.device} and {b.device}")
    for t in (a, b):
        if not t.dtype.is_floating_point:
            raise TypeError(f"silent_compare takes float tensors, not "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError("silent_compare: operands must be contiguous")
    n = a.numel()
    if n >= 2 ** 31:
        raise ValueError(f"silent_compare: {n} elements overflow the "
                         f"int32 count")
    num_tiles = -(-n // BLOCK)
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    grid = max(1, min(num_tiles, PROGRAMS_PER_SM * sms))
    part = torch.empty(grid, dtype=torch.int64, device=a.device)
    with torch.cuda.device(a.device):
        _kernel()[(grid,)](a, b, part, n, num_tiles, float(tol),
                           EXACT=tol == 0.0, BLOCK=BLOCK, num_warps=8)
    silent_compare.launches += 1
    return part.sum().to(torch.int32)


# kernel launches since the count was last set to 0 (CPU calls not counted)
silent_compare.launches = 0
