"""Row RMSNorm, forward and backward: every norm of the model (the two
block norms, qk-norm on each head, the final norm), on the serving path
and through autograd on the training path.

Replaces: src/repro/kernels/rmsnorm.py:rmsnorm (the Pallas kernel
``_rmsnorm_kernel``: f32 mean of squares, ``rsqrt(var + eps)``, times the
f32 scale, cast back). The TPU package has no backward kernel (it trains
through XLA's autodiff of the inline norm); the backward here is the
gradient of the same function. Plain versions: ``ref.rmsnorm_ref`` and
``ref.rmsnorm_bwd_ref`` (and ``ref.rmsnorm_bwd_blocked``, the backward
in the CUDA kernel's row partition and combine order).

CUDA tensors go to the kernels: the forward is the Triton kernel below,
the backward the CUDA C++ kernel of ``csrc/rmsnorm.cu`` (one launch a
call). CPU tensors go to the plain versions. There is no other path: a
tensor on any other device raises.

What bounds them on the H100: bytes. A row is one reduction and one
elementwise pass, far below the card's ridge point. The forward holds
whole rows in registers (``BLOCK_D`` = the row width rounded up to a
power of two, masked), so x is read once and y written once; narrow rows
(qk-norm, 128 wide) go several to a program. Each operand is read in its
own dtype and converted in registers; the math is f32. The forward
writes the f32 ``rstd`` per row only when a backward will need it. The
backward recomputes xhat from x and rstd, writes dx, and sums dscale
over the rows inside the same launch in a fixed order (see
``csrc/rmsnorm.cu``): no float atomics, so the gradient is
deterministic.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build, ref

TILE = 4096            # elements of x a program holds per step
WARPS = 8              # 16 elements of a 4096 tile per thread
MAX_D = 16384          # widest row the kernels take

_KERNEL = None


def _kernel():
    """The forward's ``@triton.jit`` kernel, compiled by Triton at its
    first launch (triton is imported here, not when this module is
    imported)."""
    global _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language as tl

        @triton.jit
        def rmsnorm_fwd_kernel(x_ptr, s_ptr, y_ptr, rstd_ptr, n_rows, d,
                               x_stride, eps, ROWS: tl.constexpr,
                               BLOCK_D: tl.constexpr,
                               WRITE_RSTD: tl.constexpr):
            rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
            cols = tl.arange(0, BLOCK_D)
            rmask = rows < n_rows
            cmask = cols < d
            mask = rmask[:, None] & cmask[None, :]
            rows64 = rows.to(tl.int64)[:, None]
            x = tl.load(x_ptr + rows64 * x_stride + cols[None, :], mask=mask,
                        other=0.0).to(tl.float32)
            var = tl.sum(x * x, axis=1) / d
            rstd = tl.math.rsqrt(var + eps)
            s = tl.load(s_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
            y = x * rstd[:, None] * s[None, :]
            tl.store(y_ptr + rows64 * d + cols[None, :],
                     y.to(y_ptr.dtype.element_ty), mask=mask)
            if WRITE_RSTD:
                tl.store(rstd_ptr + rows, rstd, mask=rmask)

        _KERNEL = rmsnorm_fwd_kernel
    return _KERNEL


def _tiling(d: int) -> Tuple[int, int]:
    """(BLOCK_D, rows per program) for rows of width d."""
    if d > MAX_D:
        raise ValueError(f"rmsnorm kernel: row width {d} > {MAX_D}")
    block_d = 1 << max(0, (d - 1).bit_length())
    return block_d, max(1, TILE // block_d)


def _as_rows(t: torch.Tensor, name: str) -> torch.Tensor:
    """t as (n, d) rows with a unit last-dim stride and one row stride,
    a view where the layout allows it. A layout that no single row
    stride describes is copied here, explicitly."""
    if t.ndim == 0:
        raise ValueError(f"rmsnorm: {name} must have a row dimension")
    d = t.shape[-1]
    if t.stride(-1) == 1 or d == 1:
        try:
            return t.view(-1, d)
        except RuntimeError:     # leading dims not collapsible into one
            pass
    return t.reshape(-1, d).contiguous()


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm runs on CUDA or CPU tensors, not "
                         f"{x.device} and {scale.device}")
    for name, t in (("x", x), ("scale", scale)):
        if t.dtype not in (torch.float32, torch.bfloat16, torch.float16):
            raise TypeError(f"rmsnorm: {name} is {t.dtype}, not a float "
                            f"type the kernel reads")
    if scale.shape != (x.shape[-1],) or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} must be a "
                         f"contiguous ({x.shape[-1]},) vector")


def rmsnorm_forward(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
                    *, want_rstd: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (..., d), read by row stride; scale: (d,). Returns ``(y, rstd)``:
    y in x's shape and dtype, rstd the (n,) f32 per-row reciprocal RMS
    when ``want_rstd`` (else None). No autograd: see ``RMSNorm``."""
    if x.device.type == "cpu":
        y = ref.rmsnorm_ref(x, scale, eps)
        rstd = None
        if want_rstd:
            rstd = torch.rsqrt(x.float().square().mean(dim=-1) + eps)
            rstd = rstd.reshape(-1)
        return y, rstd
    _check(x, scale)
    rows = _as_rows(x, "x")
    n, d = rows.shape
    block_d, per_prog = _tiling(d)
    y = torch.empty((n, d), dtype=x.dtype, device=x.device)
    rstd = (torch.empty(n, dtype=torch.float32, device=x.device)
            if want_rstd else y)          # not written without WRITE_RSTD
    if n:
        with torch.cuda.device(x.device):
            _kernel()[(-(-n // per_prog),)](
                rows, scale, y, rstd, n, d, rows.stride(0), float(eps),
                ROWS=per_prog, BLOCK_D=block_d, WRITE_RSTD=want_rstd,
                num_warps=WARPS)
        rmsnorm_forward.launches += 1
    return y.view(x.shape), (rstd if want_rstd else None)


# ----------------------------------------------------------------------
# Backward: csrc/rmsnorm.cu
# ----------------------------------------------------------------------
ROUTES = {"general": 0, "narrow": 1, "wide": 2}   # the C side's codes
NARROW_WARPS = 16      # row workers (warps) of a narrow-route block
NARROW_D = 128         # widest narrow row (4 elements a lane)
WIDE_MAX_D = 4096      # widest wide row (8 elements a thread, 512 threads)
# persistent blocks an SM, capped at what stays resident (one narrow
# block of 16 warps fills an SM's shared memory): the fastest at the
# three training norms in chip_smoke's sweep (PERF.md)
BLOCKS_PER_SM = 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SIGNATURES = {"rmsnorm_bwd": [build.PTR] * 8
               + [ctypes.c_int64, build.INT, ctypes.c_int64,
                  ctypes.c_int64] + [build.INT] * 5 + [build.PTR],
               "rmsnorm_bwd_resident": [build.INT] * 3 + [build.PTR]}


class BwdPlan(NamedTuple):
    """How the backward kernel cuts a call: its route, ``blocks``
    persistent blocks of ``workers`` row workers each (contiguous row
    ranges, balanced); dscale sums the block partials in groups of
    ``group`` consecutive blocks, then the groups."""
    route: str
    blocks: int
    workers: int
    group: int


def bwd_plan(n: int, d: int, itemsize: int, addresses, sms: int,
             blocks_per_sm: Optional[int] = None) -> BwdPlan:
    """The backward's plan for n rows of width d whose operands start at
    byte ``addresses`` (the x and dy base pointers and row strides in
    bytes): the narrow route for rows of at most 128 elements, a multiple
    of 4, aligned to 4 elements; the wide route for 128 < d <= 4096, a
    multiple of 8, 16-byte aligned; the general route otherwise.
    ``blocks_per_sm`` overrides ``BLOCKS_PER_SM`` (the timing sweep)."""
    def aligned(b):
        return all(a % b == 0 for a in addresses) and (d * itemsize) % b == 0
    if d <= NARROW_D and d % 4 == 0 and aligned(4 * itemsize):
        route, workers = "narrow", NARROW_WARPS
        units = -(-n // (4 * NARROW_WARPS))   # 4 rows a warp at least
    elif NARROW_D < d <= WIDE_MAX_D and d % 8 == 0 and aligned(16):
        route, workers, units = "wide", 1, n
    else:
        route, workers, units = "general", 1, n
    k = blocks_per_sm or BLOCKS_PER_SM
    blocks = max(1, min(units, k * sms))
    return BwdPlan(route, blocks, workers, math.isqrt(blocks - 1) + 1)


# (device, stream) -> (partials, ticket): the backward's workspace, kept
# across calls; the ticket (arrivals, generation) is zeroed when
# allocated, and every launch leaves the arrivals at zero
_WORKSPACE: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
_SMS: Dict[int, int] = {}
# (device, route, width, dtype) -> blocks of the route resident on an SM
_RESIDENT: Dict[tuple, int] = {}


def _workspace(device, stream: int, floats: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream)
    part, tick = _WORKSPACE.get(key, (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty(floats, dtype=torch.float32, device=device)
    if tick is None:
        tick = torch.zeros(2, dtype=torch.int32, device=device)
    _WORKSPACE[key] = (part, tick)
    return part, tick


def plan_for(rows: torch.Tensor, dy_rows: torch.Tensor,
             blocks_per_sm: Optional[int] = None) -> BwdPlan:
    """``bwd_plan`` of a call on CUDA rows of x and dy, its blocks an SM
    capped at what the route keeps resident (the launch is
    cooperative)."""
    n, d = rows.shape
    isz = rows.element_size()
    dev = rows.device.index
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(
            rows.device).multi_processor_count
    addresses = (rows.data_ptr(), dy_rows.data_ptr(), rows.stride(0) * isz,
                 dy_rows.stride(0) * isz)
    plan = bwd_plan(n, d, isz, addresses, _SMS[dev], blocks_per_sm)
    key = (dev, plan.route, d, rows.dtype)
    if key not in _RESIDENT:
        out = ctypes.c_int(0)
        with torch.cuda.device(rows.device):
            build.launched(_lib().rmsnorm_bwd_resident(
                ROUTES[plan.route], d, _DTYPES[rows.dtype],
                ctypes.byref(out)), "rmsnorm backward occupancy")
        _RESIDENT[key] = max(1, out.value)
    cap = _RESIDENT[key]
    if plan.blocks > cap * _SMS[dev]:
        plan = bwd_plan(n, d, isz, addresses, _SMS[dev], cap)
    return plan


def _lib():
    return build.load("rmsnorm", _SIGNATURES)


def rmsnorm_backward(x: torch.Tensor, scale: torch.Tensor,
                     rstd: Optional[torch.Tensor], dy: torch.Tensor,
                     eps: float = 1e-5, *,
                     blocks_per_sm: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients ``(dx, dscale)`` of ``rmsnorm_forward``'s y against
    ``dy`` (x's shape and dtype), from x and the forward's rstd: dx in
    x's dtype, dscale in scale's dtype, summed over the rows in f32, in
    one launch of the CUDA kernel. On CPU tensors the plain version,
    which recomputes rstd."""
    if x.device.type == "cpu":
        return ref.rmsnorm_bwd_ref(x, scale, dy, eps)
    _check(x, scale)
    rows = _as_rows(x, "x")
    n, d = rows.shape
    dy_rows = _as_rows(dy, "dy")
    if (dy_rows.shape != rows.shape or rstd is None
            or rstd.shape != (n,) or rstd.dtype != torch.float32
            or not rstd.is_contiguous() or dy.device != x.device
            or dy.dtype != x.dtype):
        raise ValueError("rmsnorm backward: dy must be x-shaped on x's "
                         "device in x's dtype, rstd the forward's (n,) "
                         "f32 rows")
    if d > MAX_D:
        raise ValueError(f"rmsnorm kernel: row width {d} > {MAX_D}")
    dx = torch.empty((n, d), dtype=x.dtype, device=x.device)
    ds = torch.empty(d, dtype=scale.dtype, device=x.device)
    if not n:
        return dx.view(x.shape), ds.zero_()
    plan = plan_for(rows, dy_rows, blocks_per_sm)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        part, tick = _workspace(x.device, stream, plan.blocks * d)
        build.launched(_lib().rmsnorm_bwd(
            rows.data_ptr(), scale.data_ptr(), dy_rows.data_ptr(),
            rstd.data_ptr(), dx.data_ptr(), ds.data_ptr(), part.data_ptr(),
            tick.data_ptr(), n, d, rows.stride(0), dy_rows.stride(0),
            ROUTES[plan.route], plan.blocks, plan.group, _DTYPES[x.dtype],
            _DTYPES[scale.dtype], stream), "rmsnorm backward")
    rmsnorm_backward.launches += 1
    return dx.view(x.shape), ds


# kernel launches since the count was last set to 0 (CPU calls not counted)
rmsnorm_forward.launches = 0
rmsnorm_backward.launches = 0


class RMSNorm(torch.autograd.Function):
    """y = rmsnorm(x, scale); saves x and the forward's f32 rstd (and the
    scale parameter itself) for the backward, no f32 copies of x."""

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        y, rstd = rmsnorm_forward(x, scale, eps, want_rstd=True)
        ctx.save_for_backward(x, scale, rstd)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, rstd = ctx.saved_tensors
        dx, dscale = rmsnorm_backward(x, scale, rstd, dy, ctx.eps)
        return dx, dscale, None
