"""Row RMSNorm, forward and backward: every norm of the model (the two
block norms, qk-norm on each head, the final norm, the Mamba2 gate
norm), on the serving path and through autograd on the training path.

Replaces: src/repro/kernels/rmsnorm.py:rmsnorm (the Pallas kernel
``_rmsnorm_kernel``: f32 mean of squares, ``rsqrt(var + eps)``, times the
f32 scale, cast back). The TPU package has no backward kernel (it trains
through XLA's autodiff of the inline norm); the backward here is the
gradient of the same function. Plain versions: ``ref.rmsnorm_ref`` and
``ref.rmsnorm_bwd_ref`` (and ``ref.rmsnorm_bwd_blocked``, the backward
in the CUDA kernel's row partition and combine order).

CUDA tensors go to the CUDA C++ kernels of ``csrc/rmsnorm.cu``, one
launch a call each way; CPU tensors go to the plain versions. There is
no other path: a tensor on any other device raises.

What bounds them on the H100: bytes, and on the serving paths' decode
rows the launch. Both directions share one route function
(``row_route``: narrow rows of at most 128, wide rows up to 8192, a
general route for any other width or alignment: rows past 8192 up to
16384, widths that are not a multiple of 8, misaligned rows); each
operand is read in its own dtype and converted in registers, the math is
f32. The forward writes the f32 ``rstd`` per row only when a backward
will need it. The backward recomputes xhat from x and rstd, writes dx,
and sums dscale over the rows inside the same launch in a fixed order:
no float atomics, so the gradient is deterministic.

The host's part of a call is kept small, since a decode tick makes 65 to
113 of them: a call's plan (route, grid) is looked up in a dict keyed by
what decides it (device, shapes, dtypes, row strides, pointer alignment)
and computed only on a miss, the launch is one ctypes call on the
current stream's raw handle, and no device context is entered when the
tensors are on the current device.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build, ref

MAX_D = 16384          # widest row the kernels take
ROUTES = {"general": 0, "narrow": 1, "wide": 2}   # the C side's codes
NARROW_D = 128         # widest narrow row
WIDE_MAX_D = 8192      # widest wide row
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SIGNATURES = {
    "rmsnorm_fwd": [build.PTR] * 4 + [ctypes.c_int64, ctypes.c_int64,
                                      build.FLOAT, ctypes.c_int64,
                                      build.PTR],
    "rmsnorm_bwd": [build.PTR] * 8 + [ctypes.c_int64] * 4 + [build.PTR],
    "rmsnorm_bwd_resident": [build.INT] * 3 + [build.PTR],
    "launch_floor": [build.INT] * 2 + [build.PTR]}


def _aligned(d: int, itemsize: int, addresses, b: int) -> bool:
    return all(a % b == 0 for a in addresses) and (d * itemsize) % b == 0


def row_route(d: int, itemsize: int, addresses) -> str:
    """The route of rows of width d whose operands start at byte
    ``addresses`` (base pointers and row strides in bytes), for either
    direction: ``narrow`` for rows of at most 128 elements, a multiple of
    4, aligned to 4 elements; ``wide`` for 128 < d <= 8192, a multiple of
    8, 16-byte aligned; ``general`` otherwise."""
    if d <= NARROW_D and d % 4 == 0 and _aligned(d, itemsize, addresses,
                                                 4 * itemsize):
        return "narrow"
    if NARROW_D < d <= WIDE_MAX_D and d % 8 == 0 and _aligned(
            d, itemsize, addresses, 16):
        return "wide"
    return "general"


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


def _rows(t: torch.Tensor, name: str):
    """(the tensor whose memory the kernel reads, n, d, row stride): t
    itself when contiguous (no view made), else ``_as_rows(t)``."""
    if t.ndim and t.is_contiguous():
        d = t.shape[-1]
        return t, (t.numel() // d if d else 0), d, d
    r = _as_rows(t, name)
    return r, r.shape[0], r.shape[1], r.stride(0)


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm runs on CUDA or CPU tensors, not "
                         f"{x.device} and {scale.device}")
    for name, t in (("x", x), ("scale", scale)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"rmsnorm: {name} is {t.dtype}, not a float "
                            f"type the kernel reads")
    if scale.shape != (x.shape[-1],) or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} must be a "
                         f"contiguous ({x.shape[-1]},) vector")


# ----------------------------------------------------------------------
# The host's part of a call
# ----------------------------------------------------------------------
# what decides a call's plan (tensors' devices, dtypes, shapes, row
# strides and pointer alignment) -> the plan packed into the one integer
# the C entry takes; every key's tensors were checked when it was made.
# Cleared when it outgrows _PLANS_MAX.
_PLANS: Dict[tuple, int] = {}
_PLANS_MAX = 4096
_SMS: Dict[int, int] = {}
# the C entries and torch's raw device and stream getters, bound by
# _bind() at the first CUDA call (this module imports without CUDA)
_FWD = _BWD = _CUR_DEVICE = _RAW_STREAM = None


def _bind() -> None:
    global _FWD, _BWD, _CUR_DEVICE, _RAW_STREAM
    lib = _lib()
    _FWD, _BWD = lib.rmsnorm_fwd, lib.rmsnorm_bwd
    _CUR_DEVICE = torch._C._cuda_getDevice
    _RAW_STREAM = torch._C._cuda_getCurrentRawStream


def _remember(key: tuple, word: int) -> int:
    if len(_PLANS) >= _PLANS_MAX:
        _PLANS.clear()
    _PLANS[key] = word
    return word


def _sms(dev: int) -> int:
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev]


def _lib():
    return build.load("rmsnorm", _SIGNATURES)


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------
# rows a block by route: inside the flat optimum of chip_smoke's sweep
# at the main path's prefill and training shapes (PERF.md: 8-32 narrow
# rows, 1-8 wide rows time within 3%); fewer when the blocks would not
# cover the SMs
FWD_ROWS = {"narrow": 16, "wide": 2, "general": 1}
FWD_NARROW_WARPS = 4   # most warps of a narrow block
FWD_WIDE_WARP_D = 2048  # widest row one warp holds (64 values a lane)


def wide_lanes(d: int) -> int:
    """Lanes of a wide forward row: the fewest warps, a power of two,
    that hold d at 64 values a lane (``csrc/rmsnorm.cu``: wide_lanes)."""
    lanes = 32
    while lanes * (FWD_WIDE_WARP_D // 32) < d:
        lanes *= 2
    return lanes


GENERAL_THREADS = 256


class FwdPlan(NamedTuple):
    """How the forward kernel cuts a call: its route, ``blocks`` blocks
    of ``threads`` threads, each taking ``rows`` consecutive rows with
    ``lanes`` lanes a row."""
    route: str
    rows: int
    blocks: int
    threads: int
    lanes: int

    def word(self, d: int, x_dtype, s_dtype) -> int:
        """The plan as the C entry takes it: width, route, dtypes and
        the block's shape packed into one integer (``csrc/rmsnorm.cu``:
        unpack_fwd)."""
        return (d | ROUTES[self.route] << 16 | _DTYPES[x_dtype] << 18
                | _DTYPES[s_dtype] << 20 | self.lanes << 22
                | self.threads << 31 | self.rows << 40)


def fwd_plan(n: int, d: int, itemsize: int, addresses, sms: int,
             rows: Optional[int] = None) -> FwdPlan:
    """The forward's plan for n rows of width d: ``row_route`` of the x
    and scale pointers and x's row stride. Rows a block: ``rows`` (the
    timing sweep) or ``FWD_ROWS``, lowered to the power of two that
    still gives every SM a block when n is small (decode rows spread
    over the SMs), taken to a power of two the route's block holds. A
    narrow row takes 32 lanes of 4 elements, or 16 lanes of 8 (one
    16-byte load) when its 16-bit rows are 16-byte aligned, and a block
    up to ``FWD_NARROW_WARPS`` warps of 1, 2 or 4 steps of rows; a
    wide row takes ``wide_lanes``: a warp (d <= 2048), two (<= 4096) or
    four, at most 256 threads a block; a general block one row of 256
    lanes."""
    if d > MAX_D:
        raise ValueError(f"rmsnorm kernel: row width {d} > {MAX_D}")
    route = row_route(d, itemsize, addresses)
    if route == "general":
        return FwdPlan(route, 1, max(n, 1), GENERAL_THREADS,
                       GENERAL_THREADS)
    if rows is None:
        rows = FWD_ROWS[route]
        need = -(-n // sms)          # rows a block that still fill the SMs
        if need < rows:
            rows = 1 << max(0, (need - 1).bit_length())
    rows = 1 << (max(1, rows).bit_length() - 1)
    if route == "narrow":
        lanes = 16 if itemsize == 2 and _aligned(d, itemsize, addresses,
                                                 16) else 32
        step = 32 // lanes                     # rows a warp a step
        rows = min(max(rows, step), 4 * step * FWD_NARROW_WARPS)
        threads = 32 * min(rows // step, FWD_NARROW_WARPS)
    else:
        lanes = wide_lanes(d)
        rows = min(rows, 256 // lanes)
        threads = lanes * rows
    return FwdPlan(route, rows, max(1, -(-n // rows)), threads, lanes)


def fwd_plan_for(x: torch.Tensor, scale: torch.Tensor,
                 rows: Optional[int] = None) -> FwdPlan:
    """``fwd_plan`` of a call on CUDA x and scale (checked here)."""
    _check(x, scale)
    t, n, d, xs = _rows(x, "x")
    isz = x.element_size()
    return fwd_plan(n, d, isz, (t.data_ptr(), xs * isz, scale.data_ptr()),
                    _sms(x.get_device()), rows)


def rmsnorm_forward(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
                    *, want_rstd: bool = False, rows: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (..., d), read by row stride; scale: (d,). Returns ``(y, rstd)``:
    y in x's shape and dtype, rstd the (n,) f32 per-row reciprocal RMS
    when ``want_rstd`` (else None). ``rows``: rows a block in place of
    ``fwd_plan``'s choice (the timing sweep; the bits do not change). No
    autograd: see ``RMSNorm``."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            y = ref.rmsnorm_ref(x, scale, eps)
            rstd = None
            if want_rstd:
                rstd = torch.rsqrt(x.float().square().mean(dim=-1) + eps)
                rstd = rstd.reshape(-1)
            return y, rstd
        _check(x, scale)                    # raises: no path for it
    t, n, d, xs = _rows(x, "x")
    sp = scale.data_ptr()
    key = (t.data_ptr() & 15, sp & 15, n, d, xs, x.get_device(),
           scale.get_device(), x.dtype, scale.dtype, scale.shape,
           scale.is_contiguous(), rows)
    word = _PLANS.get(key)
    if word is None:
        word = _remember(key, fwd_plan_for(x, scale, rows).word(
            d, x.dtype, scale.dtype))
        _bind()
    # empty_like of a contiguous x is contiguous, and cheaper to ask for
    # than new_empty(shape)
    y = torch.empty_like(x) if t is x else x.new_empty(x.shape)
    rstd = x.new_empty(n, dtype=torch.float32) if want_rstd else None
    if n:
        dev = x.get_device()
        args = (t.data_ptr(), sp, y.data_ptr(),
                rstd.data_ptr() if want_rstd else None, n, xs, eps, word,
                _RAW_STREAM(dev))
        if dev == _CUR_DEVICE():
            rc = _FWD(*args)
        else:
            with torch.cuda.device(dev):
                rc = _FWD(*args)
        if rc:
            build.launched(rc, "rmsnorm forward")
        rmsnorm_forward.launches += 1
    return y, rstd


# ----------------------------------------------------------------------
# Backward
# ----------------------------------------------------------------------
NARROW_WARPS = 16      # row workers (warps) of a narrow-route block
# persistent blocks an SM, capped at what stays resident (one narrow
# block of 16 warps fills an SM's shared memory): the fastest at the
# three training norms in chip_smoke's sweep (PERF.md)
BLOCKS_PER_SM = 2


class BwdPlan(NamedTuple):
    """How the backward kernel cuts a call: its route, ``blocks``
    persistent blocks of ``workers`` row workers each (contiguous row
    ranges, balanced); dscale sums the block partials in groups of
    ``group`` consecutive blocks, then the groups."""
    route: str
    blocks: int
    workers: int
    group: int

    def word(self, d: int, x_dtype, s_dtype) -> int:
        """The plan as the C entry takes it: width, route, dtypes, group
        and grid packed into one integer."""
        return (d | ROUTES[self.route] << 16 | _DTYPES[x_dtype] << 18
                | _DTYPES[s_dtype] << 20 | self.group << 22
                | self.blocks << 34)


def bwd_plan(n: int, d: int, itemsize: int, addresses, sms: int,
             blocks_per_sm: Optional[int] = None) -> BwdPlan:
    """The backward's plan for n rows of width d whose operands start at
    byte ``addresses`` (the x and dy base pointers and row strides in
    bytes): ``row_route``'s route (a wide row is a block of d / 8
    threads up to 4096, d / 16 above), a persistent grid of
    ``blocks_per_sm`` (default ``BLOCKS_PER_SM``; the timing sweep)
    blocks an SM, fewer when the rows run out."""
    route = row_route(d, itemsize, addresses)
    if route == "narrow":
        workers = NARROW_WARPS
        units = -(-n // (4 * NARROW_WARPS))   # 4 rows a warp at least
    else:
        workers, units = 1, n
    k = blocks_per_sm or BLOCKS_PER_SM
    blocks = max(1, min(units, k * sms))
    return BwdPlan(route, blocks, workers, math.isqrt(blocks - 1) + 1)


# (device, stream) -> (partials, ticket): the backward's workspace, kept
# across calls; the ticket (arrivals, generation) is zeroed when
# allocated, and every launch leaves the arrivals at zero
_WORKSPACE: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
# (device, route, width, dtype) -> blocks of the route resident on an SM
_RESIDENT: Dict[tuple, int] = {}


def _workspace(dev: int, stream: int, floats: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (dev, stream)
    part, tick = _WORKSPACE.get(key, (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty(floats, dtype=torch.float32, device=dev)
        if tick is None:
            tick = torch.zeros(2, dtype=torch.int32, device=dev)
        _WORKSPACE[key] = (part, tick)
    return part, tick


def plan_for(rows: torch.Tensor, dy_rows: torch.Tensor,
             blocks_per_sm: Optional[int] = None) -> BwdPlan:
    """``bwd_plan`` of a call on CUDA rows of x and dy, its blocks an SM
    capped at what the route keeps resident (the launch is
    cooperative)."""
    rows, n, d, xs = _rows(rows, "x")
    dy_rows, _, _, dys = _rows(dy_rows, "dy")
    isz = rows.element_size()
    dev = rows.get_device()
    addresses = (rows.data_ptr(), dy_rows.data_ptr(), xs * isz, dys * isz)
    plan = bwd_plan(n, d, isz, addresses, _sms(dev), blocks_per_sm)
    key = (dev, plan.route, d, rows.dtype)
    if key not in _RESIDENT:
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            build.launched(_lib().rmsnorm_bwd_resident(
                ROUTES[plan.route], d, _DTYPES[rows.dtype],
                ctypes.byref(out)), "rmsnorm backward occupancy")
        _RESIDENT[key] = max(1, out.value)
    cap = _RESIDENT[key]
    if plan.blocks > cap * _sms(dev):
        plan = bwd_plan(n, d, isz, addresses, _sms(dev), cap)
    return plan


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
    if not x.is_cuda:
        if x.device.type == "cpu":
            return ref.rmsnorm_bwd_ref(x, scale, dy, eps)
        _check(x, scale)                    # raises: no path for it
    if rstd is None:
        raise ValueError("rmsnorm backward: rstd is the forward's (n,) "
                         "f32 rows")
    t, n, d, xs = _rows(x, "x")
    dt, dn, dd, dys = _rows(dy, "dy")
    xp, dp = t.data_ptr(), dt.data_ptr()
    dev = x.get_device()
    key = (xp & 15, dp & 15, n, d, dn, dd, xs, dys, dev, scale.get_device(),
           dy.get_device(), rstd.get_device(), x.dtype, scale.dtype,
           dy.dtype, rstd.dtype, scale.shape, scale.is_contiguous(),
           rstd.shape, rstd.is_contiguous(), blocks_per_sm)
    word = _PLANS.get(key)
    if word is None:
        _check(x, scale)
        if ((dn, dd) != (n, d) or rstd.shape != (n,)
                or rstd.dtype != torch.float32 or not rstd.is_contiguous()
                or dy.device != x.device or rstd.device != x.device
                or dy.dtype != x.dtype):
            raise ValueError("rmsnorm backward: dy must be x-shaped on x's "
                             "device in x's dtype, rstd the forward's (n,) "
                             "f32 rows")
        if d > MAX_D:
            raise ValueError(f"rmsnorm kernel: row width {d} > {MAX_D}")
        plan = plan_for(t, dt, blocks_per_sm) if n else BwdPlan(
            "general", 1, 1, 1)
        word = _remember(key, plan.word(d, x.dtype, scale.dtype))
        _bind()
    dx = torch.empty_like(x) if t is x else x.new_empty(x.shape)
    ds = torch.empty_like(scale)            # checked contiguous (d,)
    if not n:
        return dx, ds.zero_()
    stream = _RAW_STREAM(dev)
    part, tick = _workspace(dev, stream, (word >> 34) * d)
    args = (xp, scale.data_ptr(), dp, rstd.data_ptr(), dx.data_ptr(),
            ds.data_ptr(), part.data_ptr(), tick.data_ptr(), n, xs, dys,
            word, stream)
    if dev == _CUR_DEVICE():
        rc = _BWD(*args)
    else:
        with torch.cuda.device(dev):
            rc = _BWD(*args)
    if rc:
        build.launched(rc, "rmsnorm backward")
    rmsnorm_backward.launches += 1
    return dx, ds


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
