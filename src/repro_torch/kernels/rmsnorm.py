"""Row RMSNorm, forward and backward: every norm of the model (the two
block norms, qk-norm on each head, the final norm), on the serving path
and through autograd on the training path.

Replaces: src/repro/kernels/rmsnorm.py:rmsnorm (the Pallas kernel
``_rmsnorm_kernel``: f32 mean of squares, ``rsqrt(var + eps)``, times the
f32 scale, cast back). The TPU package has no backward kernel (it trains
through XLA's autodiff of the inline norm); the backward here is the
gradient of the same function. Plain versions: ``ref.rmsnorm_ref`` and
``ref.rmsnorm_bwd_ref``.

CUDA tensors go to the Triton kernels below; CPU tensors go to the plain
versions. There is no other path: a tensor on any other device raises.

What bounds it on the H100: bytes. A row is one reduction and one
elementwise pass, far below the card's ridge point. Each program holds
whole rows in registers (``BLOCK_D`` = the row width rounded up to a
power of two, masked), so x is read once and y written once; narrow rows
(qk-norm, 128 wide) go several to a program. Each operand is read in its
own dtype and converted in registers; the math is f32. The forward
writes the f32 ``rstd`` per row only when a backward will need it. The
backward recomputes xhat from x and rstd, writes dx, and keeps one f32
partial ``dscale`` per program, which one sum over the programs adds:
no float atomics, so the gradient is deterministic.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref

TILE = 4096            # elements of x a program holds per step
WARPS = 8              # 16 elements of a 4096 tile per thread
MAX_D = 16384          # widest row the kernels hold in registers
PROGRAMS_PER_SM = 4    # grid-stride programs of the backward

_KERNELS = None


def _kernels():
    """The two ``@triton.jit`` kernels, compiled by Triton at their first
    launch (triton is imported here, not when this module is imported)."""
    global _KERNELS
    if _KERNELS is None:
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

        @triton.jit
        def rmsnorm_bwd_kernel(x_ptr, s_ptr, dy_ptr, rstd_ptr, dx_ptr,
                               part_ptr, n_rows, d, x_stride, dy_stride,
                               num_tiles, ROWS: tl.constexpr,
                               BLOCK_D: tl.constexpr):
            pid = tl.program_id(0)
            cols = tl.arange(0, BLOCK_D)
            cmask = cols < d
            s = tl.load(s_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
            acc = tl.zeros([BLOCK_D], dtype=tl.float32)
            for t in range(pid, num_tiles, tl.num_programs(0)):
                rows = t * ROWS + tl.arange(0, ROWS)
                rmask = rows < n_rows
                mask = rmask[:, None] & cmask[None, :]
                rows64 = rows.to(tl.int64)[:, None]
                x = tl.load(x_ptr + rows64 * x_stride + cols[None, :],
                            mask=mask, other=0.0).to(tl.float32)
                dy = tl.load(dy_ptr + rows64 * dy_stride + cols[None, :],
                             mask=mask, other=0.0).to(tl.float32)
                rstd = tl.load(rstd_ptr + rows, mask=rmask, other=0.0)
                xhat = x * rstd[:, None]
                g = dy * s[None, :]
                mean_gx = tl.sum(g * xhat, axis=1) / d
                dx = rstd[:, None] * (g - xhat * mean_gx[:, None])
                tl.store(dx_ptr + rows64 * d + cols[None, :],
                         dx.to(dx_ptr.dtype.element_ty), mask=mask)
                acc += tl.sum(dy * xhat, axis=0)
            tl.store(part_ptr + pid.to(tl.int64) * d + cols, acc, mask=cmask)

        _KERNELS = (rmsnorm_fwd_kernel, rmsnorm_bwd_kernel)
    return _KERNELS


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
            _kernels()[0][(-(-n // per_prog),)](
                rows, scale, y, rstd, n, d, rows.stride(0), float(eps),
                ROWS=per_prog, BLOCK_D=block_d, WRITE_RSTD=want_rstd,
                num_warps=WARPS)
        rmsnorm_forward.launches += 1
    return y.view(x.shape), (rstd if want_rstd else None)


def rmsnorm_backward(x: torch.Tensor, scale: torch.Tensor,
                     rstd: Optional[torch.Tensor], dy: torch.Tensor,
                     eps: float = 1e-5
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients ``(dx, dscale)`` of ``rmsnorm_forward``'s y against
    ``dy`` (x's shape), from x and the forward's rstd: dx in x's dtype,
    dscale in scale's dtype, summed over the rows in f32. On CPU tensors
    the plain version, which recomputes rstd."""
    if x.device.type == "cpu":
        return ref.rmsnorm_bwd_ref(x, scale, dy, eps)
    _check(x, scale)
    rows = _as_rows(x, "x")
    n, d = rows.shape
    dy_rows = _as_rows(dy, "dy")
    if (dy_rows.shape != rows.shape or rstd is None
            or rstd.shape != (n,) or rstd.dtype != torch.float32
            or not rstd.is_contiguous() or dy.device != x.device):
        raise ValueError("rmsnorm backward: dy must be x-shaped on x's "
                         "device, rstd the forward's (n,) f32 rows")
    block_d, per_prog = _tiling(d)
    dx = torch.empty((n, d), dtype=x.dtype, device=x.device)
    num_tiles = -(-n // per_prog)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = max(1, min(num_tiles, PROGRAMS_PER_SM * sms))
    part = torch.zeros((grid, d), dtype=torch.float32, device=x.device)
    if n:
        with torch.cuda.device(x.device):
            _kernels()[1][(grid,)](
                rows, scale, dy_rows, rstd, dx, part, n, d, rows.stride(0),
                dy_rows.stride(0), num_tiles, ROWS=per_prog,
                BLOCK_D=block_d, num_warps=WARPS)
        rmsnorm_backward.launches += 1
    return dx.view(x.shape), part.sum(dim=0).to(scale.dtype)


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
