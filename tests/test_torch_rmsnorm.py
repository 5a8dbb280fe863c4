"""RMSNorm of the PyTorch port against the reference, on the CPU.

The port's plain forward (``ref.rmsnorm_ref``) is held against the
reference's Pallas ``rmsnorm`` in interpret mode, as
``tests/test_kernels.py`` runs it: float32 within 1e-6 relative to each
element (both sum the squares in f32, in other orders), bfloat16 within
one bfloat16 ulp of the reference's value (one rounding of the f32
result). The plain backward (``ref.rmsnorm_bwd_ref``) is held against
``jax.vjp`` of the reference's ``rmsnorm_ref`` and against torch's
autograd of the plain forward: dx and dscale within 1e-5 of their
largest magnitude in float32. ``ops.rmsnorm`` on CPU tensors is the
plain version, bit for bit the inline formula the layers ran before it.
The backward in the CUDA kernel's row partition and combine order
(``ref.rmsnorm_bwd_blocked``) is held against both, within 1e-5 of the
largest magnitude in float32, on every route's plan and on plans with
more row workers than rows. The kernels themselves (CUDA forward and
backward) run only on the card (``tests/test_torch_cuda_kernels.py``,
marked ``cuda``); here their plans are held to the routes and grids
they promise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as kref
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro_torch.kernels import ops
from repro_torch.kernels import ref as pref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import layers

EPS = 1e-6              # qwen3's norm_eps


def _inputs(shape, x_dtype, s_dtype, seed):
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    s = rng.standard_normal(shape[-1]).astype(np.float32)
    jx = jnp.asarray(x).astype(x_dtype)
    js = jnp.asarray(s).astype(s_dtype)
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    ts = torch.from_numpy(s).to(getattr(torch, s_dtype))
    return (jx, js), (tx, ts)


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """Spacing of bfloat16 numbers at |v| (8 significant bits)."""
    mag = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


@pytest.mark.parametrize("rows", [1, 7, 130])
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_ref_matches_pallas_interpret(rows, width, dtype):
    (jx, js), (tx, ts) = _inputs((rows, width), dtype, "float32",
                                 seed=rows * width)
    want = np.asarray(pallas_rmsnorm(jx, js, EPS, interpret=True)
                      .astype(jnp.float32))
    got = pref.rmsnorm_ref(tx, ts, EPS)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    got = got.float().numpy()
    err = np.abs(got - want)
    if dtype == "float32":
        assert np.all(err <= 1e-6 * np.abs(want) + 1e-30), err.max()
    else:
        assert np.all(err <= _bf16_ulp(want)), err.max()


@pytest.mark.parametrize("shape", [(1, 128), (7, 256), (2, 3, 128),
                                   (130, 2048)])
def test_rmsnorm_bwd_ref_matches_jax_vjp(shape):
    (jx, js), (tx, ts) = _inputs(shape, "float32", "float32", seed=len(shape))
    dy = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x, s: kref.rmsnorm_ref(x, s, EPS), jx, js)
    want_dx, want_ds = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    dx, ds = pref.rmsnorm_bwd_ref(tx, ts, torch.from_numpy(dy), EPS)
    assert dx.dtype == torch.float32 and ds.dtype == torch.float32
    for got, want in ((dx.numpy(), want_dx), (ds.numpy(), want_ds)):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("x_dtype,s_dtype", [("float32", "float32"),
                                             ("bfloat16", "float32"),
                                             ("bfloat16", "bfloat16")])
def test_rmsnorm_bwd_ref_matches_autograd_of_plain_forward(x_dtype,
                                                           s_dtype):
    """Gradients in the operands' dtypes: float32 within 1e-5 of the
    largest magnitude; bfloat16 outputs within 1e-2 of it (each side
    rounds its f32 gradient to bfloat16 once, after sums in other
    orders: at most about one bfloat16 ulp)."""
    _, (tx, ts) = _inputs((6, 4, 128), x_dtype, s_dtype, seed=9)
    dy = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (6, 4, 128)).astype(np.float32)).to(tx.dtype)
    x = tx.clone().requires_grad_(True)
    s = ts.clone().requires_grad_(True)
    pref.rmsnorm_ref(x, s, EPS).backward(dy)
    dx, ds = pref.rmsnorm_bwd_ref(tx, ts, dy, EPS)
    assert dx.dtype == tx.dtype and ds.dtype == ts.dtype
    tol = 1e-5 if x_dtype == s_dtype == "float32" else 1e-2
    for got, want in ((dx, x.grad), (ds, s.grad)):
        want = want.float()
        assert float((got.float() - want).abs().max()) <= \
            tol * float(want.abs().max())


@pytest.mark.parametrize("x_dtype,s_dtype", [("float32", "float32"),
                                             ("bfloat16", "bfloat16")])
def test_rmsnorm_autograd_function_on_cpu_matches_plain(x_dtype, s_dtype):
    """``RMSNorm.apply`` on CPU tensors (forward and backward wrappers'
    plain versions) against autograd of the plain forward: the output
    bit for bit, the gradients within 1e-5 (float32) or 1e-2 (bfloat16)
    of their largest magnitude. No kernel launch is counted."""
    _, (tx, ts) = _inputs((5, 3, 256), x_dtype, s_dtype, seed=4)
    dy = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (5, 3, 256)).astype(np.float32)).to(tx.dtype)
    before = (rn.rmsnorm_forward.launches, rn.rmsnorm_backward.launches)
    x1, s1 = tx.clone().requires_grad_(True), ts.clone().requires_grad_(True)
    y1 = rn.RMSNorm.apply(x1, s1, EPS)
    y1.backward(dy)
    x2, s2 = tx.clone().requires_grad_(True), ts.clone().requires_grad_(True)
    y2 = pref.rmsnorm_ref(x2, s2, EPS)
    y2.backward(dy)
    assert torch.equal(y1, y2)
    tol = 1e-5 if x_dtype == "float32" else 1e-2
    for got, want in ((x1.grad, x2.grad), (s1.grad, s2.grad)):
        assert got.dtype == want.dtype
        assert float((got.float() - want.float()).abs().max()) <= \
            tol * float(want.float().abs().max())
    assert (rn.rmsnorm_forward.launches,
            rn.rmsnorm_backward.launches) == before


@pytest.mark.parametrize("shape,x_dtype,s_dtype", [
    ((2, 5, 64), "float32", "float32"),          # block norm
    ((2, 5, 4, 16), "bfloat16", "float32"),      # qk-norm, serving
    ((3, 7, 64), "bfloat16", "bfloat16"),        # training compute params
])
def test_ops_rmsnorm_cpu_is_the_old_inline_formula(shape, x_dtype, s_dtype):
    """On the CPU the layers' norm is the same op sequence as the inline
    formula ``apply_rmsnorm`` had before it went through ``ops.rmsnorm``:
    equal bit for bit, with and without autograd."""
    _, (tx, ts) = _inputs(shape, x_dtype, s_dtype, seed=len(shape))

    def inline(x, scale):
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + EPS)
        return (y * scale.float()).to(x.dtype)
    assert torch.equal(ops.rmsnorm(tx, ts, EPS), inline(tx, ts))
    assert torch.equal(layers.apply_rmsnorm({"scale": ts}, tx, EPS),
                       inline(tx, ts))
    x = tx.clone().requires_grad_(True)
    s = ts.clone().requires_grad_(True)
    xr = tx.clone().requires_grad_(True)
    sr = ts.clone().requires_grad_(True)
    dy = torch.ones(shape, dtype=tx.dtype)
    ops.rmsnorm(x, s, EPS).backward(dy)
    inline(xr, sr).backward(dy)
    assert torch.equal(x.grad, xr.grad) and torch.equal(s.grad, sr.grad)


def test_rmsnorm_wrapper_row_layout_and_dispatch():
    """What the wrappers hand the kernels: rows by stride without a copy
    where one row stride describes them (a column slice, a qk-norm head
    reshape), an explicit copy where none does; the forward's plan at
    the main path's prefill widths and a misaligned width; and no path
    for a device other than CUDA or CPU."""
    big = torch.randn(6, 256)
    rows = rn._as_rows(big[:, :128], "x")
    assert rows.data_ptr() == big.data_ptr() and rows.stride() == (256, 1)
    heads = torch.randn(2, 3, 4 * 16).reshape(2, 3, 4, 16)
    assert rn._as_rows(heads, "x").data_ptr() == heads.data_ptr()
    gappy = torch.randn(4, 5, 32)[:, ::2]          # no single row stride
    copied = rn._as_rows(gappy, "x")
    assert copied.is_contiguous() and torch.equal(copied,
                                                  gappy.reshape(-1, 32))
    sms = 132
    rows = rn.FWD_ROWS["narrow"]
    assert rn.fwd_plan(16384, 128, 2, (0, 256, 0), sms) == rn.FwdPlan(
        "narrow", rows, 16384 // rows,
        32 * min(rows // 2, rn.FWD_NARROW_WARPS), 16)
    assert rn.fwd_plan(16384, 128, 4, (0, 512, 0), sms) == rn.FwdPlan(
        "narrow", rows, 16384 // rows, 32 * min(rows, rn.FWD_NARROW_WARPS),
        32)
    rows = rn.FWD_ROWS["wide"]
    assert rn.fwd_plan(1024, 2048, 2, (0, 4096, 0), sms) == rn.FwdPlan(
        "wide", rows, 1024 // rows, 32 * rows, 32)
    assert rn.fwd_plan(33, 1000, 2, (0, 2002, 0), sms) == rn.FwdPlan(
        "general", 1, 33, rn.GENERAL_THREADS, rn.GENERAL_THREADS)
    with pytest.raises(ValueError):
        rn.fwd_plan(4, rn.MAX_D + 1, 2, (0, 0, 0), sms)
    meta = torch.empty((4, 128), device="meta")
    with pytest.raises(ValueError):
        rn.rmsnorm_forward(meta, torch.empty(128, device="meta"))
    with pytest.raises(ValueError):
        rn.rmsnorm_backward(meta, torch.empty(128, device="meta"), None,
                            meta)


# (rows, width, x/dy addresses and row strides in bytes of 2-byte
# elements, expected route): the training norms, the serving decode
# norm, ragged and misaligned rows, the widest rows
PLAN_CASES = [
    (4096, 2048, (0, 0, 4096, 4096), "wide"),
    (65536, 128, (0, 0, 256, 256), "narrow"),
    (32768, 128, (0, 0, 768, 256), "narrow"),
    (8, 2048, (0, 0, 4096, 4096), "wide"),
    (33, 1000, (0, 0, 2000, 2000), "wide"),
    (33, 1000, (0, 2, 2000, 2000), "general"),
    (517, 128, (256, 0, 768, 256), "narrow"),
    (9, 64, (0, 0, 128, 128), "narrow"),
    (9, 130, (0, 0, 260, 260), "general"),
    (5, 12, (0, 0, 24, 24), "narrow"),
    (5, 12, (0, 0, 24, 26), "general"),
    (3, 10000, (0, 0, 20000, 20000), "general"),
    # zamba2-1.2b's gate norm (4096), granite's training norm, and the
    # next width of 8 past the wide route
    (4096, 4096, (0, 0, 8192, 8192), "wide"),
    (4096, 1536, (0, 0, 3072, 3072), "wide"),
    (33, 8200, (0, 0, 16400, 16400), "general"),
    # llama-3.2-vision-90b's width (8192: the widest wide row) at its
    # training and decode rows, and misaligned
    (4096, 8192, (0, 0, 16384, 16384), "wide"),
    (8, 8192, (0, 0, 16384, 16384), "wide"),
    (8, 8192, (0, 2, 16384, 16384), "general"),
]


@pytest.mark.parametrize("n,d,addresses,route", PLAN_CASES)
def test_rmsnorm_bwd_plan_routes_and_grid(n, d, addresses, route):
    """The backward kernel's plan: its route by width and alignment, a
    persistent grid of at most ``BLOCKS_PER_SM`` blocks an SM (fewer when
    the rows run out), first-level groups of ceil(sqrt(blocks))."""
    sms = 132
    for k in (None, 1, 3):
        plan = rn.bwd_plan(n, d, 2, addresses, sms, k)
        assert plan.route == route
        assert plan.workers == (rn.NARROW_WARPS if route == "narrow" else 1)
        units = -(-n // (4 * rn.NARROW_WARPS)) if route == "narrow" else n
        assert plan.blocks == min(units, (k or rn.BLOCKS_PER_SM) * sms)
        assert (plan.group - 1) ** 2 < plan.blocks <= plan.group ** 2


# (rows, width, x address and row stride and scale address in bytes of
# 2-byte elements, expected route, rows a block (None: FWD_ROWS), lanes a
# row): the training and prefill norms, the decode rows (spread over the
# SMs: one row a block, two where a warp holds two 16-lane rows), ragged,
# misaligned and widest rows
FWD_PLAN_CASES = [
    (4096, 2048, (0, 4096, 0), "wide", None, 32),
    (65536, 128, (0, 256, 0), "narrow", None, 16),
    (32768, 128, (0, 768, 0), "narrow", None, 16),
    (8192, 128, (256, 256, 0), "narrow", None, 16),
    (8192, 128, (8, 256, 0), "narrow", None, 32),
    (1024, 2048, (0, 4096, 0), "wide", None, 32),
    (1024, 1536, (0, 3072, 0), "wide", None, 32),
    (4096, 1536, (0, 3072, 0), "wide", None, 32),
    (8, 2048, (0, 4096, 0), "wide", 1, 32),
    (8, 1536, (0, 3072, 0), "wide", 1, 32),
    (128, 128, (0, 256, 0), "narrow", 2, 16),
    (64, 128, (0, 256, 0), "narrow", 2, 16),
    (300, 128, (0, 256, 0), "narrow", 4, 16),
    (33, 1000, (0, 2000, 0), "wide", 1, 32),
    (33, 1000, (2, 2000, 0), "general", 1, 256),
    (33, 1000, (0, 2000, 8), "general", 1, 256),
    (131, 2048, (4096, 12288, 0), "wide", 1, 32),
    (131, 2048, (4098, 12288, 0), "general", 1, 256),
    (517, 128, (256, 768, 0), "narrow", 4, 16),
    (517, 128, (2, 768, 0), "general", 1, 256),
    (9, 64, (0, 128, 0), "narrow", 2, 16),
    (9, 130, (0, 260, 0), "general", 1, 256),
    (5, 12, (0, 24, 0), "narrow", 1, 32),
    (5, 12, (0, 26, 0), "general", 1, 256),
    (3, 10000, (0, 20000, 0), "general", 1, 256),
    (4096, 4096, (0, 8192, 0), "wide", None, 64),
    (8, 4096, (0, 8192, 0), "wide", 1, 64),
    (33, 8200, (0, 16400, 0), "general", 1, 256),
    (4096, 8192, (0, 16384, 0), "wide", None, 128),
    (8, 8192, (0, 16384, 0), "wide", 1, 128),
    (8, 8192, (2, 16384, 0), "general", 1, 256),
]


@pytest.mark.parametrize("n,d,addresses,route,rows,lanes", FWD_PLAN_CASES)
def test_rmsnorm_fwd_plan_routes(n, d, addresses, route, rows, lanes):
    """The forward kernel's plan: the backward's route by width,
    divisibility, row stride and address alignment (the scale's too);
    narrow rows in 16 lanes of 8 elements when they are 16-byte aligned,
    else 32 of 4; ``FWD_ROWS`` rows a block where the blocks cover the
    SMs, else the power of two that does (decode rows spread); a grid of
    ceil(n / rows) blocks whose threads fit the route: a narrow block of
    up to ``FWD_NARROW_WARPS`` warps of 1, 2 or 4 steps of rows, a
    wide block of a warp a row (two above 2048, four above 4096), a
    general block of one row. Every rows-a-block override keeps the route
    and the grid covering the rows."""
    sms = 132
    plan = rn.fwd_plan(n, d, 2, addresses, sms)
    assert plan.route == route == rn.row_route(d, 2, addresses)
    assert plan.rows == (rows or rn.FWD_ROWS[route])
    assert plan.lanes == lanes
    assert plan.blocks == -(-n // plan.rows)
    if route != "general" and rows is None:
        assert plan.blocks >= sms
    for k in (None, 1, 2, 3, 4, 8, 16, 32, 64):
        p = rn.fwd_plan(n, d, 2, addresses, sms, k)
        assert p.route == route and p.lanes == lanes
        assert (p.blocks - 1) * p.rows < n <= p.blocks * p.rows
        assert p.threads % 32 == 0 and p.threads <= 256
        if route == "narrow":
            steps, rem = divmod(p.rows * p.lanes, p.threads)
            assert rem == 0 and steps in (1, 2, 4)
            assert p.threads // 32 <= rn.FWD_NARROW_WARPS
        elif route == "wide":
            assert p.threads == p.rows * p.lanes
        else:
            assert (p.rows, p.threads) == (1, rn.GENERAL_THREADS)


@pytest.mark.parametrize("plan,d", [
    (rn.FwdPlan("narrow", 64, 128, 256, 16), 128),
    (rn.FwdPlan("wide", 4, 1024, 256, 64), 4096),
    (rn.FwdPlan("wide", 2, 2048, 256, 128), 8192),
    (rn.FwdPlan("wide", 1, 8, 128, 128), 8192),
    (rn.FwdPlan("general", 1, 3, 256, 256), rn.MAX_D),
    (rn.BwdPlan("wide", (1 << 24) - 1, 1, 4095), 4096),
    (rn.BwdPlan("wide", 132, 1, 12), 8192),
    (rn.BwdPlan("narrow", 264, 16, 17), 128)])
def test_rmsnorm_plan_words_keep_every_field(plan, d):
    """The one integer a plan reaches the C entry as holds each field in
    its own bits (the layout ``csrc/rmsnorm.cu`` unpacks), for every
    dtype pair, at the widest values the kernels take."""
    for x_dt, xc in ((torch.float32, 0), (torch.bfloat16, 1),
                     (torch.float16, 2)):
        for s_dt, sc in ((torch.float32, 0), (torch.bfloat16, 1)):
            w = plan.word(d, x_dt, s_dt)
            assert (w & 0xffff, w >> 16 & 3, w >> 18 & 3, w >> 20 & 3) == \
                (d, rn.ROUTES[plan.route], xc, sc)
            if isinstance(plan, rn.FwdPlan):
                assert (w >> 22 & 0x1ff, w >> 31 & 0x1ff, w >> 40) == \
                    (plan.lanes, plan.threads, plan.rows)
            else:
                assert (w >> 22 & 0xfff, w >> 34) == (plan.group,
                                                      plan.blocks)


@pytest.mark.parametrize("d", [rn.MAX_D + 1, 2 * rn.MAX_D])
def test_rmsnorm_fwd_plan_refuses_rows_past_max_d(d):
    with pytest.raises(ValueError):
        rn.fwd_plan(4, d, 2, (0, 2 * d, 0), 132)


@pytest.mark.parametrize("shape,blocks,workers,group", [
    ((130, 2048), 20, 1, 5),        # wide: several rows a block
    ((200, 128), 4, 8, 2),          # narrow: warps as row workers
    ((7, 256), 5, 8, 3),            # more workers than rows
    ((2, 3, 128), 1, 1, 1),         # one worker takes every row
    ((33, 1000), 33, 1, 6),         # a block per row, ragged groups
])
def test_rmsnorm_bwd_blocked_matches_ref_and_jax_vjp(shape, blocks, workers,
                                                     group):
    """The blocked backward (the CUDA kernel's partition and fixed-order
    combine) from the forward's rstd against the plain backward and
    ``jax.vjp`` of the reference: dx and dscale within 1e-5 of their
    largest magnitude in float32."""
    (jx, js), (tx, ts) = _inputs(shape, "float32", "float32",
                                 seed=blocks * 31 + workers)
    dy = np.random.default_rng(blocks).standard_normal(shape).astype(
        np.float32)
    rstd = torch.rsqrt(tx.square().mean(dim=-1) + EPS).reshape(-1)
    dx, ds = pref.rmsnorm_bwd_blocked(tx, ts, rstd, torch.from_numpy(dy),
                                      blocks=blocks, workers=workers,
                                      group=group)
    assert dx.shape == tx.shape and ds.shape == ts.shape
    want_dx, want_ds = pref.rmsnorm_bwd_ref(tx, ts, torch.from_numpy(dy),
                                            EPS)
    _, vjp = jax.vjp(lambda x, s: kref.rmsnorm_ref(x, s, EPS), jx, js)
    jdx, jds = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    for got, want in ((dx, want_dx.numpy()), (ds, want_ds.numpy()),
                      (dx, jdx), (ds, jds)):
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_rmsnorm_bwd_blocked_sums_in_the_stated_order():
    """dscale of the blocked backward is the stated order of f32 sums,
    exactly: one worker a block and one block a group is the sequential
    sum over the rows; a plan of 4 blocks of 2 workers in groups of 2 is
    ((w0 + w1) + (w2 + w3)) + ((w4 + w5) + (w6 + w7)) of the workers'
    sequential sums."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    s = torch.ones(8)
    rstd = torch.rsqrt(x.square().mean(dim=-1) + EPS)
    c = dy * (x * rstd[:, None])

    def seq(rows):
        acc = torch.zeros(8)
        for row in rows:
            acc = acc + row
        return acc
    _, ds = pref.rmsnorm_bwd_blocked(x, s, rstd, dy, blocks=1, workers=1,
                                     group=1)
    assert torch.equal(ds, seq(c))
    _, ds = pref.rmsnorm_bwd_blocked(x, s, rstd, dy, blocks=4, workers=2,
                                     group=2)
    w = [seq(c[2 * i:2 * i + 2]) for i in range(8)]
    z = torch.zeros(8)
    blocks = [z + w[2 * b] + w[2 * b + 1] for b in range(4)]
    want = z + (z + blocks[0] + blocks[1]) + (z + blocks[2] + blocks[3])
    assert torch.equal(ds, want)