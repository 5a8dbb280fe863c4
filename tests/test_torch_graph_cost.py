"""Tier 2 of the port (``repro_torch.core.graph_cost`` and
``graph_waste``) against the reference's (``repro.core.hlo_cost`` and
``hlo_waste``): the cases of tests/test_hlo_cost.py, each run through
both side by side.

The reference compiles a JAX function and parses its HLO, multiplying
while bodies by their trip counts; the port traces the same computation
on fake tensors (``core/graph_trace.py``), its loops unrolled. Dot and
convolution flops must be exactly the reference's (``HloCostModel``'s
dots and convolutions, each times its computation's multiplier) for the
plain product, the gradient, the gradient under remat and nested loops;
the waste rules must give the reference's kinds and counts on the same
planted patterns. HBM bytes are not compared: XLA fuses, eager does not
(ROADMAP § C).
"""
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from repro.core.hlo_cost import HloCostModel, _conv_flops, _dot_flops
from repro.core.hlo_waste import analyze_waste as ref_analyze_waste
from repro_torch.core.graph_cost import GraphCostModel, analyze
from repro_torch.core.graph_trace import trace_step
from repro_torch.core.graph_waste import analyze_waste

ONE = 2 * 128 ** 3  # flops of a 128^3 matmul
c10d = torch.ops._c10d_functional


def ref_dot_flops(fn, *args) -> float:
    """The reference cost model's dot and convolution flops of the
    compiled ``fn``, each times its computation's multiplier."""
    hlo = jax.jit(fn).lower(*args).compile().as_text()
    cm = HloCostModel(hlo)
    mult = cm._multipliers()
    total = 0.0
    for cname, comp in cm.comps.items():
        for inst in comp.insts:
            if inst.op == "dot":
                total += _dot_flops(inst, comp) * mult.get(cname, 0.0)
            elif inst.op == "convolution":
                total += _conv_flops(inst, comp) * mult.get(cname, 0.0)
    return total


def port_dot_flops(fn, *args) -> float:
    return analyze(trace_step(fn, *args)).dot_flops


def _ones(*shape):
    return jnp.ones(shape), torch.ones(shape)


# --------------------------------------------------------------- the loops
def j_loop(length):
    def f(x, w):
        def body(c, _):
            return c @ w, None
        y, _ = jax.lax.scan(body, x, None, length=length)
        return y
    return f


def t_loop(length):
    def f(x, w):
        for _ in range(length):
            x = x @ w
        return x
    return f


def _grad_of(fn):
    """Gradient of fn(x, w).sum() with respect to both, traced."""
    def g(x, w):
        x = x.detach().requires_grad_(True)
        w = w.detach().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(fn(x, w).sum(), (x, w))
    return g


def test_loop_trip_count_multiplied():
    (jx, tx), (jw, tw) = _ones(128, 128), _ones(128, 128)
    got = port_dot_flops(t_loop(7), tx, tw)
    assert got == ref_dot_flops(j_loop(7), jx, jw) == 7 * ONE


def test_grad_and_remat_flops():
    (jx, tx), (jw, tw) = _ones(128, 128), _ones(128, 128)

    def jg(x, w):
        return j_loop(7)(x, w).sum()
    ref = ref_dot_flops(jax.grad(jg, argnums=(0, 1)), jx, jw)
    assert port_dot_flops(_grad_of(t_loop(7)), tx, tw) == ref
    assert abs(ref / ONE - 21) < 1.0

    def jh(x, w):
        def body(c, _):
            return jax.checkpoint(lambda c: jnp.tanh(c @ w))(c), None
        y, _ = jax.lax.scan(body, x, None, length=7)
        return y.sum()

    def th(x, w):
        for _ in range(7):
            x = torch.utils.checkpoint.checkpoint(
                lambda c: torch.tanh(c @ w), x, use_reentrant=False)
        return x
    ref = ref_dot_flops(jax.grad(jh, argnums=(0, 1)), jx, jw)
    # remat adds 7 recompute matmuls on top of 21
    assert port_dot_flops(_grad_of(th), tx, tw) == ref
    assert abs(ref / ONE - 28) < 1.5


def test_dot_flops_exact():
    (ja, ta), (jb, tb) = _ones(64, 32), _ones(32, 96)
    got = port_dot_flops(lambda a, b: a @ b, ta, tb)
    assert got == ref_dot_flops(lambda a, b: a @ b, ja, jb) \
        == 2 * 64 * 32 * 96


def test_nested_loop_multiplies():
    def jf(x, w):
        def outer(c, _):
            def inner(ci, _):
                return ci @ w, None
            c2, _ = jax.lax.scan(inner, c, None, length=3)
            return c2, None
        y, _ = jax.lax.scan(outer, x, None, length=5)
        return y

    def tf(x, w):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x
    (jx, tx), (jw, tw) = _ones(128, 128), _ones(128, 128)
    assert port_dot_flops(tf, tx, tw) == ref_dot_flops(jf, jx, jw) \
        == 15 * ONE


def test_conv_flops_exact():
    def jf(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
    x, w = torch.ones(1, 4, 8, 8), torch.ones(4, 4, 3, 3)
    got = port_dot_flops(lambda x, w: F.conv2d(x, w, padding=1), x, w)
    assert got == ref_dot_flops(jf, jnp.ones((1, 8, 8, 4)),
                                jnp.ones((3, 3, 4, 4)))


# -------------------------------------------------------------- collectives
_HLO_COLLECTIVES = """
HloModule m

ENTRY %main (p0: f32[1024]) -> f32[1024] {
  %p0 = f32[1024]{0} parameter(0)
  %ag = f32[8192]{0} all-gather(%p0), replica_groups=[2,8]<=[16], dimensions={0}
  %ar = f32[1024]{0} all-reduce(%p0), replica_groups=[2,8]<=[16], to_apply=%add
  %rs = f32[128]{0} reduce-scatter(%p0), replica_groups=[2,8]<=[16], dimensions={0}, to_apply=%add
  ROOT %aa = f32[1024]{0} all-to-all(%p0), replica_groups=[2,8]<=[16], dimensions={0}
}
"""


def t_collectives(x):
    ag = c10d.wait_tensor(c10d.all_gather_into_tensor(x, 8, "g"))
    ar = c10d.wait_tensor(c10d.all_reduce(x, "sum", "g"))
    rs = c10d.wait_tensor(c10d.reduce_scatter_tensor(x, "sum", 8, "g"))
    aa = c10d.wait_tensor(c10d.all_to_all_single(x, [128] * 8, [128] * 8,
                                                 "g"))
    return ag, ar, rs, aa


def test_wire_model_factors():
    """Every collective kind: the ring model's wire bytes equal the
    reference's on the same payloads and groups of 8."""
    ref = HloCostModel(_HLO_COLLECTIVES).total()
    port = GraphCostModel(trace_step(t_collectives, torch.ones(1024)),
                          default_participants=8).total()
    assert port.coll_wire_bytes == ref.coll_wire_bytes
    assert port.coll_by_kind == ref.coll_by_kind
    assert port.coll_count == ref.coll_count == 4


def _kinds_counts(profile):
    return sorted((f.kind, f.count) for f in profile.findings)


def test_tier2_finds_redundant_gather_pattern():
    """Two gathers of the same tensor -> a redundant-collective finding."""
    hlo = """
HloModule m

ENTRY %main (p0: f32[4096]) -> f32[4096] {
  %p0 = f32[4096]{0} parameter(0)
  %ag1 = f32[4096]{0} all-gather(%p0), replica_groups=[2,8]<=[16], dimensions={0}
  %ag2 = f32[4096]{0} all-gather(%p0), replica_groups=[2,8]<=[16], dimensions={0}
  ROOT %s = f32[4096]{0} add(%ag1, %ag2)
}
"""

    def f(p):
        a = c10d.wait_tensor(c10d.all_gather_into_tensor(p, 8, "g"))
        b = c10d.wait_tensor(c10d.all_gather_into_tensor(p, 8, "g"))
        return a + b
    rep = analyze_waste(trace_step(f, torch.ones(512)))
    ref = ref_analyze_waste(hlo)
    assert rep.totals["redundant_collective_bytes"] == \
        ref.totals["redundant_collective_bytes"] > 0
    assert rep.redundant_collectives[0]["copies"] == 2
    assert _kinds_counts(rep.profile) == _kinds_counts(ref.profile)


# ---------------------------------------------------------------------
# recompute: the same operation over the same operand values
# ---------------------------------------------------------------------
_HLO_DIFFERENT = """
HloModule m

ENTRY %main (p0: f32[128,128]) -> f32[128,128] {
  %p0 = f32[128,128]{1,0} parameter(0)
  %e1 = f32[128,128]{1,0} exponential(%p0)
  %t1 = f32[128,128]{1,0} tanh(%p0)
  %d1 = f32[128,128]{1,0} dot(%e1, %e1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %d2 = f32[128,128]{1,0} dot(%t1, %t1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  ROOT %s = f32[128,128]{1,0} add(%d1, %d2)
}
"""

_HLO_DUPLICATE = """
HloModule m

ENTRY %main (p0: f32[128,128]) -> f32[128,128] {
  %p0 = f32[128,128]{1,0} parameter(0)
  %e1 = f32[128,128]{1,0} exponential(%p0)
  %d1 = f32[128,128]{1,0} dot(%e1, %e1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %d2 = f32[128,128]{1,0} dot(%e1, %e1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  ROOT %s = f32[128,128]{1,0} add(%d1, %d2)
}
"""


def test_recompute_not_flagged_for_different_producers():
    """Same shapes, different operand values: not recompute."""
    def f(p):
        e, t = torch.exp(p), torch.tanh(p)
        return e @ e + t @ t
    rep = analyze_waste(trace_step(f, torch.ones(128, 128)))
    ref = ref_analyze_waste(_HLO_DIFFERENT)
    assert rep.recompute == ref.recompute == []
    assert rep.totals["recompute_flops"] == 0


def test_recompute_flagged_for_true_duplicate():
    def f(p):
        e = torch.exp(p)
        return e @ e + e @ e
    rep = analyze_waste(trace_step(f, torch.ones(128, 128)))
    ref = ref_analyze_waste(_HLO_DUPLICATE)
    assert len(rep.recompute) == len(ref.recompute) == 1
    assert rep.recompute[0]["copies"] == ref.recompute[0]["copies"] == 2
    assert rep.totals["recompute_flops"] == ref.totals["recompute_flops"] > 0
    assert _kinds_counts(rep.profile) == _kinds_counts(ref.profile)


def test_recompute_layers_of_one_shape_are_not_duplicates():
    """Unrolled layers with same-shaped weights are different products;
    the recompute under remat is the same product again."""
    def layers(x, w):
        for i in range(4):
            x = torch.tanh(x @ w[i])
        return x

    def remat(x, w):
        for i in range(4):
            x = torch.utils.checkpoint.checkpoint(
                lambda c, wi: torch.tanh(c @ wi), x, w[i],
                use_reentrant=False)
        return x
    x, w = torch.ones(16, 32), torch.ones(4, 32, 32)
    plain = analyze_waste(trace_step(_grad_of(layers), x, w))
    assert plain.recompute == []
    rep = analyze_waste(trace_step(_grad_of(remat), x, w))
    assert len(rep.recompute) == 4
    assert rep.totals["recompute_flops"] == 4 * 2 * 16 * 32 * 32


def test_recompute_covers_convolution():
    hlo = """
HloModule m

ENTRY %main (p0: f32[1,8,8,4], w: f32[3,3,4,4]) -> f32[1,8,8,4] {
  %p0 = f32[1,8,8,4]{3,2,1,0} parameter(0)
  %w = f32[3,3,4,4]{3,2,1,0} parameter(1)
  %c1 = f32[1,8,8,4]{3,2,1,0} convolution(%p0, %w), window={size=3x3 pad=1_1x1_1}, dim_labels=b01f_01io->b01f
  %c2 = f32[1,8,8,4]{3,2,1,0} convolution(%p0, %w), window={size=3x3 pad=1_1x1_1}, dim_labels=b01f_01io->b01f
  ROOT %s = f32[1,8,8,4]{3,2,1,0} add(%c1, %c2)
}
"""

    def f(x, w):
        return F.conv2d(x, w, padding=1) + F.conv2d(x, w, padding=1)
    rep = analyze_waste(trace_step(f, torch.ones(1, 4, 8, 8),
                                   torch.ones(4, 4, 3, 3)))
    ref = ref_analyze_waste(hlo)
    assert len(rep.recompute) == len(ref.recompute) == 1
    assert rep.recompute[0]["fingerprint"].startswith("convolution")
    assert rep.recompute[0]["flops"] == ref.recompute[0]["flops"]


def test_recompute_covers_large_reductions_only():
    hlo = """
HloModule m

ENTRY %main (p0: f32[500000], q0: f32[16]) -> f32[] {
  %p0 = f32[500000]{0} parameter(0)
  %q0 = f32[16]{0} parameter(1)
  %z = f32[] constant(0)
  %r1 = f32[] reduce(%p0, %z), dimensions={0}, to_apply=%add
  %r2 = f32[] reduce(%p0, %z), dimensions={0}, to_apply=%add
  %s1 = f32[] reduce(%q0, %z), dimensions={0}, to_apply=%add
  %s2 = f32[] reduce(%q0, %z), dimensions={0}, to_apply=%add
  %a = f32[] add(%r1, %r2)
  %b = f32[] add(%s1, %s2)
  ROOT %out = f32[] add(%a, %b)
}
"""

    def f(p, q):
        return (p.sum() + p.sum()) + (q.sum() + q.sum())
    rep = analyze_waste(trace_step(f, torch.ones(500000), torch.ones(16)))
    ref = ref_analyze_waste(hlo)
    # the 2 MB reduction duplicates; the 64 B one is below the size floor
    assert len(rep.recompute) == len(ref.recompute) == 1
    assert rep.recompute[0]["fingerprint"].startswith("sum")
    assert "f32[500000]" in rep.recompute[0]["fingerprint"]
    assert _kinds_counts(rep.profile) == _kinds_counts(ref.profile)


# ---------------------------------------------------------------------
# reshard threshold parameter + summary rows
# ---------------------------------------------------------------------
_RESHARD_HLO = """
HloModule m

ENTRY %main (p0: f32[250000]) -> f32[250000] {
  %p0 = f32[250000]{0} parameter(0)
  ROOT %cp = f32[250000]{0} copy(%p0), metadata={op_name="jit(f)/reshard"}
}
"""


def reshard(p):
    return p.t().contiguous()          # a copy that only moves bytes


def test_reshard_threshold_is_a_parameter_and_summary_prints_rows():
    traced = trace_step(reshard, torch.ones(500, 500))
    # 1 MB copy: under the 64 MB default, over a lowered threshold
    rep = analyze_waste(traced)
    assert rep.reshard_copies == [] == ref_analyze_waste(
        _RESHARD_HLO).reshard_copies
    rep = analyze_waste(traced, reshard_threshold=1e5)
    ref = ref_analyze_waste(_RESHARD_HLO, reshard_threshold=1e5)
    assert len(rep.reshard_copies) == len(ref.reshard_copies) == 1
    assert rep.totals["reshard_bytes"] == ref.totals["reshard_bytes"] > 0
    assert _kinds_counts(rep.profile) == _kinds_counts(ref.profile)
    text = rep.summary()
    assert "[reshard]" in text
    assert "reshard" in text.split("[reshard]")[1]    # op_name provenance


def test_padding_flops_of_a_padded_product():
    def f(a, b):
        return F.pad(a, (0, 0, 0, 16)) @ b        # 16 of 64 rows padded
    rep = analyze_waste(trace_step(f, torch.ones(48, 32), torch.ones(32, 8)))
    assert rep.totals["padding_flops"] == 2 * 16 * 32 * 8
    assert [f.kind for f in rep.profile.findings] == ["dot_padding"]
    assert "[pad]" in rep.summary()
