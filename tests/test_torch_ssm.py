"""The hybrid family of the PyTorch port against the reference, on the
CPU: the Mamba2 block (``models/ssm.py``: ``_segsum``, ``_causal_conv``,
``_ssd_chunked``, ``apply_mamba`` chunked and recurrent), the hybrid LM
(zamba2-1.2b's smoke config at 14 layers, so that it has the full
config's structure: superblocks of 6 Mamba2 blocks and one use of the
shared dense block, then a 2-block tail) with the reference's weights
(``from_reference``): forward, loss and every gradient leaf, the cached
decode, the token-loop serving driver, and the parameter count.

Tolerances, float32 throughout:
- ``_segsum`` and ``_causal_conv`` within 1e-6 relative (the same
  elementwise f32 arithmetic; cumsum in another order);
- the SSD scan, ``apply_mamba`` and its states within 1e-5 of the
  largest magnitude (f32 einsums contracted in other orders);
- the chunked path against the recurrence, within the port, within 1e-5
  of the largest magnitude (the same sums, grouped by chunk);
- logits within 1e-4 and the loss within 1e-5 relative (as the dense and
  MoE families' tests), gradients within 1e-4 of each leaf's largest
  magnitude (as ``test_torch_train``);
- greedy tokens, the parameter count, schedules and errors exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import ssm as ref_ssm
from repro.models.zoo import count_params_analytic as ref_count
from repro.serve.decode import make_serve_step as ref_serve_step
from repro_torch.configs import registry as pt_registry
from repro_torch.core import detectors as pt_detectors
from repro_torch.models import lm as pt_lm
from repro_torch.models import params as P
from repro_torch.models import ssm as pt_ssm
from repro_torch.models.zoo import count_params_analytic as pt_count
from repro_torch.serve.decode import make_serve_step

from _torch_parity import smoke_models, to_np

ZAMBA = "zamba2-1.2b"
LAYERS = 14                       # 2 superblocks of 6 + shared, a tail of 2


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _near(got, want, frac=1e-5):
    """Within ``frac`` of the reference's largest magnitude."""
    want = np.asarray(want)
    _close(got, want, rtol=0, atol=frac * max(np.abs(want).max(), 1e-30))


def _models():
    return smoke_models(arch=ZAMBA, num_layers=LAYERS)


def _block(ref_params, pt_params, name="b0_mamba", li=0):
    """One Mamba2 block's parameters, layer ``li`` of ``name``."""
    ref_p = jax.tree_util.tree_map(lambda a: a[li], ref_params["main"][name])
    pt_p = P.tree_map(lambda t: t[li], pt_params["main"][name])
    return ref_p, pt_p


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_schedule_and_param_count_match_reference():
    """The hybrid schedule (6 superblocks of 6 Mamba2 blocks + the shared
    block, a tail of 2) and zamba2-1.2b's parameter count at full width."""
    full = pt_registry.get_config(ZAMBA)
    sch = pt_lm.make_schedule(full)
    assert sch.pattern == ("mamba",) * 6 + ("shared",)
    assert (sch.n_super, sch.tail, sch.has_shared) == (6, ("mamba",) * 2,
                                                       True)
    assert pt_count(full) == ref_count(ref_registry.get_config(ZAMBA)) \
        == 1_170_473_856
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        pt_lm.make_schedule(pt_registry.get_config("llama-3.2-vision-90b"))


def test_param_tree_loads_one_to_one():
    """``from_reference`` maps ``main``, ``tail`` and ``shared`` 1:1: the
    port's declaration has the reference's paths and shapes."""
    _, ref_params, pt_model, pt_params = _models()
    want = [(jax.tree_util.keystr(k), v.shape) for k, v in
            jax.tree_util.tree_flatten_with_path(ref_params)[0]]
    got = [(p, tuple(t.shape)) for p, t in
           pt_detectors._leaf_paths(pt_params)]
    assert got == want
    decl = [(p, d.shape) for p, d in pt_detectors._leaf_paths(
        pt_model.decl())]
    assert decl == got
    assert {"tail", "shared"} <= set(pt_params)


def test_segsum_matches_reference():
    x = _rand(np.random.default_rng(0), 2, 3, 8, scale=0.5)
    want = np.asarray(ref_ssm._segsum(jnp.asarray(x)))
    got = to_np(pt_ssm._segsum(torch.from_numpy(x)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(1)
    x, w, b = _rand(rng, 2, 5, 12), _rand(rng, 4, 12), _rand(rng, 12)
    st = _rand(rng, 2, 3, 12) if with_state else None
    want, want_st = ref_ssm._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st))
    got, got_st = pt_ssm._causal_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if st is None else torch.from_numpy(st))
    _close(got, want, atol=1e-6)
    _close(got_st, want_st, rtol=0)


def test_ssd_chunked_matches_reference():
    rng = np.random.default_rng(2)
    B, S, H, Pd, N, Q = 2, 24, 3, 4, 5, 8
    xh, Bm, Cm = _rand(rng, B, S, H, Pd), _rand(rng, B, S, N), \
        _rand(rng, B, S, N)
    dt = np.abs(_rand(rng, B, S, H, scale=0.5))
    A = -np.abs(_rand(rng, H)) - 0.1
    want_y, want_h = ref_ssm._ssd_chunked(*map(jnp.asarray,
                                               (xh, dt, A, Bm, Cm)), Q)
    got_y, got_h = pt_ssm._ssd_chunked(*map(torch.from_numpy,
                                            (xh, dt, A, Bm, Cm)), Q)
    _near(got_y, want_y)
    _near(got_h, want_h)


@pytest.mark.parametrize("S", [16, 13])
def test_apply_mamba_prefill_matches_reference(S):
    """The chunked path at S a chunk multiple (16, chunk 8) and not one
    (13: padded to 16): output and final states."""
    ref_model, ref_params, pt_model, pt_params = _models()
    ref_p, pt_p = _block(ref_params, pt_params)
    x = _rand(np.random.default_rng(3), 2, S, ref_model.cfg.d_model)
    want, want_st = ref_ssm.apply_mamba(ref_p, ref_model.cfg, jnp.asarray(x))
    got, got_st = pt_ssm.apply_mamba(pt_p, pt_model.cfg, torch.from_numpy(x))
    _near(got, want)
    _near(got_st["ssm"], want_st["ssm"])
    _close(got_st["conv"], want_st["conv"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("S", [1, 3])
def test_apply_mamba_decode_matches_reference(S):
    """The recurrence from a nonzero state: output and new states; the
    port writes the new states into the given state in place."""
    ref_model, ref_params, pt_model, pt_params = _models()
    cfg = ref_model.cfg
    ref_p, pt_p = _block(ref_params, pt_params, li=1)
    rng = np.random.default_rng(4)
    st0 = ref_ssm.init_mamba_state(cfg, 2)
    st0 = {k: _rand(rng, *v.shape, scale=0.3) for k, v in st0.items()}
    x = _rand(rng, 2, S, cfg.d_model)
    want, want_st = ref_ssm.apply_mamba(
        ref_p, cfg, jnp.asarray(x),
        state={k: jnp.asarray(v) for k, v in st0.items()})
    state = {k: torch.from_numpy(v.copy()) for k, v in st0.items()}
    got, got_st = pt_ssm.apply_mamba(pt_p, pt_model.cfg, torch.from_numpy(x),
                                     state=state)
    _near(got, want)
    for key in ("ssm", "conv"):
        _near(got_st[key], want_st[key])
        assert got_st[key] is state[key]


def test_chunked_equals_recurrent_in_the_port():
    """The chunked prefill of S tokens against S recurrent steps from the
    zero state: the same outputs and final states."""
    _, ref_params, pt_model, pt_params = _models()
    cfg = pt_model.cfg
    _, pt_p = _block(ref_params, pt_params, li=1)
    x = torch.from_numpy(_rand(np.random.default_rng(5), 2, 19, cfg.d_model))
    y, st = pt_ssm.apply_mamba(pt_p, cfg, x)
    state = pt_ssm.init_mamba_state(cfg, 2, device="cpu")
    ys = []
    for t in range(x.shape[1]):
        yt, state = pt_ssm.apply_mamba(pt_p, cfg, x[:, t:t + 1], state=state)
        ys.append(yt)
    _near(torch.cat(ys, dim=1), to_np(y))
    _near(state["ssm"], to_np(st["ssm"]))
    _close(state["conv"], to_np(st["conv"]), rtol=0, atol=1e-6)


def _batch(vocab, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("S", [16, 21])
def test_forward_loss_and_grads_match_reference(S):
    """The hybrid LM's logits, loss and every gradient leaf, among them
    the shared block's, summed over its uses, and the tail's."""
    ref_model, ref_params, pt_model, pt_params = _models()
    b = _batch(ref_model.cfg.vocab_size, 2, S, seed=S)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    want_logits, _ = ref_model.forward(ref_params, jb["tokens"])
    got_logits, aux = pt_model.forward(pt_params, tb["tokens"])
    _close(got_logits, want_logits, rtol=1e-4, atol=1e-4)
    assert float(aux) == 0.0

    (want_loss, _), want_g = jax.value_and_grad(
        ref_model.loss, has_aux=True)(ref_params, jb)
    live = P.tree_map(lambda t: t.clone().requires_grad_(True), pt_params)
    got_loss, _ = pt_model.loss(live, tb)
    got_g = torch.autograd.grad(got_loss, P.tree_leaves(live))
    _close(got_loss, want_loss, rtol=1e-5)
    it = iter(got_g)
    got_tree = P.tree_map(lambda _: next(it), live)
    want_leaves = dict(pt_detectors._leaf_paths(want_g))
    got_leaves = dict(pt_detectors._leaf_paths(got_tree))
    assert sorted(got_leaves) == sorted(want_leaves)
    for path, w in want_leaves.items():
        w = np.asarray(w)
        _close(got_leaves[path], w, rtol=0, atol=1e-4 * np.abs(w).max())
    assert float(got_tree["shared"]["attn"]["wq"]["w"].abs().max()) > 0
    assert float(got_tree["tail"]["in_proj"]["w"].abs().max()) > 0


def test_decode_token_loop_matches_reference():
    """The greedy one-token step over a dense f32 cache, prompt pushed
    token by token, then greedy decode: the same tokens, and final
    Mamba2 states and shared-block K/V within tolerance."""
    ref_model, ref_params, pt_model, pt_params = _models()
    cfg = ref_model.cfg
    B, plen, gen = 2, 10, 6
    prompts = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, plen)).astype(np.int32)
    ref_cache = ref_model.init_cache(ref_params, B, plen + gen + 1,
                                     kv_dtype=jnp.float32)
    pt_cache = pt_model.init_cache(pt_params, B, plen + gen + 1,
                                   kv_dtype=torch.float32)
    ref_step = jax.jit(ref_serve_step(ref_model))
    pt_step = make_serve_step(pt_model)
    want, got = [], []
    for t in range(plen + gen - 1):
        if t < plen:
            rt = pt_t = prompts[:, t:t + 1]
        else:
            rt, pt_t = want[-1], got[-1]
        rn, ref_cache = ref_step(ref_params, ref_cache, jnp.asarray(rt))
        pn, pt_cache = pt_step(pt_params, pt_cache, torch.from_numpy(
            np.asarray(pt_t)))
        if t >= plen - 1:
            want.append(np.asarray(rn))
            got.append(to_np(pn))
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))
    for part in ("main", "tail"):
        want_l = dict(pt_detectors._leaf_paths(ref_cache[part]))
        for path, g in pt_detectors._leaf_paths(pt_cache[part]):
            _near(g, want_l[path], 1e-4)
    assert int(pt_model.cache_index(pt_cache)) == plen + gen - 1


def test_launch_serve_matches_reference(monkeypatch):
    """``launch.serve.run --arch zamba2-1.2b --smoke --profile`` (the
    token loop) gives the reference driver's greedy tokens on the same
    weights and prompts, with a tier-1 profile; ``--kv paged`` and
    ``--spec on`` raise as in the reference, and the paged cache is
    refused."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve as pt_serve

    ref_model, ref_params, pt_model, pt_params = _models()
    monkeypatch.setattr(pt_registry, "get_config", lambda arch: pt_model.cfg)
    monkeypatch.setattr(pt_lm.LM, "init",
                        lambda self, seed=0, **kw: pt_params)
    # the patched registry gives the 14-layer smoke config itself
    out, merged, stats = pt_serve.run(ZAMBA, batch=4, prompt_len=16, gen=8,
                                      profile=True, device="cpu")
    prompts = jnp.asarray(ref_serve.batch_at(
        ref_model.cfg, 4, 16, seed=0, step=0)["tokens"])
    ref_out = ref_serve._run_legacy(ref_model.cfg, ref_model, ref_params,
                                    prompts, 8, {})[0]
    np.testing.assert_array_equal(out, np.asarray(ref_out))
    assert stats["steps"] == 16 + 8 - 1
    assert stats["prefill_tok_s"] > 0 and stats["decode_tok_s"] > 0
    assert merged.tiers == [1] and stats["tier1_s"] > 0
    for kw, msg in ((dict(kv="paged"), "--kv paged"), (dict(spec=True),
                                                       "--spec")):
        with pytest.raises(ValueError, match=msg):
            pt_serve.run(ZAMBA, device="cpu", **kw)
    with pytest.raises(ValueError, match="'mamba' blocks"):
        pt_model.init_paged_cache(pt_params, 2, 16)
    monkeypatch.undo()
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        pt_serve.run("llama-3.2-vision-90b", smoke=True, device="cpu")
