"""The ssm family of the PyTorch port against the reference, on the CPU:
the xLSTM blocks (``models/xlstm.py``: ``_log_sigmoid``, the chunked and
recurrent mLSTM, ``apply_mlstm``, ``apply_slstm``) and the ssm LM
(xlstm-1.3b's smoke config: 2 superblocks of 7 mLSTM blocks and one
sLSTM block, d_model 64, 4 heads, chunk 8) with the reference's weights
(``from_reference``): forward, loss and every gradient leaf, the cached
decode, the token-loop serving driver, train steps, and the parameter
count.

Tolerances, float32 throughout:
- ``_log_sigmoid`` within 1e-6 relative and 1e-7 absolute (the same
  elementwise f32 formula; exp and log1p of another math library);
- the chunked mLSTM, both blocks and their states within 1e-5 of the
  largest magnitude (f32 einsums contracted in other orders);
- the recurrence chained over S against the chunked form, within 1e-5
  of the largest magnitude (the same sums grouped by chunk);
- logits within 1e-4 and the loss within 1e-5 relative (as the other
  families' tests), gradients within 2e-4 of each leaf's largest
  magnitude: twice the dense families' bound, since the gates' exp
  chains (exp(F - m) in the chunked mLSTM, the sLSTM's exp(logi - m)
  over every token) amplify f32 rounding in the backward; at S 21 one
  element lands at 1.07e-4 of its leaf's largest;
- train-step losses within 1e-5 relative, grad norms within 1e-4
  relative, each step from the reference's state, the updated master
  within 2 lr (see ``test_train_steps_match_reference``);
- greedy tokens, the parameter count, schedules and errors exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.models import xlstm as ref_xl
from repro.models.zoo import count_params_analytic as ref_count
from repro.serve.decode import make_serve_step as ref_serve_step
from repro.train import state as ref_state
from repro.train import step as ref_step
from repro_torch.configs import registry as pt_registry
from repro_torch.configs.base import TrainConfig
from repro_torch.core import detectors as pt_detectors
from repro_torch.data.synthetic import stream
from repro_torch.models import lm as pt_lm
from repro_torch.models import params as P
from repro_torch.models import xlstm as pt_xl
from repro_torch.models.zoo import count_params_analytic as pt_count
from repro_torch.serve.decode import make_serve_step
from repro_torch.train import state as pt_state
from repro_torch.train import step as pt_step

from _torch_parity import smoke_models, to_np

XLSTM = "xlstm-1.3b"


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _near(got, want, frac=1e-5):
    """Within ``frac`` of the reference's largest magnitude."""
    want = np.asarray(want)
    _close(got, want, rtol=0, atol=frac * max(np.abs(want).max(), 1e-30))


def _models():
    return smoke_models(arch=XLSTM)


def _block(ref_params, pt_params, name, li=0):
    """One block's parameters, layer ``li`` of ``name``."""
    ref_p = jax.tree_util.tree_map(lambda a: a[li], ref_params["main"][name])
    pt_p = P.tree_map(lambda t: t[li], pt_params["main"][name])
    return ref_p, pt_p


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


MLSTM_KEYS, SLSTM_KEYS = ("C", "n", "m"), ("h", "c", "n", "m")


def _state_close(got, want, keys):
    """A port state dict against the reference's state tuple."""
    for key, w in zip(keys, want):
        _near(got[key], w)


def test_schedule_and_param_count_match_reference():
    """The ssm schedule (6 superblocks of 7 mLSTM blocks and 1 sLSTM
    block) and xlstm-1.3b's parameter count at full width (2.02 B)."""
    full = pt_registry.get_config(XLSTM)
    sch = pt_lm.make_schedule(full)
    assert sch.pattern == ("mlstm",) * 7 + ("slstm",)
    assert (sch.n_super, sch.tail, sch.has_shared, sch.has_encoder) == \
        (6, (), False, False)
    assert pt_count(full) == ref_count(ref_registry.get_config(XLSTM)) \
        == 2_020_194_640
    # the mLSTM's head width is d_in / H = 4096 / 4 = 1024
    assert pt_xl._mlstm_dims(full) == (4, 4096, 1024)
    assert pt_xl._slstm_dims(full) == (4, 512)


def test_param_tree_loads_one_to_one():
    """``from_reference`` maps the tree 1:1: the port's declaration has
    the reference's paths and shapes."""
    _, ref_params, pt_model, pt_params = _models()
    want = [(jax.tree_util.keystr(k), v.shape) for k, v in
            jax.tree_util.tree_flatten_with_path(ref_params)[0]]
    got = [(p, tuple(t.shape)) for p, t in
           pt_detectors._leaf_paths(pt_params)]
    assert got == want
    decl = [(p, d.shape) for p, d in pt_detectors._leaf_paths(
        pt_model.decl())]
    assert decl == got


def test_log_sigmoid_matches_reference():
    """Across large inputs of both signs (where a naive form over- or
    underflows), zero and a random spread; the gradient too."""
    x = np.concatenate([
        np.array([-1e30, -1e4, -100.0, -30.0, -1.0, 0.0, 1.0, 30.0, 100.0,
                  1e4, 1e30], np.float32),
        _rand(np.random.default_rng(0), 64, scale=10.0)])
    want = np.asarray(ref_xl._log_sigmoid(jnp.asarray(x)))
    got = pt_xl._log_sigmoid(torch.from_numpy(x))
    _close(got, want, rtol=1e-6, atol=1e-7)
    assert np.isfinite(to_np(got)).all()
    want_g = np.asarray(jax.grad(lambda a: ref_xl._log_sigmoid(a).sum())(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got_g, = torch.autograd.grad(pt_xl._log_sigmoid(xt).sum(), xt)
    _close(got_g, want_g, rtol=1e-6, atol=1e-7)


def _gates(rng, B, S, H):
    """Log forget gates (log sigmoid of a spread) and log input gates."""
    logf = np.asarray(ref_xl._log_sigmoid(jnp.asarray(
        _rand(rng, B, S, H, scale=2.0) + 2.0)))
    return logf, _rand(rng, B, S, H)


@pytest.mark.parametrize("S,chunk", [(24, 8), (16, 16)])
def test_mlstm_chunked_matches_reference(S, chunk):
    """``_mlstm_chunked`` at S a chunk multiple: h and the final (C, n,
    m)."""
    rng = np.random.default_rng(1)
    B, H, D = 2, 3, 8
    q, k, v = (_rand(rng, B, S, H, D) for _ in range(3))
    logf, logi = _gates(rng, B, S, H)
    want_h, want_st = ref_xl._mlstm_chunked(
        *map(jnp.asarray, (q, k, v, logf, logi)), chunk)
    got_h, got_st = pt_xl._mlstm_chunked(
        *map(torch.from_numpy, (q, k, v, logf, logi)), chunk)
    _near(got_h, want_h)
    _state_close(got_st, want_st, MLSTM_KEYS)


def test_mlstm_recurrence_chained_equals_chunked():
    """The recurrent step chained over S tokens from the zero state
    against the chunked form (both in the port, and the chain against the
    reference's chain), k scaled by 1/sqrt(D) as ``apply_mlstm`` scales
    it; the step writes its state in place."""
    rng = np.random.default_rng(2)
    B, S, H, D = 2, 16, 2, 8
    q, k, v = (_rand(rng, B, S, H, D) for _ in range(3))
    logf, logi = _gates(rng, B, S, H)
    h, st = pt_xl._mlstm_chunked(*map(torch.from_numpy,
                                      (q, k, v, logf, logi)), 8)
    state = {"C": torch.zeros(B, H, D, D), "n": torch.zeros(B, H, D),
             "m": torch.full((B, H), -1e30)}
    held = dict(state)
    ref_st = (jnp.zeros((B, H, D, D)), jnp.zeros((B, H, D)),
              jnp.full((B, H), -1e30))
    ks = k / np.float32(np.sqrt(D))
    for t in range(S):
        got = pt_xl._mlstm_recurrent_step(
            *(torch.from_numpy(a[:, t].copy())
              for a in (q, ks, v, logf, logi)), state)
        want, ref_st = ref_xl._mlstm_recurrent_step(
            *(jnp.asarray(a[:, t]) for a in (q, ks, v, logf, logi)), ref_st)
        _near(got, want)
        _near(got, to_np(h[:, t]))
    assert all(state[key] is held[key] for key in MLSTM_KEYS)
    _state_close(state, ref_st, MLSTM_KEYS)
    for key in ("C", "n"):
        # the chunked state is stabilised by another running max: the
        # same state scaled by exp(m_chunked - m_chain)
        scale = torch.exp(st["m"] - state["m"])
        want = st[key] * scale.reshape(scale.shape + (1,) * (st[key].ndim - 2))
        _near(state[key], to_np(want))


@pytest.mark.parametrize("S", [16, 13])
def test_apply_mlstm_prefill_matches_reference(S):
    """The chunked path at S a chunk multiple (16, chunk 8) and not one
    (13: padded to 16, the tail's input gates at -1e30): output and
    final state."""
    ref_model, ref_params, pt_model, pt_params = _models()
    ref_p, pt_p = _block(ref_params, pt_params, "b0_mlstm")
    x = _rand(np.random.default_rng(3), 2, S, ref_model.cfg.d_model)
    want, want_st = ref_xl.apply_mlstm(ref_p, ref_model.cfg, jnp.asarray(x))
    got, got_st = pt_xl.apply_mlstm(pt_p, pt_model.cfg, torch.from_numpy(x))
    _near(got, want)
    _state_close(got_st, want_st, MLSTM_KEYS)


def _state0(rng, init, keys, scale=0.3):
    """A nonzero state of the reference's structure: the reference's
    initial state moved by noise (m kept as drawn, so C and n are
    stabilised against it)."""
    return [np.asarray(a) + _rand(rng, *a.shape, scale=scale) for a in init]


@pytest.mark.parametrize("S", [1, 3])
def test_apply_mlstm_decode_matches_reference(S):
    """The recurrence from a nonzero state: output and new state,
    written into the given state in place."""
    ref_model, ref_params, pt_model, pt_params = _models()
    cfg = ref_model.cfg
    ref_p, pt_p = _block(ref_params, pt_params, "b3_mlstm", li=1)
    rng = np.random.default_rng(4)
    st0 = _state0(rng, ref_xl.init_mlstm_state(cfg, 2), MLSTM_KEYS)
    st0[2] = _rand(rng, 2, cfg.num_heads)                     # m
    x = _rand(rng, 2, S, cfg.d_model)
    want, want_st = ref_xl.apply_mlstm(
        ref_p, cfg, jnp.asarray(x), state=tuple(map(jnp.asarray, st0)))
    state = {key: torch.from_numpy(a.copy())
             for key, a in zip(MLSTM_KEYS, st0)}
    held = dict(state)
    got, got_st = pt_xl.apply_mlstm(pt_p, pt_model.cfg, torch.from_numpy(x),
                                    state=state)
    _near(got, want)
    _state_close(got_st, want_st, MLSTM_KEYS)
    assert all(got_st[key] is held[key] for key in MLSTM_KEYS)


@pytest.mark.parametrize("S,with_state", [(13, False), (3, True)])
def test_apply_slstm_matches_reference(S, with_state):
    """The sLSTM over S tokens from its initial state and from a nonzero
    state (written in place): output and final (h, c, n, m)."""
    ref_model, ref_params, pt_model, pt_params = _models()
    cfg = ref_model.cfg
    ref_p, pt_p = _block(ref_params, pt_params, "b7_slstm", li=1)
    rng = np.random.default_rng(5)
    x = _rand(rng, 2, S, cfg.d_model)
    ref_kw, state = {}, None
    if with_state:
        st0 = _state0(rng, ref_xl.init_slstm_state(cfg, 2), SLSTM_KEYS)
        st0[2] = np.abs(st0[2]) + 0.5                         # n > 0
        ref_kw["state"] = tuple(map(jnp.asarray, st0))
        state = {key: torch.from_numpy(a.copy())
                 for key, a in zip(SLSTM_KEYS, st0)}
    want, want_st = ref_xl.apply_slstm(ref_p, cfg, jnp.asarray(x), **ref_kw)
    got, got_st = pt_xl.apply_slstm(pt_p, pt_model.cfg, torch.from_numpy(x),
                                    state=state)
    _near(got, want)
    _state_close(got_st, want_st, SLSTM_KEYS)
    if with_state:
        assert got_st is state


def _batch(vocab, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("S", [16, 21])
def test_forward_loss_and_grads_match_reference(S):
    """The ssm LM's logits, loss and every gradient leaf, at S a chunk
    multiple and not one."""
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
        _close(got_leaves[path], w, rtol=0, atol=2e-4 * np.abs(w).max())
    for name, leaf in (("b0_mlstm", "wq"), ("b7_slstm", "r_f")):
        assert float(got_tree["main"][name][leaf].abs().max()) > 0


def test_decode_token_loop_matches_reference():
    """The greedy one-token step over the recurrent states, prompt pushed
    token by token, then greedy decode: the same tokens, and the final
    mLSTM and sLSTM states within tolerance."""
    ref_model, ref_params, pt_model, pt_params = _models()
    cfg = ref_model.cfg
    B, plen, gen = 2, 10, 6
    prompts = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, plen)).astype(np.int32)
    ref_cache = ref_model.init_cache(ref_params, B, plen + gen + 1,
                                     kv_dtype=jnp.float32)
    pt_cache = pt_model.init_cache(pt_params, B, plen + gen + 1,
                                   kv_dtype=torch.float32)
    held = {name: dict(sub) for name, sub in pt_cache["main"].items()}
    ref_step_fn = jax.jit(ref_serve_step(ref_model))
    pt_step_fn = make_serve_step(pt_model)
    want, got = [], []
    for t in range(plen + gen - 1):
        if t < plen:
            rt = pt_t = prompts[:, t:t + 1]
        else:
            rt, pt_t = want[-1], got[-1]
        rn, ref_cache = ref_step_fn(ref_params, ref_cache, jnp.asarray(rt))
        pn, pt_cache = pt_step_fn(pt_params, pt_cache, torch.from_numpy(
            np.asarray(pt_t)))
        if t >= plen - 1:
            want.append(np.asarray(rn))
            got.append(to_np(pn))
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))
    for name, sub in pt_cache["main"].items():
        keys = MLSTM_KEYS if name.endswith("mlstm") else SLSTM_KEYS
        for key, w in zip(keys, ref_cache["main"][name]):
            _near(sub[key], w, 1e-4)
            # the states are written in place
            assert sub[key] is held[name][key]


def test_launch_serve_matches_reference(monkeypatch):
    """``launch.serve.run --arch xlstm-1.3b --smoke --profile`` (the
    token loop) gives the reference driver's greedy tokens on the same
    weights and prompts, with a tier-1 profile; ``--kv paged`` and
    ``--spec on`` raise as in the reference."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve as pt_serve

    ref_model, ref_params, pt_model, pt_params = _models()
    # the patched registry gives the f32 smoke config itself
    monkeypatch.setattr(pt_registry, "get_config", lambda arch: pt_model.cfg)
    monkeypatch.setattr(pt_lm.LM, "init",
                        lambda self, seed=0, **kw: pt_params)
    out, merged, stats = pt_serve.run(XLSTM, batch=4, prompt_len=16, gen=8,
                                      profile=True, device="cpu")
    prompts = jnp.asarray(ref_serve.batch_at(
        ref_model.cfg, 4, 16, seed=0, step=0)["tokens"])
    ref_out = ref_serve._run_legacy(ref_model.cfg, ref_model, ref_params,
                                    prompts, 8, {})[0]
    np.testing.assert_array_equal(out, np.asarray(ref_out))
    assert stats["steps"] == 16 + 8 - 1
    assert stats["prefill_tok_s"] > 0 and stats["decode_tok_s"] > 0
    assert merged.tiers == [1, 2] and stats["tier1_s"] > 0
    assert merged.total_store_events > 0
    for kw, msg in ((dict(kv="paged"), "--kv paged"), (dict(spec=True),
                                                       "--spec")):
        with pytest.raises(ValueError, match=msg):
            pt_serve.run(XLSTM, device="cpu", **kw)
    with pytest.raises(ValueError, match="'mlstm' blocks"):
        pt_model.init_paged_cache(pt_params, 2, 16)


def test_train_steps_match_reference():
    """3 steps of the reference's jitted step and the port's step, each
    from the reference's state of that step (carried over by
    ``train.state.from_reference``), on the same stream batches: losses
    and grad norms, and the updated master within 2 lr of the
    reference's. Each step starts from the reference's state because a
    free run drifts: Adam's first steps move every parameter by about
    +-lr whatever its gradient's size, so a near-zero gradient whose sign
    differs between the frameworks moves its parameter the other way
    (ROADMAP § C), and xLSTM's exponential gates carry that to 0.45% of
    the grad norm by the third step while each step, from one state,
    agrees within 1e-5."""
    steps, lr = 3, 3e-4
    ref_model, _, pt_model, _ = _models()
    kw = dict(learning_rate=lr, total_steps=steps, warmup_steps=1,
              remat="none")
    ref_fn = jax.jit(ref_step.make_train_step(ref_model, RefTrainConfig(**kw)))
    pt_fn = pt_step.make_train_step(pt_model, TrainConfig(**kw))
    rs = ref_state.create(ref_model, jax.random.PRNGKey(0),
                          compute_dtype=jnp.float32)
    data = stream(pt_model.cfg, 4, 32, seed=0)
    for step in range(steps):
        b = next(data)
        ps = pt_state.from_reference(jax.device_get(rs), device="cpu")
        rs, rm = ref_fn(rs, {k: jnp.asarray(v) for k, v in b.items()})
        ps, pm = pt_fn(ps, {k: torch.from_numpy(v) for k, v in b.items()})
        for key in ("loss", "nll"):
            _close(pm[key], rm[key], rtol=1e-5)
        _close(pm["grad_norm"], rm["grad_norm"], rtol=1e-4)
        _close(pm["lr"], rm["lr"])
        want_master = dict(pt_detectors._leaf_paths(rs.master))
        for path, got in pt_detectors._leaf_paths(ps.master):
            _close(got, want_master[path], rtol=0,
                   atol=2 * float(rm["lr"]) + 1e-7)
    assert int(ps.step) == int(rs.step) == steps


def test_train_driver_profiles_on_cpu():
    """``launch.train.run --arch xlstm-1.3b --smoke --profile`` trains on
    the CPU: finite losses and a tier-3 training profile."""
    from repro_torch.launch import train as pt_train
    losses, merged = pt_train.run(XLSTM, smoke=True, steps=2, batch=2,
                                  seq=16, profile=True, device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert merged.tiers == [3]
    assert merged.checked["silent_data_load"] == 2 * 2
