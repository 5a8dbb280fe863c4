"""The audio family of the PyTorch port against the reference, on the
CPU: ``data/synthetic.frame_lengths``, cross- and length-masked
attention (``layers.apply_attention(kv_src=, kv_valid=)``), the encoder
(``LM.encode``), the cross-K/V precompute (``init_cache`` with frames and
frame lengths), ``decode_params``, and the enc-dec LM (whisper-large-v3's
smoke config: 2 encoder and 2 decoder layers, d_model 64, 4 heads, 16
frames) with the reference's weights (``from_reference``): loss and
every gradient leaf, the cached decode, and the token-loop serving
driver with its encoder-frames accounting, bucketed and at capacity.

Tolerances, float32 throughout:
- attention and encoder outputs, cross K/V within 1e-5 of the largest
  magnitude (f32 products in other summation orders);
- logits within 1e-4 and the loss within 1e-5 relative, gradients within
  1e-4 of each leaf's largest magnitude (as the other families' tests);
- encoder rows below each true length, bucketed against capacity,
  within 1e-6 of the largest magnitude (see
  ``test_encoder_rows_independent_of_extent``);
- frame lengths, greedy tokens, encoder-frames stats, the padding
  finding, parameter counts, key sets and schedules exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.data import synthetic as ref_synth
from repro.launch import serve as ref_serve
from repro.models import layers as ref_layers
from repro.models.zoo import count_params_analytic as ref_count
from repro.serve.decode import make_serve_step as ref_serve_step
from repro_torch.configs import registry as pt_registry
from repro_torch.core import detectors as pt_detectors
from repro_torch.data import synthetic as pt_synth
from repro_torch.launch import serve as pt_serve
from repro_torch.models import layers as pt_layers
from repro_torch.models import lm as pt_lm
from repro_torch.models import params as P
from repro_torch.models.zoo import count_params_analytic as pt_count
from repro_torch.serve.decode import make_serve_step

from _torch_parity import smoke_models, to_np

WHISPER = "whisper-large-v3"


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _near(got, want, frac=1e-5):
    """Within ``frac`` of the reference's largest magnitude."""
    want = np.asarray(want)
    _close(got, want, rtol=0, atol=frac * max(np.abs(want).max(), 1e-30))


def _models():
    return smoke_models(arch=WHISPER)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_schedule_and_param_count_match_reference():
    """The audio schedule (32 encdec blocks after a 32-block encoder) and
    whisper-large-v3's parameter count at full width (1.60 B)."""
    full = pt_registry.get_config(WHISPER)
    sch = pt_lm.make_schedule(full)
    assert sch.pattern == ("encdec",)
    assert (sch.n_super, sch.tail, sch.has_shared, sch.has_encoder) == \
        (32, (), False, True)
    assert pt_count(full) == ref_count(ref_registry.get_config(WHISPER)) \
        == 1_601_251_840


def test_param_tree_loads_one_to_one():
    """``from_reference`` maps ``enc`` and ``main`` 1:1: the port's
    declaration has the reference's paths and shapes."""
    _, ref_params, pt_model, pt_params = _models()
    want = [(jax.tree_util.keystr(k), v.shape) for k, v in
            jax.tree_util.tree_flatten_with_path(ref_params)[0]]
    got = [(p, tuple(t.shape)) for p, t in
           pt_detectors._leaf_paths(pt_params)]
    assert got == want
    decl = [(p, d.shape) for p, d in pt_detectors._leaf_paths(
        pt_model.decl())]
    assert decl == got
    assert set(pt_params["enc"]) == {"blocks", "norm"}


@pytest.mark.parametrize("smoke", [False, True])
def test_frame_lengths_equal_reference(smoke):
    """The seeded true frame counts, equal exactly for several seeds,
    steps and batch sizes, at full width (1500 frames) and smoke (16)."""
    ref_cfg = ref_registry.get_config(WHISPER)
    pt_cfg = pt_registry.get_config(WHISPER)
    if smoke:
        ref_cfg, pt_cfg = ref_cfg.smoke(), pt_cfg.smoke()
    for seed, step, batch in ((0, 0, 8), (1, 0, 4), (0, 3, 5), (7, 2, 1)):
        want = ref_synth.frame_lengths(ref_cfg, batch, seed=seed, step=step)
        got = pt_synth.frame_lengths(pt_cfg, batch, seed=seed, step=step)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    F = pt_cfg.encoder_frames
    got = pt_synth.frame_lengths(pt_cfg, 64, seed=0)
    assert got.min() >= max(1, F // 8) and got.max() <= F // 2


def _attn_case(rng, cfg, B=2, S=5, Skv=7):
    x = _rand(rng, B, S, cfg.d_model)
    src = _rand(rng, B, Skv, cfg.d_model)
    lens = np.array([3, Skv], np.int32)[:B]
    valid = np.arange(Skv)[None, :] < lens[:, None]
    return x, src, valid


@pytest.mark.parametrize("case", ["cross", "cross-masked", "self-masked",
                                  "self-noncausal"])
def test_apply_attention_matches_reference(case):
    """Cross-attention (queries from x, K/V from a source of another
    length, no RoPE, never causal), with and without a key-validity mask,
    and non-causal self-attention with RoPE (the encoder's), masked and
    not."""
    ref_model, ref_params, pt_model, pt_params = _models()
    cfg = ref_model.cfg
    name = "xattn" if case.startswith("cross") else "attn"
    ref_p = jax.tree_util.tree_map(
        lambda a: a[0], ref_params["main"]["b0_encdec"][name])
    pt_p = P.tree_map(lambda t: t[0], pt_params["main"]["b0_encdec"][name])
    x, src, valid = _attn_case(np.random.default_rng(1), cfg)
    kw = {}
    if case.startswith("cross"):
        kw = dict(causal=False, use_rope=False)
        ref_kw = {**kw, "kv_src": jnp.asarray(src)}
        pt_kw = {**kw, "kv_src": torch.from_numpy(src)}
    else:
        x = src                                   # Sq == Skv
        ref_kw = pt_kw = dict(causal=False)
    if case.endswith("masked"):
        ref_kw = {**ref_kw, "kv_valid": jnp.asarray(valid)}
        pt_kw = {**pt_kw, "kv_valid": torch.from_numpy(valid)}
    want, _ = ref_layers.apply_attention(ref_p, cfg, jnp.asarray(x),
                                         **ref_kw)
    got, cache = pt_layers.apply_attention(pt_p, pt_model.cfg,
                                           torch.from_numpy(x), **pt_kw)
    assert cache is None
    _near(got, want)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_encode_matches_reference(with_lengths):
    """The encoder over right-padded frames, with and without the true
    lengths (without them every frame is a key)."""
    ref_model, ref_params, pt_model, pt_params = _models()
    rng = np.random.default_rng(2)
    frames = _rand(rng, 3, 12, ref_model.cfg.d_model)
    lens = np.array([5, 12, 1], np.int32)
    frames[np.arange(12)[None, :] >= lens[:, None]] = 0.0
    ref_kw, pt_kw = {}, {}
    if with_lengths:
        ref_kw = {"frame_lengths": jnp.asarray(lens)}
        pt_kw = {"frame_lengths": torch.from_numpy(lens)}
    want = ref_model.encode(ref_params, jnp.asarray(frames), **ref_kw)
    got = pt_model.encode(pt_params, torch.from_numpy(frames), **pt_kw)
    _near(got, want)


def test_encoder_rows_independent_of_extent():
    """Rows below each true length are the same whether the frames are
    padded to capacity or cut to the bucket, within 1e-6 of the largest
    magnitude: masked keys add exact zeros, but the plain composition's
    reductions over the keys (torch's CPU softmax and matmul) are blocked
    by the extent, so the low bits may move (the reference's XLA CPU
    keeps them; ROADMAP § C). Greedy tokens stay equal
    (``test_launch_serve_matches_reference``)."""
    _, _, pt_model, pt_params = _models()
    cfg = pt_model.cfg
    rng = np.random.default_rng(3)
    cap, lens = cfg.encoder_frames, np.array([3, 8, 5], np.int32)
    frames = _rand(rng, 3, cap, cfg.d_model)
    frames[np.arange(cap)[None, :] >= lens[:, None]] = 0.0
    full = pt_model.encode(pt_params, torch.from_numpy(frames),
                           torch.from_numpy(lens))
    cut = pt_model.encode(pt_params, torch.from_numpy(frames[:, :8].copy()),
                          torch.from_numpy(lens))
    scale = float(full.abs().max())
    for b, n in enumerate(lens):
        _close(cut[b, :n], to_np(full[b, :n]), rtol=0, atol=1e-6 * scale)


def test_fill_cross_kv_matches_reference():
    """``init_cache`` with frames and lengths: every layer's ``xk``/``xv``
    from the encoder's output and the ``xvalid`` mask; without frames
    the cross K/V are zeros of the capacity extent."""
    ref_model, ref_params, pt_model, pt_params = _models()
    cfg = ref_model.cfg
    rng = np.random.default_rng(4)
    frames = _rand(rng, 2, 8, cfg.d_model)
    lens = np.array([6, 3], np.int32)
    frames[np.arange(8)[None, :] >= lens[:, None]] = 0.0
    want = ref_model.init_cache(ref_params, 2, 12, kv_dtype=jnp.float32,
                                frames=jnp.asarray(frames),
                                frame_lengths=jnp.asarray(lens))
    got = pt_model.init_cache(pt_params, 2, 12, kv_dtype=torch.float32,
                              frames=torch.from_numpy(frames),
                              frame_lengths=torch.from_numpy(lens))
    w, g = want["main"]["b0_encdec"], got["main"]["b0_encdec"]
    assert sorted(g) == sorted(w)
    for key in ("xk", "xv"):
        assert g[key].shape == w[key].shape == (cfg.num_layers, 2, 8,
                                                cfg.num_kv_heads,
                                                cfg.head_dim)
        assert g[key].dtype == torch.float32
        _near(g[key], w[key])
    np.testing.assert_array_equal(to_np(g["xvalid"]), np.asarray(w["xvalid"]))
    for key in ("k", "v", "idx"):
        np.testing.assert_array_equal(to_np(g[key]), np.asarray(w[key]))
    bare = pt_model.init_cache(pt_params, 2, 12, kv_dtype=torch.float32)
    sub = bare["main"]["b0_encdec"]
    assert "xvalid" not in sub
    assert sub["xk"].shape[2] == cfg.encoder_frames
    assert not sub["xk"].any() and not sub["xv"].any()


def test_decode_params_key_set_matches_reference():
    """The decode-path view drops ``enc`` and each cross-attention's
    ``wk``/``wv`` (and ``k_norm``), as the reference's does."""
    ref_model, ref_params, pt_model, pt_params = _models()
    want = [jax.tree_util.keystr(k) for k, _ in
            jax.tree_util.tree_flatten_with_path(
                ref_model.decode_params(ref_params))[0]]
    got = [p for p, _ in pt_detectors._leaf_paths(
        pt_model.decode_params(pt_params))]
    assert got == want
    assert "enc" not in pt_model.decode_params(pt_params)
    assert "enc" in pt_params                     # the input is untouched
    for cfg_arch in ("qwen3-1.7b", "xlstm-1.3b"):
        model = pt_lm.LM(pt_registry.get_config(cfg_arch).smoke())
        params = {"embed": 1}
        assert model.decode_params(params) is params


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    frames = _rand(rng, B, min(S, cfg.encoder_frames), cfg.d_model)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "frames": frames}


@pytest.mark.parametrize("S", [16, 11])
def test_forward_loss_and_grads_match_reference(S):
    """The enc-dec LM's logits, loss and every gradient leaf (the
    encoder's among them), with frames of the tokens' length (16) and of
    another (11 tokens, 11 frames; and the loss at 16 frames over 11
    tokens through ``loss``)."""
    ref_model, ref_params, pt_model, pt_params = _models()
    b = _batch(ref_model.cfg, 2, S, seed=S)
    if S == 11:
        b["frames"] = _rand(np.random.default_rng(9), 2, 16,
                            ref_model.cfg.d_model)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    want_logits, _ = ref_model.forward(ref_params, jb["tokens"],
                                       frames=jb["frames"])
    got_logits, aux = pt_model.forward(pt_params, tb["tokens"],
                                       frames=tb["frames"])
    _close(got_logits, want_logits, rtol=1e-4, atol=1e-4)
    assert float(aux) == 0.0
    with pytest.raises(ValueError, match="frame embeddings"):
        pt_model.forward(pt_params, tb["tokens"])

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
    for leaf in (got_tree["enc"]["blocks"]["attn"]["wq"]["w"],
                 got_tree["main"]["b0_encdec"]["xattn"]["wk"]["w"]):
        assert float(leaf.abs().max()) > 0


def test_decode_token_loop_matches_reference():
    """The greedy one-token step over a dense f32 cache with the cross
    K/V of length-masked frames, prompt pushed token by token, then
    greedy decode (the decode-path params): the same tokens."""
    ref_model, ref_params, pt_model, pt_params = _models()
    cfg = ref_model.cfg
    B, plen, gen = 2, 10, 6
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, cfg.vocab_size, (B, plen)).astype(np.int32)
    frames = _rand(rng, B, 8, cfg.d_model)
    lens = np.array([8, 5], np.int32)
    frames[np.arange(8)[None, :] >= lens[:, None]] = 0.0
    ref_cache = ref_model.init_cache(ref_params, B, plen + gen + 1,
                                     kv_dtype=jnp.float32,
                                     frames=jnp.asarray(frames),
                                     frame_lengths=jnp.asarray(lens))
    pt_cache = pt_model.init_cache(pt_params, B, plen + gen + 1,
                                   kv_dtype=torch.float32,
                                   frames=torch.from_numpy(frames),
                                   frame_lengths=torch.from_numpy(lens))
    rp, pp = ref_model.decode_params(ref_params), \
        pt_model.decode_params(pt_params)
    ref_step_fn = jax.jit(ref_serve_step(ref_model))
    pt_step_fn = make_serve_step(pt_model)
    want, got = [], []
    for t in range(plen + gen - 1):
        if t < plen:
            rt = pt_t = prompts[:, t:t + 1]
        else:
            rt, pt_t = want[-1], got[-1]
        rn, ref_cache = ref_step_fn(rp, ref_cache, jnp.asarray(rt))
        pn, pt_cache = pt_step_fn(pp, pt_cache,
                                  torch.from_numpy(np.asarray(pt_t)))
        if t >= plen - 1:
            want.append(np.asarray(rn))
            got.append(to_np(pn))
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))
    w, g = ref_cache["main"]["b0_encdec"], pt_cache["main"]["b0_encdec"]
    for key in ("k", "v"):
        _near(g[key], w[key], 1e-4)
    assert int(pt_model.cache_index(pt_cache)) == plen + gen - 1


def _finding(prof):
    return (dict(prof.checked), dict(prof.flagged),
            [(f.kind, f.tier, tuple(f.c1), tuple(f.c2), f.count, f.bytes,
              f.fraction, dict(f.meta)) for f in prof.findings])


@pytest.mark.parametrize("bucket", [True, False])
def test_launch_serve_matches_reference(bucket, monkeypatch):
    """``launch.serve.run --arch whisper-large-v3 --smoke --profile`` (the
    token loop over the seeded frames, bucketed or at capacity) gives the
    reference driver's greedy tokens on the same weights, prompts and
    frames, its encoder-frames stats and its padding finding; bucketed and
    capacity tokens are equal."""
    ref_model, ref_params, pt_model, pt_params = _models()
    monkeypatch.setattr(pt_registry, "get_config", lambda arch: pt_model.cfg)
    monkeypatch.setattr(pt_lm.LM, "init",
                        lambda self, seed=0, **kw: pt_params)
    B, plen, gen = 4, 16, 8
    runs = {}
    for b in (bucket, not bucket):
        runs[b] = pt_serve.run(WHISPER, batch=B, prompt_len=plen, gen=gen,
                               profile=b == bucket, bucket_frames=b,
                               device="cpu")
    out, merged, stats = runs[bucket]
    np.testing.assert_array_equal(runs[not bucket][0], out)

    data = ref_serve.batch_at(ref_model.cfg, B, plen, seed=0, step=0)
    lens = ref_synth.frame_lengths(ref_model.cfg, B, seed=0)
    ref_out, _, _, _, ref_stats = ref_serve._run_legacy(
        ref_model.cfg, ref_model, ref_params, jnp.asarray(data["tokens"]),
        gen, {"frames": jnp.asarray(data["frames"])}, frame_lengths=lens,
        bucket_frames=bucket)
    np.testing.assert_array_equal(out, np.asarray(ref_out))
    assert {k: stats[k] for k in ref_stats} == ref_stats
    assert stats["frames_run"] == (8 if bucket else 16)
    assert stats["padded_frames"] > 0
    assert merged.tiers == [1, 2] and stats["tier1_s"] > 0
    prof = pt_serve.encoder_padding_profile(stats)
    assert _finding(prof) == _finding(
        ref_serve.encoder_padding_profile(ref_stats))
    assert merged.flagged["prefill_padding"] == stats["padded_frames"]


def test_bucket_pow2_and_prep_frames_match_reference():
    """``_bucket_pow2`` over lengths and caps, and ``_prep_frames``' zeroed
    rows, extent and stats, against the reference's."""
    for n in (1, 7, 8, 9, 100, 750, 1024, 1500):
        for cap in (16, 1500):
            assert pt_serve._bucket_pow2(n, cap) == \
                ref_serve._bucket_pow2(n, cap)
    ref_model, _, pt_model, _ = _models()
    cfg = pt_model.cfg
    frames = _rand(np.random.default_rng(7), 3, 16, cfg.d_model)
    lens = np.array([2, 40, 7], np.int32)
    for bucket in (True, False):
        got, got_lens, stats = pt_serve._prep_frames(cfg, pt_model, frames,
                                                     lens, bucket)
        kw, want_stats = ref_serve._prep_frames(
            ref_model.cfg, ref_model, {"frames": jnp.asarray(frames)}, lens,
            bucket)
        np.testing.assert_array_equal(got, np.asarray(kw["frames"]))
        np.testing.assert_array_equal(got_lens,
                                      np.asarray(kw["frame_lengths"]))
        assert stats == want_stats


def test_train_driver_profiles_on_cpu():
    """``launch.train.run --arch whisper-large-v3 --smoke --profile``
    trains on the CPU with the frames in the batch (2 microbatches split
    them with the tokens): finite losses and a tier-3 profile that
    digests the frames too."""
    from repro_torch.launch import train as pt_train
    losses, merged = pt_train.run(WHISPER, smoke=True, steps=2, batch=2,
                                  seq=16, profile=True, microbatches=2,
                                  device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert merged.tiers == [3]
    # tokens, labels and frames, each step
    assert merged.checked["silent_data_load"] == 3 * 2


def test_microbatched_loss_matches_whole_batch():
    """A train step with 2 microbatches gives the whole batch's loss
    gradient (frames split with the tokens): grad norm within 1e-5
    relative of 1 microbatch's."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train import state as pt_state
    from repro_torch.train import step as pt_step
    _, _, pt_model, _ = _models()
    b = next(pt_synth.stream(pt_model.cfg, 4, 16, seed=0))
    norms = []
    for k in (1, 2):
        s0 = pt_state.create(pt_model, 0, compute_dtype=torch.float32,
                             device="cpu")
        fn = pt_step.make_train_step(pt_model, TrainConfig(
            learning_rate=3e-4, total_steps=2, warmup_steps=1,
            microbatches=k))
        _, m = fn(s0, {key: torch.from_numpy(v) for key, v in b.items()})
        norms.append(float(m["grad_norm"]))
    np.testing.assert_allclose(norms[1], norms[0], rtol=1e-5)
