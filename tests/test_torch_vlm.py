"""The vlm family of the PyTorch port against the reference, on the CPU:
the schedule and parameter counts of llama-3.2-vision-90b, the gated
cross-attention block (``layers.apply_xattn_block``), the cross-K/V
precompute from the image tokens (``init_cache(img=)``),
``decode_params``, and the vlm LM (the smoke config: 10 layers in 2
periods of 4 dense blocks and 1 cross-attention block, d_model 64, 4
heads, 8 image tokens) with the reference's weights (``from_reference``):
forward, loss and every gradient leaf, the cached decode, the token-loop
serving driver, microbatches and the train driver.

The reference initialises both gates of a cross-attention block to zero,
so on ``init``'s weights the image reaches no logit and no gradient of
the cross path. Every comparison that involves the cross path first sets
the gates to seeded non-zero values (``_models``).

Tolerances, float32 throughout:
- block outputs and cross K/V within 1e-5 of the largest magnitude (f32
  products in other summation orders);
- logits within 1e-4 and the loss within 1e-5 relative, gradients within
  1e-4 of each leaf's largest magnitude (as the other families' tests);
- greedy tokens, parameter counts, key sets and schedules exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.launch import serve as ref_serve
from repro.models import layers as ref_layers
from repro.models.zoo import build_model as ref_build
from repro.models.zoo import count_params_analytic as ref_count
from repro.serve.decode import make_serve_step as ref_serve_step
from repro_torch.configs import registry as pt_registry
from repro_torch.core import detectors as pt_detectors
from repro_torch.data import synthetic as pt_synth
from repro_torch.launch import serve as pt_serve
from repro_torch.models import layers as pt_layers
from repro_torch.models import lm as pt_lm
from repro_torch.models import params as P
from repro_torch.models.zoo import build_model as pt_build
from repro_torch.models.zoo import count_params_analytic as pt_count
from repro_torch.serve.decode import make_serve_step

from _torch_parity import smoke_configs, to_np

VLM = "llama-3.2-vision-90b"
XBLOCK = "b4_xattn"
GATES = ("gate_attn", "gate_mlp")


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _near(got, want, frac=1e-5):
    """Within ``frac`` of the reference's largest magnitude."""
    want = np.asarray(want)
    _close(got, want, rtol=0, atol=frac * max(np.abs(want).max(), 1e-30))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _set_gates(host, seed=11):
    """``host`` (a parameter tree of numpy arrays) with every xattn
    block's two gates set to seeded values of either sign, |g| in [0.3,
    1.2] (tanh 0.29-0.83), in place."""
    rng = np.random.default_rng(seed)
    for name, blk in host["main"].items():
        if name.endswith("_xattn"):
            for g in GATES:
                n = blk[g].shape
                blk[g] = (rng.uniform(0.3, 1.2, n)
                          * rng.choice([-1.0, 1.0], n)).astype(blk[g].dtype)
    return host


def _models(gates=True):
    """(ref model, ref params, port model, port params): the smoke model
    in float32 with the reference's init, its gates set non-zero
    (``_set_gates``) unless ``gates`` is False."""
    ref_cfg, pt_cfg = smoke_configs(arch=VLM)
    ref_model = ref_build(ref_cfg)
    host = jax.device_get(ref_model.init(jax.random.PRNGKey(0)))
    host = jax.tree_util.tree_map(np.array, host)
    if gates:
        _set_gates(host)
    ref_params = jax.tree_util.tree_map(jnp.asarray, host)
    return ref_model, ref_params, pt_build(pt_cfg), \
        P.from_reference(host, device="cpu")


def test_schedule_and_param_count_match_reference():
    """The vlm schedule (20 periods of 4 dense blocks and one
    cross-attention block), llama-3.2-vision-90b's parameter count at full
    width (87.7 B), at one period of it (the card's serving and training
    depth) and at the smoke config's; a period that does not divide the
    layers raises."""
    import dataclasses
    full = pt_registry.get_config(VLM)
    sch = pt_lm.make_schedule(full)
    assert sch.pattern == ("dense",) * 4 + ("xattn",)
    assert (sch.n_super, sch.tail, sch.has_shared, sch.has_encoder) == \
        (20, (), False, False)
    ref_full = ref_registry.get_config(VLM)
    assert pt_count(full) == ref_count(ref_full) == 87_666_794_536
    one = dataclasses.replace(full, num_layers=5)
    assert pt_count(one) == ref_count(dataclasses.replace(
        ref_full, num_layers=5)) == 6_379_626_498
    assert pt_count(full.smoke()) == ref_count(ref_full.smoke())
    assert pt_lm.make_schedule(full.smoke()).n_super == 2
    with pytest.raises(ValueError, match="cross-attention period"):
        pt_lm.make_schedule(dataclasses.replace(full, num_layers=12))


def test_param_tree_loads_one_to_one():
    """``from_reference`` maps ``main`` 1:1, the gates as ``(n_super,)``
    leaves; the port's own init makes the gates zero, as the
    reference's."""
    _, ref_params, pt_model, pt_params = _models(gates=False)
    want = [(jax.tree_util.keystr(k), v.shape) for k, v in
            jax.tree_util.tree_flatten_with_path(ref_params)[0]]
    got = [(p, tuple(t.shape)) for p, t in
           pt_detectors._leaf_paths(pt_params)]
    assert got == want
    decl = [(p, d.shape) for p, d in pt_detectors._leaf_paths(
        pt_model.decl())]
    assert decl == got
    own = pt_model.init(0, device="cpu")
    for g in GATES:
        assert own["main"][XBLOCK][g].shape == (2,)
        assert not own["main"][XBLOCK][g].any()
        assert not pt_params["main"][XBLOCK][g].any()


@pytest.mark.parametrize("S,Skv", [(16, 8), (5, 8)])
def test_apply_xattn_block_matches_reference(S, Skv):
    """The gated cross-attention block, cache-free: more queries than
    image tokens (the smoke config's 16 over 8) and fewer."""
    ref_model, ref_params, pt_model, pt_params = _models()
    cfg = ref_model.cfg
    ref_p = jax.tree_util.tree_map(lambda a: a[1],
                                   ref_params["main"][XBLOCK])
    pt_p = P.tree_map(lambda t: t[1], pt_params["main"][XBLOCK])
    rng = np.random.default_rng(S)
    x, img = _rand(rng, 2, S, cfg.d_model), _rand(rng, 2, Skv, cfg.d_model)
    want = ref_layers.apply_xattn_block(ref_p, cfg, jnp.asarray(x),
                                        jnp.asarray(img))
    got = pt_layers.apply_xattn_block(pt_p, pt_model.cfg,
                                      torch.from_numpy(x),
                                      torch.from_numpy(img))
    _near(got, want)
    assert float((got - torch.from_numpy(x)).abs().max()) > 1e-2


def test_fill_cross_kv_matches_reference():
    """``init_cache`` with image tokens: every xattn layer's ``xk``/``xv``
    (and nothing else in those blocks: no self K/V, no write index, no
    ``xvalid``), the dense blocks' K/V and index; without an image the
    cross K/V are zeros of ``num_image_tokens``."""
    ref_model, ref_params, pt_model, pt_params = _models()
    cfg = ref_model.cfg
    img = _rand(np.random.default_rng(4), 2, cfg.num_image_tokens,
                cfg.d_model)
    want = ref_model.init_cache(ref_params, 2, 12, kv_dtype=jnp.float32,
                                img=jnp.asarray(img))
    got = pt_model.init_cache(pt_params, 2, 12, kv_dtype=torch.float32,
                              img=torch.from_numpy(img))
    assert sorted(got["main"]) == sorted(want["main"])
    for name, w in want["main"].items():
        g = got["main"][name]
        assert sorted(g) == sorted(w)
        for key in w:
            assert tuple(g[key].shape) == w[key].shape, (name, key)
            _near(g[key], w[key])
    assert sorted(got["main"][XBLOCK]) == ["xk", "xv"]
    assert got["main"][XBLOCK]["xk"].shape == (2, 2, 8, cfg.num_kv_heads,
                                               cfg.head_dim)
    assert float(got["main"][XBLOCK]["xk"].abs().max()) > 0
    assert int(pt_model.cache_index(got)) == 0
    bare = pt_model.init_cache(pt_params, 2, 12, kv_dtype=torch.float32)
    sub = bare["main"][XBLOCK]
    assert sub["xk"].shape[2] == cfg.num_image_tokens
    assert not sub["xk"].any() and not sub["xv"].any()


def test_decode_params_key_set_matches_reference():
    """The decode-path view drops each xattn block's ``wk``/``wv``, as
    the reference's does, and leaves the input tree untouched."""
    ref_model, ref_params, pt_model, pt_params = _models()
    want = [jax.tree_util.keystr(k) for k, _ in
            jax.tree_util.tree_flatten_with_path(
                ref_model.decode_params(ref_params))[0]]
    got = [p for p, _ in pt_detectors._leaf_paths(
        pt_model.decode_params(pt_params))]
    assert got == want
    assert sorted(pt_model.decode_params(pt_params)["main"][XBLOCK]
                  ["xattn"]) == ["wo", "wq"]
    assert "wk" in pt_params["main"][XBLOCK]["xattn"]


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    img = _rand(rng, B, cfg.num_image_tokens, cfg.d_model)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "img": img}


def test_forward_loss_and_grads_match_reference():
    """The vlm LM's logits, loss and every gradient leaf (the gates' and
    the cross-attention's among them, all non-zero); a second image
    changes the logits, and with the gates as ``init`` makes them (zero)
    it does not; no image raises."""
    ref_model, ref_params, pt_model, pt_params = _models()
    b = _batch(ref_model.cfg, 2, 16, seed=16)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    want_logits, _ = ref_model.forward(ref_params, jb["tokens"],
                                       img=jb["img"])
    got_logits, aux = pt_model.forward(pt_params, tb["tokens"],
                                       img=tb["img"])
    _close(got_logits, want_logits, rtol=1e-4, atol=1e-4)
    assert float(aux) == 0.0
    with pytest.raises(ValueError, match="image patch embeddings"):
        pt_model.forward(pt_params, tb["tokens"])
    other = torch.from_numpy(_rand(np.random.default_rng(1),
                                   *b["img"].shape))
    moved = pt_model.forward(pt_params, tb["tokens"], img=other)[0]
    assert float((moved - got_logits).abs().max()) > 1e-3
    zero = P.tree_map(lambda t: t, pt_params)
    zero["main"] = {**zero["main"], XBLOCK: {
        **zero["main"][XBLOCK], **{g: torch.zeros(2) for g in GATES}}}
    assert torch.equal(pt_model.forward(zero, tb["tokens"], img=tb["img"])[0],
                       pt_model.forward(zero, tb["tokens"], img=other)[0])

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
    xb = got_tree["main"][XBLOCK]
    for leaf in (xb["gate_attn"], xb["gate_mlp"], xb["xattn"]["wk"]["w"],
                 xb["mlp"]["down"]["w"]):
        assert float(leaf.abs().min() if leaf.ndim == 1
                     else leaf.abs().max()) > 0


def test_decode_token_loop_matches_reference():
    """The greedy one-token step over a dense f32 cache with the image's
    cross K/V, prompt pushed token by token, then greedy decode (the
    decode-path params): the same tokens, the dense blocks' K/V within
    1e-4 and the cross K/V left as ``init_cache`` made them."""
    ref_model, ref_params, pt_model, pt_params = _models()
    cfg = ref_model.cfg
    B, plen, gen = 2, 10, 6
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, cfg.vocab_size, (B, plen)).astype(np.int32)
    img = _rand(rng, B, cfg.num_image_tokens, cfg.d_model)
    ref_cache = ref_model.init_cache(ref_params, B, plen + gen + 1,
                                     kv_dtype=jnp.float32,
                                     img=jnp.asarray(img))
    pt_cache = pt_model.init_cache(pt_params, B, plen + gen + 1,
                                   kv_dtype=torch.float32,
                                   img=torch.from_numpy(img))
    xk0 = pt_cache["main"][XBLOCK]["xk"].clone()
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
    for name, w in ref_cache["main"].items():
        for key in ("k", "v", "xk", "xv"):
            if key in w:
                _near(pt_cache["main"][name][key], w[key], 1e-4)
    assert torch.equal(pt_cache["main"][XBLOCK]["xk"], xk0)
    assert int(pt_model.cache_index(pt_cache)) == plen + gen - 1


def test_launch_serve_matches_reference(monkeypatch, capsys):
    """``launch.serve.run --arch llama-3.2-vision-90b --smoke --profile``
    (the token loop over the seeded image tokens) gives the reference
    driver's greedy tokens on the same weights, prompts and image, prints
    its ``[serve]`` lines (the run, the reference's sample continuation,
    tier 1's) and a tier-1 profile; ``--kv paged`` and ``--spec on``
    raise as in the reference."""
    ref_model, ref_params, pt_model, pt_params = _models()
    monkeypatch.setattr(pt_registry, "get_config", lambda arch: pt_model.cfg)
    monkeypatch.setattr(pt_lm.LM, "init",
                        lambda self, seed=0, **kw: pt_params)
    B, plen, gen = 4, 16, 8
    out, merged, stats = pt_serve.run(VLM, batch=B, prompt_len=plen,
                                      gen=gen, profile=True, device="cpu")
    text = capsys.readouterr().out
    data = ref_serve.batch_at(ref_model.cfg, B, plen, seed=0, step=0)
    ref_out = ref_serve._run_legacy(
        ref_model.cfg, ref_model, ref_params, jnp.asarray(data["tokens"]),
        gen, {"img": jnp.asarray(data["img"])})[0]
    np.testing.assert_array_equal(out, np.asarray(ref_out))
    lines = [ln for ln in text.splitlines() if ln.startswith("[serve]")]
    assert lines[0].startswith(f"[serve] {VLM}: {B} seqs, prompt {plen} + "
                               f"gen {gen} [kv=dense, token loop, cpu]")
    assert lines[1] == "[serve] sample continuation: " + str(
        np.asarray(ref_out[0])[:12])
    assert lines[2].startswith("[serve] tier 1 (decode microstep): ")
    assert stats["steps"] == plen + gen - 1
    assert merged.tiers == [1, 2] and stats["tier1_s"] > 0
    for kw, msg in ((dict(kv="paged"), "--kv paged"),
                    (dict(spec=True), "--spec")):
        with pytest.raises(ValueError, match=msg):
            pt_serve.run(VLM, device="cpu", **kw)


def _nonzero_init(monkeypatch):
    """Make ``LM.init`` set the xattn gates non-zero (``_set_gates``)."""
    init = pt_lm.LM.init

    def gated(self, seed=0, **kw):
        params = init(self, seed, **kw)
        host = P.tree_map(lambda t: t.cpu().numpy(), params)
        _set_gates(host, seed + 11)
        for g in GATES:
            t = params["main"][XBLOCK][g]
            t.copy_(torch.from_numpy(host["main"][XBLOCK][g]).to(t))
        return params
    monkeypatch.setattr(pt_lm.LM, "init", gated)


def test_microbatched_loss_matches_whole_batch(monkeypatch):
    """A train step with 2 microbatches gives the whole batch's loss
    gradient (the image split with the tokens, non-zero gates): grad norm
    within 1e-5 relative of 1 microbatch's, and another image moves it."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train import state as pt_state
    from repro_torch.train import step as pt_step
    _nonzero_init(monkeypatch)
    _, _, pt_model, _ = _models()
    b = next(pt_synth.stream(pt_model.cfg, 4, 16, seed=0))
    assert b["img"].shape == (4, 8, pt_model.cfg.d_model)
    norms = []
    for k, img in ((1, b["img"]), (2, b["img"]), (2, -b["img"])):
        s0 = pt_state.create(pt_model, 0, compute_dtype=torch.float32,
                             device="cpu")
        assert s0.params["main"][XBLOCK]["gate_attn"].abs().min() > 0.2
        fn = pt_step.make_train_step(pt_model, TrainConfig(
            learning_rate=3e-4, total_steps=2, warmup_steps=1,
            microbatches=k))
        batch = {key: torch.from_numpy(v) for key, v in b.items()}
        batch["img"] = torch.from_numpy(img)
        _, m = fn(s0, batch)
        norms.append(float(m["grad_norm"]))
    np.testing.assert_allclose(norms[1], norms[0], rtol=1e-5)
    assert abs(norms[2] - norms[1]) > 1e-4 * norms[1]


def test_train_driver_profiles_on_cpu():
    """``launch.train.run --arch llama-3.2-vision-90b --smoke --profile``
    trains on the CPU with the image in the batch (2 microbatches split
    it with the tokens): finite losses and a tier-3 profile that digests
    the image too."""
    from repro_torch.launch import train as pt_train
    losses, merged = pt_train.run(VLM, smoke=True, steps=2, batch=2,
                                  seq=16, profile=True, microbatches=2,
                                  device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert merged.tiers == [3]
    # tokens, labels and img, each step
    assert merged.checked["silent_data_load"] == 3 * 2
