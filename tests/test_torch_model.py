"""The PyTorch port's dense LM against the reference on the qwen3-1.7b
smoke config, with the reference's own weights (``from_reference``):
cached prefill and decode logits over a dense per-slot cache and over
the paged pool, the caches they leave, and the kernel-tier counters.

Tolerances: float32 logits within 1e-4 (the same f32 arithmetic, summed
in other orders, through 2 layers and the LM head); bfloat16 logits
within 3e-2 (the smoke logits stay below 1 in magnitude, where a bf16 ulp
is 2^-8 = 3.9e-3, and the two frameworks round activations at different
places: 8 ulps of room); cache contents within 1e-5; page tables and
counters exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models import params as P

from _torch_parity import smoke_models, to_np

B, MAX_LEN, PAGE = 3, 24, 4
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _tokens(vocab, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _page_table():
    """Out-of-order pages per slot, slot 2 with an unmapped tail."""
    pt = np.full((B, MAX_LEN // PAGE), -1, np.int32)
    perm = np.random.default_rng(1).permutation(B * MAX_LEN // PAGE)
    pt[0] = perm[:6]
    pt[1] = perm[6:12]
    pt[2, :3] = perm[12:15]
    return pt


def _caches(ref_model, ref_params, pt_model, pt_params, paged):
    if paged:
        rc = ref_model.init_paged_cache(ref_params, B, MAX_LEN,
                                        page_size=PAGE, kv_dtype=jnp.float32,
                                        kernel_counters=True)
        pc = pt_model.init_paged_cache(pt_params, B, MAX_LEN, page_size=PAGE,
                                       kv_dtype=torch.float32,
                                       kernel_counters=True)
        rc = ref_model.with_page_table(rc, _page_table())
        pc = pt_model.with_page_table(pc, _page_table())
    else:
        rc = ref_model.init_cache(ref_params, B, MAX_LEN,
                                  kv_dtype=jnp.float32)
        pc = pt_model.init_cache(pt_params, B, MAX_LEN,
                                 kv_dtype=torch.float32)
    start = np.array([0, 2, 5], np.int32)
    return (ref_model.with_cache_index(rc, jnp.asarray(start)),
            pt_model.with_cache_index(pc, torch.from_numpy(start)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("paged", [False, True])
def test_prefill_and_decode_logits_match_reference(paged, dtype):
    ref_model, ref_params, pt_model, pt_params = smoke_models(dtype)
    rc, pc = _caches(ref_model, ref_params, pt_model, pt_params, paged)
    vocab = ref_model.cfg.vocab_size
    tol = LOGIT_TOL[dtype]

    toks = _tokens(vocab, 8, seed=2)
    lengths = np.array([8, 6, 7], np.int32)
    want, rc = ref_model.prefill(ref_params, rc, jnp.asarray(toks),
                                 lengths=jnp.asarray(lengths))
    got, pc = pt_model.prefill(pt_params, pc, torch.from_numpy(toks),
                               lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(to_np(got.float()),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    for step in range(3):
        nxt = _tokens(vocab, 1, seed=10 + step)
        want, rc = ref_model.decode_step(ref_params, rc, jnp.asarray(nxt))
        got, pc = pt_model.decode_step(pt_params, pc, torch.from_numpy(nxt))
        np.testing.assert_allclose(to_np(got.float()),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=tol, rtol=tol)
    np.testing.assert_array_equal(to_np(pt_model.cache_index(pc)),
                                  np.asarray(ref_model.cache_index(rc)))
    assert pt_model.cache_is_paged(pc) == ref_model.cache_is_paged(rc) == paged
    if dtype != "float32":
        return
    for name, sub in rc["main"].items():
        psub = pc["main"][name]
        for key in ("k", "v"):
            np.testing.assert_allclose(to_np(psub[key]), np.asarray(sub[key]),
                                       atol=1e-5, rtol=1e-5)
        if paged:
            np.testing.assert_array_equal(to_np(psub["pt"]),
                                          np.asarray(sub["pt"]))
            np.testing.assert_array_equal(to_np(psub["kcnt"]),
                                          np.asarray(sub["kcnt"]))


def test_parameter_trees_load_one_to_one():
    """``from_reference`` keeps the reference's tree, shapes and dtypes;
    ``LM.init`` builds the same tree on the requested device."""
    ref_model, ref_params, pt_model, pt_params = smoke_models()
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref_params)
    assert len(ref_leaves) == len(P.tree_leaves(pt_params))
    for path, leaf in ref_leaves:
        node = pt_params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    fresh = pt_model.init(3, device="cpu")
    assert P.tree_map(lambda t: (tuple(t.shape), t.dtype), fresh) == \
        P.tree_map(lambda t: (tuple(t.shape), t.dtype), pt_params)
    assert P.count_tree(pt_model.decl()) == sum(
        t.numel() for t in P.tree_leaves(fresh))
