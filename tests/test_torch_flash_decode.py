"""Flash-decoding over chunked caches (serve/flash_decode.py) on 2 and 4
gloo CPU ranks, against the reference's shard_map functions on an
Auto-axes (1, n) mesh of host devices (a subprocess) and against its
unsharded oracles (``attention_ref``, ``paged_gather``,
``paged_update``, ``paged_store_counts``).

Hostile tables (``_torch_ranks.paged_table``): a page shared by two
slots, an idle slot, an unmapped hole, a verify window past the table,
and the new row on each rank's chunk in turn. Outputs of the slots that
attend something within 1e-5 (float32); pools and counters exact.
"""
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as R
from repro.kernels import ref as RK
from repro_torch.launch.mesh import launch

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
CASES = range(len(R.TARGETS))
RANKS = (2, 4)
TOL = 1e-5
FNS = ("decode", "verify", "dense", "cross")

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.pop("REPRO_USE_PALLAS", None)
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
import _torch_ranks as R
from repro.serve import flash_decode as FD
out = {}
for n in (2, 4):
    mesh = jax.make_mesh((1, n), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    ax = dict(mesh=mesh, batch_axes=("data",), seq_axes=("model",))
    # one compile a function and mesh, every case through it
    fns = {"decode": jax.jit(lambda *a: FD.decode_paged_attention_sharded(
               *a, **ax)),
           "verify": jax.jit(lambda *a: FD.verify_paged_attention_sharded(
               *a, **ax)),
           "dense": jax.jit(lambda *a: FD.decode_attention_sharded(*a, **ax)),
           "cross": jax.jit(lambda *a: (FD.cross_attention_sharded(
               *a, **ax),))}
    args = {"decode": ("q", "kn", "vn", "pk", "pv", "pt", "pidx"),
            "verify": ("qw", "knw", "vnw", "pk", "pv", "pt", "vidx"),
            "dense": ("dq", "dkn", "dvn", "ck", "cv", "didx"),
            "cross": ("xq", "ck", "cv")}
    for t in range(len(R.TARGETS)):
        x = {k: jnp.asarray(v) for k, v in R.flash_inputs(t).items()}
        with mesh:
            for fn, names in args.items():
                for i, a in enumerate(fns[fn](*(x[k] for k in names))):
                    out[f"{n}_{t}_{fn}_{i}"] = np.asarray(a)
np.savez(sys.argv[2], **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs by key, {n: the port's per-rank results})."""
    tmp = tmp_path_factory.mktemp("flash_decode")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF, str(TESTS), str(tmp / "ref.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = {n: launch(R.flash_rank, (1, n), args=(list(CASES),),
                      init_dir=str(tmp)) for n in RANKS}
    out, err = ref.communicate(timeout=600)
    assert "REF_OK" in out, err[-3000:]
    with np.load(tmp / "ref.npz") as z:
        return dict(z), port


def _oracle(t):
    """The reference's unsharded oracles on case t's inputs."""
    x = {k: jnp.asarray(v) for k, v in R.flash_inputs(t).items()}
    o = {}
    for fn, (q, kn, vn, idx, causal) in {
            "decode": ("q", "kn", "vn", "pidx", False),
            "verify": ("qw", "knw", "vnw", "vidx", True)}.items():
        pk, pv = RK.paged_update(x["pk"], x["pv"], x[kn], x[vn], x["pt"],
                                 x[idx])
        kg, valid = RK.paged_gather(pk, x["pt"])
        vg, _ = RK.paged_gather(pv, x["pt"])
        W = x[q].shape[1]
        want = RK.attention_ref(x[q], kg, vg, causal=causal,
                                q_offset=x[idx], kv_len=x[idx] + W,
                                kv_valid=valid)
        cnt = RK.paged_store_counts(x["pk"], x["pv"], x[kn], x[vn], x["pt"],
                                    x[idx], tol=0.0)
        o[fn] = (want, pk, pv, cnt)
    i = int(x["didx"])
    ck = x["ck"].at[:, i].set(x["dkn"][:, 0])
    cv = x["cv"].at[:, i].set(x["dvn"][:, 0])
    o["dense"] = (RK.attention_ref(x["dq"], ck, cv, causal=False,
                                   kv_len=i + 1), ck, cv)
    o["cross"] = (RK.attention_ref(x["xq"], x["ck"], x["cv"],
                                   causal=False),)
    return {k: tuple(np.asarray(a) for a in v) for k, v in o.items()}


def _live(fn):
    """Slots whose rows attend something (the idle slot 2 of the paged
    cases is don't-care, as in the reference's own test)."""
    return [0, 1, 3] if fn in ("decode", "verify") else slice(None)


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("fn", FNS)
def test_sharded_attention_matches_reference_and_oracle(runs, n, fn):
    ref, port = runs
    ranks = port[n]
    for t in CASES:
        want = _oracle(t)[fn]
        got = [r["cases"][t][fn] for r in ranks]
        live = _live(fn)
        for r in got:                    # every rank returns the whole out
            np.testing.assert_allclose(r[0][live], want[0][live], rtol=0,
                                       atol=TOL, err_msg=f"{fn} case {t}")
            np.testing.assert_allclose(r[0][live],
                                       ref[f"{n}_{t}_{fn}_0"][live], rtol=0,
                                       atol=TOL)
            np.testing.assert_array_equal(r[0], got[0][0])
        if fn == "cross":
            continue
        dim = 0 if fn in ("decode", "verify") else 1
        for i in (1, 2):                 # the chunks together: the pools
            whole = np.concatenate([r[i] for r in got], axis=dim)
            np.testing.assert_array_equal(whole, want[i])
            np.testing.assert_array_equal(whole, ref[f"{n}_{t}_{fn}_{i}"])
        if fn in ("decode", "verify"):
            for r in got:
                np.testing.assert_array_equal(r[3], want[3])
            # stored and silent of the ranks' own counts sum to the whole
            own = sum(r[4] for r in got)
            np.testing.assert_array_equal(own[:, :2], want[3][:, :2])


@pytest.mark.parametrize("n", RANKS)
def test_new_row_lands_on_each_rank_once(runs, n):
    """Slot 0's new row (page TARGETS[t]) is stored and counted by the
    rank owning that page alone, and every rank owns it in some case."""
    _, port = runs
    chunk = R.PAGES // n
    owners = set()
    for t in CASES:
        owner = R.TARGETS[t] // chunk
        owners.add(owner)
        for r in port[n]:
            stored = int(r["cases"][t]["decode"][4][0, 0])
            assert stored == (2 * R.HEADS[1] * R.HEADS[2]
                              if r["rank"] == owner else 0), (t, r["rank"])
    assert owners == set(range(n))
