"""The PyTorch port's measurement substrate against the reference: the one
``silent_mask`` on edge values, the WasteProfile JSON contract, the
synthetic data stream, and the port's independence from JAX and from the
reference package."""
import ast
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.events import silent_mask as ref_silent_mask
from repro.core.findings import Finding as RefFinding
from repro.core.findings import WasteProfile as RefProfile
from repro.core.findings import merge_profiles as ref_merge
from repro.core.report import load_json as ref_load_json
from repro.data.synthetic import batch_at as ref_batch_at
from repro_torch.core.events import silent_mask
from repro_torch.core.findings import Finding, WasteProfile
from repro_torch.core.report import dump_json, load_json
from repro_torch.data.synthetic import batch_at

ROOT = pathlib.Path(__file__).resolve().parents[1]

# normal floats only: XLA's CPU backend flushes subnormals to zero before
# comparing (0 == 1e-38 there), torch does not
EDGE_A = np.array([0.0, -0.0, np.nan, 1.0, np.nan, 1.0, 100.0, -3.0,
                   np.inf, 1e-30, 0.0], np.float32)
EDGE_B = np.array([-0.0, 0.0, np.nan, np.nan, 1.0, 1.00999, 101.5, -3.0,
                   np.inf, 2e-30, 1e-37], np.float32)


@pytest.mark.parametrize("tol", [0.0, 0.01])
@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_silent_mask_edge_values_match_reference(tol, kind):
    """NaN is never silent, ±0 are equal, tol 0 is exact equality, the
    relative tolerance is symmetric — for torch and numpy inputs alike."""
    want = np.asarray(ref_silent_mask(jnp.asarray(EDGE_A),
                                      jnp.asarray(EDGE_B), tol))
    if kind == "torch":
        got = silent_mask(torch.from_numpy(EDGE_A), torch.from_numpy(EDGE_B),
                          tol).numpy()
    else:
        got = silent_mask(EDGE_A, EDGE_B, tol)
        assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    assert not got[2] and not got[3] and not got[4]     # NaN never silent
    assert got[0] and got[1]                            # +0 == -0


def _profile(cls_profile, cls_finding, tier):
    p = cls_profile(tier=tier)
    p.observe("silent_kv_store", True)
    p.observe("silent_kv_store", False)
    p.bump_total("kernel_store_elems", 128)
    p.add(cls_finding(kind="kernel_silent_store", tier=tier,
                      c1=("kernel:decode", "b0_dense", "layer:1"),
                      c2=("serve.engine:decode",), bytes=64.0,
                      meta={"stored_bytes": 512}))
    return p


def test_profile_json_loads_and_merges_with_reference(tmp_path):
    port = _profile(WasteProfile, Finding, 4)
    path = dump_json(port, str(tmp_path / "port.json"))
    loaded = ref_load_json(path)
    assert loaded.to_dict() == port.to_dict()
    ref = _profile(RefProfile, RefFinding, 4)
    merged = ref_merge([loaded, ref])
    assert merged.checked["silent_kv_store"] == 4
    assert merged.flagged["silent_kv_store"] == 2
    assert merged.totals["kernel_store_elems"] == 256
    (f,) = merged.findings
    assert f.count == 2 and f.bytes == 128.0
    # and back: a reference profile loads in the port unchanged
    (tmp_path / "ref.json").write_text(ref.to_json())
    assert load_json(str(tmp_path / "ref.json")).to_dict() == ref.to_dict()


@pytest.mark.parametrize("seq", [16, 96])
def test_synthetic_batches_equal_reference(seq):
    from repro.configs import registry as ref_registry
    from repro_torch.configs import registry as pt_registry
    cfg_r = ref_registry.get_config("qwen3-1.7b").smoke()
    cfg_p = pt_registry.get_config("qwen3-1.7b").smoke()
    for step in (0, 3):
        want = ref_batch_at(cfg_r, 4, seq, seed=5, step=step)
        got = batch_at(cfg_p, 4, seq, seed=5, step=step)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_reference():
    """No module of the port, and not chip_smoke.py, imports jax or the
    reference package — at top level or inside a function."""
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} "
                               f"imports {name}")
    # nor does any text of theirs read like such an import
    pattern = re.compile(r"import jax|from jax|import repro\b(?!_torch)"
                         r"|from repro[. ]")
    for path in _port_files():
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if pattern.search(line):
                bad.append(f"{path.relative_to(ROOT)}:{n}: {line.strip()}")
    assert not bad, bad
    assert len(_port_files()) > 20
