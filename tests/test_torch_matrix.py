"""The port's zoo waste matrix (``repro_torch.launch.matrix``) against
the reference's (``repro.launch.matrix``): tests/test_matrix.py's cases
at toy size on the CPU, and the MoE dead-expert probe held to the
reference's on the same weights under both dispatch modes.

The report schema, skip/error accounting, ranking order, leaderboard,
seeded determinism and the dead-expert gate are the reference's. The
rows differ where the programs do: the port's tier-0 lint finds torch
idiom waste the reference's jaxprs do not have (a ``1.0 / x`` is a
reciprocal times 1.0, remat's recompute reloads its gathers), all at
fraction 0, so the padding findings still top the ranking.
"""
import dataclasses
import json

import jax
import pytest

from repro.launch import matrix as ref_matrix
from repro_torch.configs import registry
from repro_torch.launch import matrix
from repro_torch.models.params import from_reference

from _torch_parity import smoke_configs

MOE = "granite-moe-3b-a800m"
WHISPER = "whisper-large-v3"


@pytest.fixture(scope="module")
def report():
    """One toy matrix over an MoE and an encoder-decoder config."""
    return matrix.run_cells([MOE, WHISPER], toy=True, verbose=False,
                            device="cpu")["report"]


@pytest.fixture(scope="module")
def einsum_report():
    """The MoE train cell under the pre-fix einsum dispatch."""
    return matrix.run_cells([MOE], toy=True, shapes=["train_4k"],
                            moe_dispatch="einsum", verbose=False,
                            device="cpu")["report"]


def _cell(report, arch, shape):
    (c,) = [c for c in report["cells"]
            if c["arch"] == arch and c["shape"] == shape]
    return c


def test_report_schema_and_cell_accounting(report):
    assert report["schema"] == matrix.SCHEMA == ref_matrix.SCHEMA
    assert report["configs"] == [MOE, WHISPER]
    # every registry shape gets a cell row per config, in registry order
    assert [(c["arch"], c["shape"]) for c in report["cells"]] == \
        [(a, s.name) for a in (MOE, WHISPER) for s in registry.SHAPES]
    for c in report["cells"]:
        if c["applicable"]:
            assert c["error"] is None, c
            assert c["reason"] == ""
        else:
            # quadratic-attention archs skip the 500k decode cell, with
            # the registry's reason recorded in the report
            assert c["shape"] == "long_500k"
            assert "quadratic" in c["reason"]
            assert c["findings"] == [] and c["fractions"] == {}


def test_moe_dead_expert_store_is_zero_under_scatter(report):
    c = _cell(report, MOE, "train_4k")
    assert c["fractions"]["dead_expert_store"] == 0.0
    assert not any(f["kind"] == "dead_expert_store" for f in c["findings"])


def test_moe_dead_expert_store_detected_under_einsum(einsum_report):
    c = _cell(einsum_report, MOE, "train_4k")
    assert c["fractions"]["dead_expert_store"] > 0.0
    (f,) = [f for f in c["findings"] if f["kind"] == "dead_expert_store"]
    assert f["tier"] == 3
    assert f["site"].startswith("moe.py:")
    assert f["bytes"] > 0 and f["count"] > 0
    # and the CI gate trips on the regression
    fails = matrix._gate_failures(einsum_report, 0.0)
    assert any("dead_expert_store" in m for m in fails)


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_moe_probe_matches_reference(dispatch):
    """The same weights and batch through both probes: the same rows
    stored, dead and total, the same fraction and bytes."""
    ref_cfg, pt_cfg = smoke_configs(arch=MOE)
    ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(
        ref_cfg.moe, dispatch=dispatch))
    pt_cfg = dataclasses.replace(pt_cfg, moe=dataclasses.replace(
        pt_cfg.moe, dispatch=dispatch))
    from repro.models.zoo import build_model as ref_build
    ref_params = ref_build(ref_cfg).init(jax.random.PRNGKey(0))
    pt_params = from_reference(jax.device_get(ref_params), device="cpu")
    ref = ref_matrix._moe_probe(MOE, ref_cfg, ref_params, batch=2, seq=32,
                                seed=0)
    pt = matrix._moe_probe(MOE, pt_cfg, pt_params, batch=2, seq=32, seed=0)
    assert pt.checked == ref.checked and pt.flagged == ref.flagged
    assert pt.fractions() == ref.fractions()
    assert [(f.kind, f.count, f.bytes, f.fraction) for f in pt.findings] \
        == [(f.kind, f.count, f.bytes, f.fraction) for f in ref.findings]
    if dispatch == "scatter":
        assert pt.fractions()["dead_expert_store"] == 0.0
    else:
        assert pt.fractions()["dead_expert_store"] > 0.0


def test_whisper_padding_ranks_in_matrix(report):
    c = _cell(report, WHISPER, "prefill_32k")
    (f,) = [f for f in c["findings"] if f["kind"] == "prefill_padding"]
    assert f["tier"] == 2 and f["fraction"] > 0 and f["bytes"] > 0
    # the residual bucketed padding still tops this two-config ranking
    assert report["ranking"][0]["kind"] == "prefill_padding"
    assert report["ranking"][0]["arch"] == WHISPER


def test_ranking_is_all_findings_sorted(report):
    rows = [f for c in report["cells"] for f in c["findings"]]
    assert sorted(map(json.dumps, rows)) == \
        sorted(map(json.dumps, report["ranking"]))
    keys = [(-r["fraction"], -r["bytes"]) for r in report["ranking"]]
    assert keys == sorted(keys)


def test_leaderboard_markdown(report):
    board = matrix.leaderboard(report)
    lines = board.splitlines()
    assert lines[0].startswith("| # | config | shape | tier |")
    assert WHISPER in lines[2] and "prefill_padding" in lines[2]


def test_gate_passes_post_fix(report):
    assert matrix._gate_failures(report, 0.0) == []


def test_gate_reports_cell_errors(report):
    broken = json.loads(json.dumps(report))
    broken["cells"][0]["error"] = "ValueError: boom"
    fails = matrix._gate_failures(broken, None)
    assert fails == [f"{MOE} x train_4k: ValueError: boom"]


def test_two_runs_rank_identically():
    """Seeded end to end: the same tree profiled twice produces a
    byte-identical report (the acceptance criterion for CI)."""
    kw = dict(toy=True, shapes=["train_4k"], verbose=False, device="cpu")
    a = matrix.run_cells([MOE], **kw)["report"]
    b = matrix.run_cells([MOE], **kw)["report"]
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_main_writes_report_and_gates(tmp_path):
    out = str(tmp_path / "m.json")
    code = matrix.main(["--toy", "--configs", MOE, "--shapes", "train_4k",
                        "--out", out, "--device", "cpu",
                        "--max-moe-dead-expert-fraction", "0.0"])
    assert code == 0
    with open(out) as fh:
        assert json.load(fh)["configs"] == [MOE]
