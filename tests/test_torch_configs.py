"""The PyTorch port owns a copy of the config dataclasses: every
architecture's published config and its smoke reduction must equal the
reference's field for field."""
import dataclasses

import pytest

from repro.configs import registry as ref_registry
from repro_torch.configs import registry as pt_registry


@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
def test_config_and_smoke_equal_reference(arch):
    ref = ref_registry.get_config(arch)
    pt = pt_registry.get_config(arch)
    assert dataclasses.asdict(pt) == dataclasses.asdict(ref)
    assert dataclasses.asdict(pt.smoke()) == dataclasses.asdict(ref.smoke())
    assert (pt.padded_vocab, pt.q_dim, pt.kv_dim) == \
        (ref.padded_vocab, ref.q_dim, ref.kv_dim)


def test_registry_ids_and_shapes_equal_reference():
    assert pt_registry.ARCH_IDS == ref_registry.ARCH_IDS
    assert [dataclasses.asdict(s) for s in pt_registry.SHAPES] == \
        [dataclasses.asdict(s) for s in ref_registry.SHAPES]


def test_dense_param_count_equals_reference():
    """The port's declaration tree has the reference's parameter count for
    the dense family it serves (qwen3-1.7b, published width)."""
    from repro.models.zoo import count_params_analytic as ref_count
    from repro_torch.models.zoo import count_params_analytic as pt_count
    for arch in ("qwen3-1.7b", "qwen3-14b", "starcoder2-7b", "granite-20b"):
        cfg_r = ref_registry.get_config(arch)
        assert pt_count(pt_registry.get_config(arch)) == ref_count(cfg_r)
