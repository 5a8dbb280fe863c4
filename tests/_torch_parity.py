"""Shared set-up of the PyTorch port's parity tests: a smoke model
(qwen3-1.7b unless ``arch`` names another) in both packages with the
same weights (the reference's init, carried over through numpy by
``from_reference``), on the CPU."""
import dataclasses

import jax
import numpy as np

from repro.configs import registry as ref_registry
from repro.models.zoo import build_model as ref_build
from repro_torch.configs import registry as pt_registry
from repro_torch.models.params import from_reference
from repro_torch.models.zoo import build_model as pt_build

ARCH = "qwen3-1.7b"


def smoke_configs(dtype: str = "float32", arch: str = ARCH, **overrides):
    """(reference config, port config) of ``arch``'s smoke model in
    ``dtype`` (and any other fields in ``overrides``); float32 makes
    greedy tokens comparable bit for bit."""
    ref = dataclasses.replace(ref_registry.get_config(arch).smoke(),
                              dtype=dtype, **overrides)
    pt = dataclasses.replace(pt_registry.get_config(arch).smoke(),
                             dtype=dtype, **overrides)
    return ref, pt


def smoke_models(dtype: str = "float32", seed: int = 0, arch: str = ARCH,
                 **overrides):
    """(ref model, ref params, port model, port params) with one set of
    weights, drawn by the reference's init."""
    ref_cfg, pt_cfg = smoke_configs(dtype, arch, **overrides)
    ref_model = ref_build(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(seed))
    host = jax.device_get(ref_params)
    pt_params = from_reference(host, device="cpu")
    return ref_model, ref_params, pt_build(pt_cfg), pt_params


def to_np(x):
    """A torch tensor or jax array as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)
