"""Shared pytest wiring.

``--pallas-interpret`` forces the Pallas kernel dispatch on
(``REPRO_USE_PALLAS=1``) before any test traces a model: on CPU the
backend check in ``repro.kernels.ops._pallas_interpret`` then routes
every kernel through interpret mode, so the whole suite — including the
serving engine's greedy decode — exercises the TPU kernel code paths
and must reproduce the reference results bit for bit (the CI
kernels-interpret job runs the parity subset this way).
"""
import os


def pytest_addoption(parser):
    parser.addoption(
        "--pallas-interpret", action="store_true", default=False,
        help="force REPRO_USE_PALLAS=1 (Pallas kernels in interpret "
             "mode on CPU) for the whole test process")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (the PyTorch port's "
        "hand-written kernels); skips without them")
    if config.getoption("--pallas-interpret"):
        os.environ["REPRO_USE_PALLAS"] = "1"
