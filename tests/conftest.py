# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see
# the single real CPU device; multi-device tests spawn subprocesses that
# set --xla_force_host_platform_device_count themselves.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the port's CUDA kernels); "
                   "skips inside the test when torch.cuda is unavailable")


@pytest.fixture(autouse=True, scope="module")
def _bound_live_executables():
    """XLA's CPU client can segfault in ``backend_compile`` once several
    hundred executables from earlier modules are still alive (reproduced
    deterministically on 1-vCPU hosts at the seed commit — the crash
    lands in whatever module happens to compile next, e.g. the MoE
    dispatch scatter).  Dropping jax's caches between modules keeps the
    live-executable count bounded; modules don't share compiled
    programs, so the only cost is cross-module cache misses."""
    yield
    import jax

    jax.clear_caches()


try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    # environments without hypothesis run the property tests through a
    # minimal deterministic replayer instead of failing at collection
    sys.path.insert(0, os.path.dirname(__file__))
    import _hypothesis_stub

    _hypothesis_stub.install()
