"""Shared fixtures: isolate every test from the per-device autotune cache.

The planner consults the process-wide ``repro.tuning.default_cache()`` for
tuned block shapes, pipeline knobs, and the persisted Pallas capability
verdict. Tests must neither read a developer machine's warm cache (which
would silently change planned executors/blocks) nor write to it (a probe
inside one test would veto Pallas for every later planner test). Each test
therefore runs against a fresh in-memory cache; tests that exercise
persistence pass their own ``path=`` explicitly.
"""
from __future__ import annotations

import pytest

from repro.tuning import AutotuneCache, set_default_cache


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "chaos: seeded fault-injection soaks (CI runs them over a seed "
        "matrix via -m chaos; CHAOS_SEED selects the fault plan seed)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc (tests/test_torch_cuda.py); "
        "skips where torch.cuda.is_available() is false",
    )


@pytest.fixture(autouse=True)
def _isolated_autotune_cache():
    set_default_cache(AutotuneCache(path=None))
    yield
    set_default_cache(None)
