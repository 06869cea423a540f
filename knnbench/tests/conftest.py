"""Fixtures of the benchmark's own tests.

Tests that need the card carry the ``cuda`` marker and ask for the ``card``
fixture, which decides at run time whether a card is there.
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where torch.cuda.is_available() is false")


@pytest.fixture(autouse=True)
def _planner_cache_restored():
    """A run installs an empty planner cache for its process; put the lazy
    default back, so later tests in the worker see what they would alone."""
    yield
    from repro_torch.tuning import set_default_cache

    set_default_cache(None)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def tiny(n: int = 3000, d: int = 16, *, clusters: int = 7, noise: float = 0.5,
         block_rows: int = 512, ip_as_l2: bool = False) -> dict:
    """A configuration small enough for the CPU, in the files' format."""
    cfg = {"name": "tiny", "n": n, "d": d + (1 if ip_as_l2 else 0), "metric": "l2",
           "backend": "cuda",
           "assumed": {"mixture": {"clusters": clusters, "centre_seed": 1, "centre_scale": 1.0,
                                   "noise_scale": noise, "query_noise_scale": 0.3,
                                   "block_rows": block_rows}}}
    if ip_as_l2:
        cfg["ip_as_l2"] = True
    return cfg
