"""Fixtures of the benchmark's CPU tests (helpers in ``checkout.py``)."""

from __future__ import annotations

from pathlib import Path

import pytest

from perfbench.tests.checkout import make_root


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU; skipped (from a fixture) "
        "where there is none")


@pytest.fixture
def chip():
    """Skip the test unless a CUDA device is there (decided here, in a
    fixture, never while the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the chip)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def toy_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("checkout"))


