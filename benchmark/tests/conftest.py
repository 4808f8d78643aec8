"""Tests of the benchmark's harness, run apart from the repository's
tier-1 suite: `python -m pytest benchmark/tests -q` (from the root).
Tests marked `card` need a CUDA device and skip without one; on the
card: `python -m pytest benchmark/tests -q -m card`."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"


def tiny(cfg: dict, genome_bp: int = 30_000) -> dict:
    return dict(cfg, genome_bp=genome_bp)
