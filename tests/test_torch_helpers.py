"""Shared by the tests of the torch port (tests/test_torch_*.py)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Hold torch to two CPU threads while a module's tests run. The
    workers of a parallel test run share the host's cores, and torch's
    default of one thread a core in every worker makes its CPU sorts
    many times slower. Import the name into a test module to apply it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_few_torch_threads_applies_to_this_module():
    assert torch.get_num_threads() == 2


def ahead_stages() -> set:
    """The stage keys the read-ahead adds: `inflate`, one span a file on
    a worker thread, where the native FASTX reader loads (io/fastx.py's
    ReadAhead); none on the serial Python reader. Call it in a test."""
    from ploidyfrost_tpu_torch.native import load_library

    return {"inflate"} if load_library() is not None else set()
