"""pytest settings of the benchmark's own tests.

The ``card`` marker names tests that need a CUDA card; each decides in
its ``card`` fixture, at test time, and skips with a reason without one.
Run those on a machine with a card with
``PYTHONPATH=src python -m pytest portbench -m card``.
"""
import os

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True, scope="module")
def _share_cores():
    """Each xdist worker takes its share of the cores for torch."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        cores = os.cpu_count() or 1
        torch.set_num_threads(max(1, -(-cores // int(workers))))
    yield


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures only there")
    return torch.device("cuda:0")
