"""The root conftest gives each pytest-xdist worker one CPU thread budget."""

import os

import pytest
import torch


def test_worker_thread_budget():
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        pytest.skip("not in a pytest-xdist worker")
    assert torch.get_num_threads() == max(1, os.cpu_count() // int(workers))
