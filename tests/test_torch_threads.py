"""One torch thread for the port's CPU tests.

The suite runs in several pytest-xdist workers at once. Torch's CPU backend
starts one thread per core in each of them, and the port's tests are long
chains of small ops at N ≤ 1024, which gain nothing from threads: left alone,
the workers' thread pools fight over the cores and every test, JAX's too,
slows down. Each ``tests/test_torch_*.py`` that runs on the CPU imports this
fixture, which holds torch to one thread while that file's tests run.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_this_file_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1
