"""The tiny end-to-end runs of the port's three slowest experiment
drivers (the distributed-DP parity arms, CIFAR-10 DP-SGD and the PEFT
demo), on the CPU; the checks are ``tests/test_torch_experiments.py``'s
``run_driver``: the script's exit code and closing lines, and the key
tree of the reference's ``docs/<name>.json`` record."""

import pytest
import torch
from test_torch_experiments import SLOW_RUNS, run_driver


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests on one intra-op thread, restored after it:
    several test processes share the CPU under xdist, and idle OpenMP
    threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", SLOW_RUNS)
def test_driver_runs_at_a_tiny_size(name, tmp_path, capsys):
    run_driver(name, tmp_path, capsys)
