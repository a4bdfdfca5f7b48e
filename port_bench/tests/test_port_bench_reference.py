"""The plain reference against the port at a tiny size on the CPU, and the
control and the planted faults against the reference.

Each cell's numbers that decide ``correct`` are read at 4 clients (the
cell's own widths, steps and DP), where the port runs its kernels' plain
versions and draws its DP noise from one generator a client, which the
reference follows too. Bounds here are the CPU's, not the cell's limits:
the port within 5% of the reference on every number but the worst single
client's loss, within 10% (ten Adam steps of one client in bfloat16); the
float8 control and each fault farther from it than the port.
"""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))

import control  # noqa: E402

SIZES = {"mnist-dp-full": (4, 64), "cifar-dp-full": (2, 64),
         "mnist-dpsgd-ghost": (2, 512)}
TINY_CPU_GAP = {"loss_gap": 0.05, "client_loss_gap": 0.1,
                "update_gap": 0.05, "change_gap": 0.05}


def read(cell, variants, seed=7):
    clients, samples = SIZES[cell]
    torch.manual_seed(0)
    return {r["variant"]: r for r in control.readings(
        cell, [seed], variants, "cpu", clients, samples)}


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_reference_agrees_with_the_port_on_the_cpu(cell):
    got = read(cell, ["program"])["program"]
    for name, gap in TINY_CPU_GAP.items():
        assert got[name] < gap, (name, got)


def test_control_and_faults_read_farther_than_the_port():
    got = read("mnist-dp-full", ["program", "float8", "half_clients",
                                 "half_batch", "unchanged"])
    port = max(got["program"][k] for k in ("loss_gap", "update_gap"))
    assert got["float8"]["update_gap"] > port
    for fault in ("half_clients", "half_batch", "unchanged"):
        assert max(got[fault][k] for k in ("loss_gap", "update_gap")) > (
            10 * port), (fault, got[fault])
