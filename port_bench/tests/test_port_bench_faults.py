"""A whole run of each cell on the CPU at a tiny size, past the harness's
look for a card, with the timed path broken underneath: the round returns
the global model it was given, or the mean is taken over half of the
clients. ``correct`` must come out false, on a number that reads at least
ten times what the unbroken run reads.
"""

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

import control  # noqa: E402
import run  # noqa: E402
from lib import check  # noqa: E402

SIZES = {"mnist-dp-full": (4, 64), "cifar-dp-full": (2, 64),
         "mnist-dpsgd-ghost": (2, 512)}


def run_tiny(cell):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec, workload, config = control.cell_files(cell)
    workload = control.shrink(workload, *SIZES[cell])
    specs = [m for m in bench["end_to_end"]
             if cell in m.get("workloads", [cell])]
    return run.run_cell(cell, spec, workload, config, specs, 3000000123,
                        0.2, False, "cpu")


def break_state(monkeypatch):
    from fl_tpu_torch.orchestration import round_engine as re

    orig = re.FederatedRoundEngine._superstep

    def unchanged(self, global_vars, *a, **k):
        _, ef, state, packed = orig(self, global_vars, *a, **k)
        return global_vars, ef, state, packed
    monkeypatch.setattr(re.FederatedRoundEngine, "_superstep", unchanged)


def break_mean(monkeypatch):
    from fl_tpu_torch.orchestration import round_engine as re

    orig = re.normalized_client_weights

    def half(num_samples, mask=None):
        mask = mask.clone()
        mask[mask.shape[0] // 2:] = 0.0
        return orig(num_samples, mask)
    monkeypatch.setattr(re, "normalized_client_weights", half)


@pytest.fixture(scope="module")
def unbroken():
    return {cell: run_tiny(cell) for cell in SIZES}


@pytest.mark.parametrize("fault", [break_state, break_mean],
                         ids=["state_unchanged", "half_the_clients"])
@pytest.mark.parametrize("cell", sorted(SIZES))
def test_a_broken_round_is_not_correct(cell, fault, unbroken, monkeypatch):
    fault(monkeypatch)
    res = run_tiny(cell)
    assert res["correct"] is False
    base = unbroken[cell]["checks"]
    worst = max(res["checks"][k]["value"] / base[k]["value"]
                for k in check.NAMES)
    assert worst >= 10.0, (res["checks"], base)
