"""``evaluate_personalized`` and ``profile_round`` of the port's round
engine on two gloo ranks of the CPU, against the port's own
single-process run (no JAX here).

The engine is the entry points' (``torch_mesh_jobs.entry_point_engine``:
8 clients, delta DP at ε 1e9, the engine's own 3/4 participation masks).
After one round:

- ``evaluate_personalized``: each rank fine-tunes and scores its own four
  clients, and every rank returns the single-process dict (per-client
  arrays and the weighted means within 1e-6), gathered by ONE all-reduce
  of the five packed (C,) metrics, which the communicator records;
- ``profile_round``: the profiled round's loss within 1e-6 of the single
  process, one trace a rank under ``rank<r>``, and the model after it
  held as the port's f32 engine tolerance holds two rounds
  (``test_torch_mesh.py``): 99.9% of the elements within 1e-5 and all
  within lr (after two Adam rounds the order of the sums over the ranks
  moves two of fc1's 401,408 elements by 3e-6: Adam's first steps turn a
  last-bit difference of a near-zero gradient into a sizable step).

The 2-rank runs happen once a session (``torch_mesh_jobs.mesh_results``,
one launch for this file's cases).
"""

import os

import numpy as np
import pytest
import torch

import torch_mesh_jobs as jobs

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return jobs.mesh_results(tmp_path_factory, "validation")


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    return jobs.validation_run(None, str(tmp_path_factory.mktemp("single")))


def test_evaluate_personalized_under_a_mesh_is_the_single_process_dict(
        ranks, single):
    want = single["personalized"]
    for r in ranks:
        got = r["personalized"]
        assert set(got) == set(want)
        assert set(got["per_client"]) == set(want["per_client"])
        for k, v in want["per_client"].items():
            assert got["per_client"][k].shape == (jobs.N_CLIENTS,), k
            np.testing.assert_allclose(got["per_client"][k], v, rtol=TOL,
                                       atol=TOL, err_msg=k)
        for k in want:
            if k != "per_client":
                assert got[k] == pytest.approx(want[k], rel=TOL, abs=TOL), k
    np.testing.assert_array_equal(ranks[0]["personalized"]["per_client"][
        "n_holdout"], single["personalized"]["per_client"]["n_holdout"])


def test_evaluate_personalized_gathers_with_one_all_reduce(ranks, single):
    assert single["personalize_calls"] == []
    for r in ranks:
        assert r["personalize_calls"] == [
            ("all_reduce", "float32", 5 * jobs.N_CLIENTS * 4)]


def test_profile_round_under_a_mesh_traces_each_rank(ranks, single):
    for rank, r in enumerate(ranks):
        assert r["profile_loss"] == pytest.approx(single["profile_loss"],
                                                  rel=TOL, abs=TOL)
        for k, v in single["weights"].items():
            gap = np.abs(r["weights"][k] - v)
            assert np.mean(gap <= 1e-5) >= 0.999, k
            assert gap.max() <= jobs.LR, k
        path = r["trace"]
        assert os.path.basename(os.path.dirname(path)) == f"rank{rank}"
        assert os.path.getsize(path) > 0
    assert os.path.basename(os.path.dirname(single["trace"])) != "rank0"
