"""Every feature family of the reference's mesh matrix on the port's
sharded engine: the round on two gloo ranks of the CPU (4 clients a rank)
equals the port's single-process round of 8 clients.

The reference's ``tests/test_feature_matrix.py::
test_feature_on_mesh_matches_single_device`` holds each of its 20 families
(``FEATURES``) on an 8-device mesh to the single-device round; this is its
counterpart, with the reference's configurations (``torch_mesh_jobs.
feature_config``: the families' fragments and needs, SimpleCNN f32 with
dropout 0.25, one epoch of 2 steps, ε 1000 and z 6, so the noise is real)
and its tolerances: weights rtol 1e-4 / atol 1e-5, loss rel 1e-4. The
noise and every other draw is keyed by global client id, so the ranks give
the single process's draws; only the float sums' order differs. The
families whose server state carries (the server optimizer, SCAFFOLD,
FedDyn) run two rounds. The 2-rank rounds run in one launch a session
(``torch_mesh_jobs.mesh_results``).
"""

import numpy as np
import pytest
import torch

import torch_mesh_jobs as jobs
from fl_tpu.orchestration.features import FEATURES


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
    return jobs.mesh_results(tmp_path_factory, "features")


@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_feature_on_two_ranks_matches_one_process(feature, ranks):
    single = jobs.feature_rounds(feature, jobs.feature_config(feature))
    r0, r1 = (r["features"][feature] for r in ranks)
    for got, want in zip(r0["losses"], single["losses"]):
        assert got == pytest.approx(want, rel=1e-4), feature
    assert r0["losses"] == r1["losses"]
    assert sorted(r0["weights"]) == sorted(single["weights"])
    for k, want in single["weights"].items():
        np.testing.assert_allclose(r0["weights"][k], want, rtol=1e-4,
                                   atol=1e-5, err_msg=f"{feature}: {k}")
        # the global model is replicated: the ranks hold the same bits
        np.testing.assert_array_equal(r1["weights"][k], r0["weights"][k])
    # each rank's per-client losses reach every rank through the metrics'
    # reduce, at their global rows
    np.testing.assert_allclose(r0["client_losses"], single["client_losses"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(r1["client_losses"], r0["client_losses"])
