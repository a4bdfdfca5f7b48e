"""The clustered (IFCA), Ditto and async (FedBuff) engines, the round
engine's ``evaluate_federated`` and the checkpoints on two gloo ranks of
the CPU, against the port's own single-process runs (no JAX here).

- IFCA (two rounds, warm-started, label-permuted halves), Ditto (two
  engine rounds each followed by a step, then ``evaluate_personal``) and
  FedBuff (four server steps with lognormal durations, a 3-version ring and
  a 4-row buffer split over the ranks): assignments and timelines exact,
  everything else within rtol 1e-4 / atol 1e-5 (the order of the sums
  over the ranks), both ranks holding the same replicated values. Dropout
  stays live: a client draws the same streams whichever rank holds it.
- IFCA's round is exactly two all-reduces (the per-cluster numerators with
  the weight masses, then the metrics with the assignments); FedBuff's
  server step too.
- The round engine's ``evaluate_federated`` under a mesh equals the
  unsharded evaluation.
- A round-engine checkpoint with SCAFFOLD and the int8 uplink saved at
  world 2: restored at world 2 the next round equals the uninterrupted one
  bit for bit; restored at world 1 (this process) every piece of state
  equals the saved one bit for bit and the next round the uninterrupted
  one within the tolerance above. The IFCA, Ditto and FedBuff checkpoints
  saved at world 2 restore at world 1 bit for bit.

The 2-rank runs happen once a session (``torch_mesh_jobs.mesh_results``,
one launch for this file's cases).
"""

import numpy as np
import pytest
import torch

import torch_mesh_jobs as jobs
from fl_tpu_torch.fl import DittoPersonalizer
from fl_tpu_torch.orchestration.checkpoint import (
    restore_async_checkpoint,
    restore_clustered_checkpoint,
    restore_ditto_checkpoint,
    restore_engine_checkpoint,
)
from fl_tpu_torch.models import count_params, create_model

RTOL, ATOL = 1e-4, 1e-5


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
    return jobs.mesh_results(tmp_path_factory, "engines")


@pytest.fixture(scope="module")
def files(tmp_path_factory, ranks):
    return jobs.mesh_workdir(tmp_path_factory, "engines")


@pytest.fixture(scope="module")
def single():
    return {"ifca": jobs.ifca_run(), "ditto": jobs.ditto_run(),
            "fedbuff": jobs.fedbuff_run()}


def close_trees(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def equal_trees(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_ifca_on_two_ranks_equals_one_process(ranks, single):
    want = single["ifca"]
    for r in ranks:
        got = r["ifca"]
        assert got["assignments"] == want["assignments"]
        assert got["sizes"] == want["sizes"]
        np.testing.assert_allclose(got["metrics"], want["metrics"],
                                   rtol=RTOL)
        close_trees(got["weights"], want["weights"])
    equal_trees(ranks[0]["ifca"]["weights"], ranks[1]["ifca"]["weights"])
    # both populations found a cluster
    assert len(set(want["assignments"])) == 2


def test_ifca_round_is_two_all_reduces(ranks, single):
    assert single["ifca"]["collectives"] == []
    k, d = 2, count_params(create_model("simple_cnn").init(
        torch.Generator(), "cpu"))
    for r in ranks:
        assert r["ifca"]["collectives"] == [
            ("all_reduce", "float32", 4 * (k * d + k)),
            ("all_reduce", "float32", 4 * (5 + jobs.N_CLIENTS))]


@pytest.mark.parametrize("name", ["personal_loss", "personal_accuracy"])
def test_ditto_steps_on_two_ranks_equal_one_process(ranks, single, name):
    for r in ranks:
        for got, want in zip(r["ditto"]["steps"], single["ditto"]["steps"]):
            assert got[name] == pytest.approx(want[name], rel=RTOL)


def test_ditto_personal_models_on_two_ranks_equal_one_process(ranks,
                                                              single):
    for r in ranks:
        close_trees(r["ditto"]["models"], single["ditto"]["models"])


@pytest.mark.parametrize("part", ["personal", "federated"])
def test_evaluations_on_two_ranks_equal_one_process(ranks, single, part):
    """``evaluate_personal`` and the round engine's ``evaluate_federated``
    under a mesh: the per-client results in global order, the aggregates
    and the spread."""
    want = single["ditto"]
    for r in ranks:
        got = r["ditto"]
        for k, v in want[part].items():
            assert got[part][k] == pytest.approx(v, rel=RTOL, abs=ATOL), k
        for k, v in want[f"{part}_per_client"].items():
            np.testing.assert_allclose(got[f"{part}_per_client"][k], v,
                                       rtol=RTOL, atol=ATOL, err_msg=k)


def test_fedbuff_on_two_ranks_equals_one_process(ranks, single):
    want = single["fedbuff"]
    for r in ranks:
        got = r["fedbuff"]
        assert got["timeline"] == want["timeline"]
        np.testing.assert_allclose(got["metrics"], want["metrics"],
                                   rtol=RTOL)
        close_trees(got["weights"], want["weights"])
        close_trees(got["ring"], want["ring"])
        assert [c[0] for c in got["collectives"]] == ["all_reduce"] * 2
    # the buffer held rows of several attempts and later versions
    assert any(s > 0 for _, stale, _, _ in want["timeline"] for s in stale)
    assert want["collectives"] == []


def test_engine_checkpoint_resumes_at_world_2_bit_for_bit(ranks):
    for r in ranks:
        got = r["checkpoint"]
        assert got["step"] == 1
        for part in ("weights",):
            equal_trees(got["restored"][part], got["saved"][part])
            equal_trees(got["resumed"][part], got["uninterrupted"][part])
        for part in ("c", "ci", "ef"):
            np.testing.assert_array_equal(got["restored"][part],
                                          got["saved"][part])
            np.testing.assert_array_equal(got["resumed"][part],
                                          got["uninterrupted"][part])


def test_engine_checkpoint_saved_at_world_2_restores_at_world_1(ranks,
                                                                files):
    eng = jobs.checkpoint_engine()
    assert restore_engine_checkpoint(eng, str(files / "engine")) == 1
    saved = ranks[0]["checkpoint"]["saved"]
    state = jobs.engine_state(eng)
    equal_trees(state["weights"], saved["weights"])
    for part in ("c", "ci", "ef"):
        np.testing.assert_array_equal(state[part], saved[part])
    eng.run_round(mask=jobs.ALL, evaluate=False)
    want = ranks[0]["checkpoint"]["uninterrupted"]
    close_trees(jobs.engine_state(eng)["weights"], want["weights"])


def test_ifca_checkpoint_saved_at_world_2_restores_at_world_1(ranks, files):
    eng = jobs.ifca_engine()
    assert restore_clustered_checkpoint(eng, str(files / "ifca")) == 2
    equal_trees(jobs._host(eng.cluster_variables),
                ranks[0]["ifca"]["weights"])
    assert eng.assignments.tolist() == ranks[0]["ifca"]["assignments"]


def test_ditto_checkpoint_saved_at_world_2_restores_at_world_1(ranks,
                                                               files):
    ditto = DittoPersonalizer(jobs.ditto_engine(), lam=0.2)
    assert restore_ditto_checkpoint(ditto, str(files / "ditto")) == 2
    equal_trees(jobs._host(ditto.personal_variables),
                ranks[0]["ditto"]["models"])


def test_fedbuff_checkpoint_saved_at_world_2_restores_at_world_1(ranks,
                                                                 files):
    eng = jobs.fedbuff_engine()
    assert restore_async_checkpoint(eng, str(files / "fedbuff")) == 4
    equal_trees(jobs._host(eng.global_variables),
                ranks[0]["fedbuff"]["weights"])
    equal_trees(jobs._host(eng.ring), ranks[0]["fedbuff"]["ring"])
    # the restored host state continues the same timeline
    nxt = eng.run_server_step()
    ref = jobs.fedbuff_engine()
    ref.run(4)
    want = ref.run_server_step()
    assert (nxt.client_ids, nxt.staleness, nxt.sim_time,
            nxt.cancelled_attempts) == (want.client_ids, want.staleness,
                                        want.sim_time,
                                        want.cancelled_attempts)
