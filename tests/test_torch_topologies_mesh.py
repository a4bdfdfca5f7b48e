"""The hierarchical, decentralized, FedDF and HPO engines on two gloo ranks
of the CPU, against the port's own single-process runs (no JAX here).

Each engine's run (``torch_mesh_jobs``: 8 clients of 16 images, SimpleCNN
with dropout live, so a client must draw the same streams whichever rank
holds it; SGD) equals the single-process run within rtol 1e-4 / atol 1e-5
(the order of the sums over the ranks), both ranks holding the same
replicated values:

- HierFAVG at E = 3, τ = 2 (edge 1 spans both ranks): the edge models
  every round, the cloud model, the metrics, the divergence and the sync
  flags;
- D-PSGD on the ring: every client's model (gathered), the mean model,
  the metrics and the consensus distance;
- FedDF, 3 SGD distill steps a round (Adam would turn the teacher sum's
  reduction order, a last-bit difference, into lr-sized steps wherever a
  gradient is near zero): the global model and both KLs;
- HPO, three trials with a rung after round 0: the same validation
  accuracies, kills and survivors, the trial models.

And the collectives of a round, counted: HierFAVG ONE all-reduce (every
edge's numerators, the edge masses, the metric sums); D-PSGD one packed
all-gather of the (CL, D) client matrix and one all-reduce (the metrics
and the consensus distance); FedDF one all-reduce for the FedAvg sums with
the metrics, one for the probe batch's logits and one a distill step;
HPO one all-reduce of the G trials' sums and the mass.

The 2-rank runs happen once a session (``torch_mesh_jobs.mesh_results``,
one launch for this file's cases).
"""

import numpy as np
import pytest
import torch

import torch_mesh_jobs as jobs
from fl_tpu_torch.models import count_params, create_model

RTOL, ATOL = 1e-4, 1e-5
D = count_params(create_model("simple_cnn").init(torch.Generator(), "cpu"))
K, CL = 10, jobs.N_CLIENTS // jobs.WORLD


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
    return jobs.mesh_results(tmp_path_factory, "topologies")


@pytest.fixture(scope="module")
def single():
    return jobs.topologies_job(None)


def close_trees(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def equal_trees(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def close_metrics(got, want):
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, bool):
                assert a == b
            else:
                assert a == pytest.approx(b, rel=RTOL, abs=ATOL)


def test_hierarchical_on_two_ranks_equals_one_process(ranks, single):
    want = single["hierarchical"]
    for r in ranks:
        got = r["hierarchical"]
        close_metrics(got["metrics"], want["metrics"])
        for g, w in zip(got["edges"], want["edges"]):
            close_trees(g, w)
        close_trees(got["cloud"], want["cloud"])
    equal_trees(ranks[0]["hierarchical"]["cloud"],
                ranks[1]["hierarchical"]["cloud"])
    # round 0 drifts, round 1 syncs
    assert [m[3] for m in want["metrics"]] == [False, True]


def test_decentralized_on_two_ranks_equals_one_process(ranks, single):
    want = single["decentralized"]
    for r in ranks:
        got = r["decentralized"]
        close_metrics(got["metrics"], want["metrics"])
        close_trees(got["clients"], want["clients"])
        close_trees(got["mean"], want["mean"])
    equal_trees(ranks[0]["decentralized"]["clients"],
                ranks[1]["decentralized"]["clients"])


def test_feddf_on_two_ranks_equals_one_process(ranks, single):
    want = single["feddf"]
    for r in ranks:
        got = r["feddf"]
        close_metrics(got["metrics"], want["metrics"])
        close_trees(got["weights"], want["weights"])
    equal_trees(ranks[0]["feddf"]["weights"], ranks[1]["feddf"]["weights"])


def test_hpo_on_two_ranks_equals_one_process(ranks, single):
    want = single["hpo"]
    for r in ranks:
        got = r["hpo"]
        for (ga, gn, gb, gh), (wa, wn, wb, wh) in zip(got["rounds"],
                                                      want["rounds"]):
            assert (gn, gb, gh) == (wn, wb, wh)
            assert ga.keys() == wa.keys()
            for tid in wa:
                assert ga[tid] == pytest.approx(wa[tid], abs=1e-6)
        assert got["alive"] == want["alive"]
        close_trees(got["weights"], want["weights"])
    assert want["rounds"][0][3] and want["rounds"][0][1] == 2


@pytest.mark.parametrize("engine", ["hierarchical", "decentralized",
                                    "feddf", "hpo"])
def test_round_collectives_are_counted(ranks, single, engine):
    assert single[engine]["collectives"] == []
    E, G = jobs.HIER_EDGES, len(jobs.HPO_LRS)
    want = {
        "hierarchical": [("all_reduce", "float32", 4 * (E * D + E + 3))],
        "decentralized": [("all_gather", "float32", 4 * CL * D),
                          ("all_reduce", "float32", 4 * 4)],
        "feddf": [("all_reduce", "float32", 4 * (D + 3))]
        + [("all_reduce", "float32", 4 * jobs.DISTILL_BATCH * K)]
        * (1 + jobs.DISTILL_STEPS),
        "hpo": [("all_reduce", "float32", 4 * (G * D + 1))],
    }[engine]
    for r in ranks:
        assert r[engine]["collectives"] == want
