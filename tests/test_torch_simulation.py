"""The port's simulation harness (``fl_tpu_torch.orchestration.simulation``)
and metrics collector against the reference's
(``fl_tpu.orchestration.simulation``, ``fl_tpu.orchestration.metrics``),
on the CPU.

The onchip simulation, 4 clients of 16 images on the non-IID partition,
f32, two rounds, ``dp_mode`` "none" and "delta" at ε = 1e12 (the noise far
under f32's resolution): both packages build their engines from the same
synthetic MNIST, the reference's initial model is carried into the port's
engine, and the draws are taken out of the comparison (dropout 0 through
the simulation's model factory; one full-batch step an epoch,
``batch_size == samples_per_client``). The capability cycle's epoch
budgets equal the reference's exactly (here 2, 2, 2, 2 of
``local_epochs=2``; and the uncapped cycle 3, 5, 10, 5 on larger
shards), and so do the results' key set, ``stop_reason``, the rounds,
the participants, ε spent and the privacy budget's status (but its
clock); each round's train and test losses within the port's f32 engine
tolerance (rtol 1e-5, ``test_torch_engine.py``) and its accuracies within
one test image. ``backend="grpc"`` runs a round over localhost gRPC (its
parity with the reference is ``tests/test_torch_deployment.py``'s) and,
where ``grpc`` cannot be imported, raises naming ``grpcio``; ``device``
defaults to the card, and the command line runs (in-process, on the
CPU).
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import fl_tpu.orchestration.simulation as jsim
from fl_tpu.fl.local_training import \
    create_adaptive_config as jax_adaptive_config
from fl_tpu.models import get_model_for_dataset as jax_model_for
from fl_tpu.orchestration import metrics as jmetrics
from fl_tpu_torch.models import get_model_for_dataset
from fl_tpu_torch.orchestration import metrics as tmetrics
from fl_tpu_torch.orchestration import simulation as tsim

SPC = 16
N_TEST = 64
COMMON = dict(num_clients=4, num_rounds=2, local_epochs=2,
              batch_size=SPC, samples_per_client=SPC,
              n_train_synth=4 * SPC * 4, n_test_synth=N_TEST,
              target_accuracy=0.999)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _simulations(dp_mode: str):
    """The reference's and the port's simulation of one configuration;
    returns (reference results, port results, reference engine, port
    engine)."""
    mp = pytest.MonkeyPatch()
    cfg = dict(COMMON, dp_mode=dp_mode, privacy_epsilon=1e12)
    mp.setattr(jsim, "get_model_for_dataset",
               lambda name: jax_model_for(name, dropout_rate=0.0))
    mp.setattr(tsim, "get_model_for_dataset",
               lambda name: get_model_for_dataset(name, dropout_rate=0.0))
    built = {}
    jbuild = jsim.FederatedLearningSimulation._build_engine

    def jax_build(self):
        built["jax"] = eng = jbuild(self)
        built["init"] = {k: np.asarray(v)
                         for k, v in eng.get_model_weights().items()}
        return eng

    tbuild = tsim.FederatedLearningSimulation._build_engine

    def port_build(self):
        eng = tbuild(self)
        eng.set_model_weights(built["init"])
        return eng

    mp.setattr(jsim.FederatedLearningSimulation, "_build_engine", jax_build)
    mp.setattr(tsim.FederatedLearningSimulation, "_build_engine", port_build)
    try:
        want = jsim.FederatedLearningSimulation(
            jsim.SimulationConfig(**cfg)).run_simulation()
        sim = tsim.FederatedLearningSimulation(tsim.SimulationConfig(**cfg),
                                               device="cpu")
        got = sim.run_simulation()
    finally:
        mp.undo()
    return want, got, built["jax"], sim.engine


@pytest.fixture(scope="module", params=["none", "delta"])
def pair(request):
    return _simulations(request.param)


def test_results_have_the_reference_keys_and_exact_bookkeeping(pair):
    want, got, jeng, teng = pair
    assert set(got) == set(want)
    assert set(got["config"]) == set(want["config"])
    for k in ("backend", "stop_reason", "rounds_completed",
              "total_epsilon_spent"):
        assert got[k] == want[k], k
    assert got["stop_reason"] == "round_budget_exhausted"
    if want["privacy_budget"] is None:
        assert got["privacy_budget"] is None
    else:
        for d in (got, want):
            d["privacy_budget"].pop("tracking_duration")
        assert got["privacy_budget"] == want["privacy_budget"]
    np.testing.assert_array_equal(teng.epochs_per_client,
                                  np.asarray(jeng.epochs_per_client))
    assert set(got["training_progress"]) == set(want["training_progress"])
    assert set(got["convergence"]) == set(want["convergence"])


def test_round_history_matches_the_reference(pair):
    want, got, _, _ = pair
    assert len(got["round_history"]) == len(want["round_history"]) == 2
    for g, w in zip(got["round_history"], want["round_history"]):
        # the port's RoundResult also keeps the uplink's error-feedback
        # norm, which the reference reads back and drops
        assert set(g) == set(w) | {"uplink_ef_norm"}
        for k in ("round_number", "participating_clients",
                  "epsilon_spent"):
            assert g[k] == w[k], k
        for k in ("train_loss", "test_loss"):
            assert g[k] == pytest.approx(w[k], rel=1e-5), k
        for k in ("train_accuracy", "test_accuracy"):
            assert abs(g[k] - w[k]) <= 1.0 / N_TEST + 1e-6, k
    assert got["final_loss"] == pytest.approx(want["final_loss"], rel=1e-5)
    assert got["rounds_per_sec"] > 0 and got["wall_time_s"] > 0


def test_capability_budgets_equal_the_reference():
    """The cycle's budgets (LOW 3, MEDIUM 5, HIGH 10, MEDIUM 5 epochs)
    capped at ``local_epochs``, over shard sizes on both sides of the
    adaptive config's batch thresholds."""
    counts = np.asarray([600, 700, 5500, 450, 30, 900], np.int32)
    for epochs in (2, 5, 20):
        want = []
        for i, n in enumerate(counts):
            p = jsim.CAPABILITY_CYCLE[i % 4]
            a = jax_adaptive_config({
                "compute_power": p["compute_power"].value,
                "network_bandwidth": p["network_bandwidth"],
                "available_samples": int(n)})
            want.append(min(a.local_epochs, epochs))
        got = tsim.capability_budgets(counts, epochs)
        np.testing.assert_array_equal(got, want)
    assert tsim.capability_budgets(counts, 20).tolist()[:4] == [3, 5, 10, 5]
    assert [p["compute_power"].value for p in tsim.CAPABILITY_CYCLE] == \
        [p["compute_power"].value for p in jsim.CAPABILITY_CYCLE]


def test_config_defaults_equal_the_reference():
    assert dataclasses.asdict(tsim.SimulationConfig()) == \
        dataclasses.asdict(jsim.SimulationConfig())


def test_grpc_backend_runs_a_round():
    sim = tsim.FederatedLearningSimulation(tsim.SimulationConfig(
        backend="grpc", num_clients=2, num_rounds=1, n_train_synth=64,
        n_test_synth=16, local_epochs=1, batch_size=8, timeout_s=120,
        target_accuracy=0.999), device="cpu")
    results = sim.run_simulation()
    assert results["backend"] == "grpc"
    assert results["rounds_completed"] == 1
    assert results["stop_reason"] == "round_budget_exhausted"
    for status in results["client_results"].values():
        assert status["rounds_completed"] == 1
        assert status["budget"]["consumed_epsilon"] == pytest.approx(1.0)
    assert results["final_accuracy"] is not None
    assert results["config"]["backend"] == "grpc"


def test_grpc_backend_names_grpcio_when_it_cannot_be_imported(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "grpc", None)
    sim = tsim.FederatedLearningSimulation(
        tsim.SimulationConfig(backend="grpc"), device="cpu")
    with pytest.raises(ImportError, match="grpcio"):
        sim.run_simulation()
    with pytest.raises(ImportError, match="grpcio"):
        tsim.main(["--backend", "grpc", "--device", "cpu"])


def test_simulation_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tsim.run_mnist_simulation(2, 1, n_train_synth=64, n_test_synth=16)


def test_command_line_runs_and_exports(tmp_path, capsys, monkeypatch):
    # the command line's config at a small synthetic MNIST
    monkeypatch.setattr(tsim, "SimulationConfig", functools.partial(
        tsim.SimulationConfig, n_train_synth=128, n_test_synth=32))
    out = tmp_path / "results.json"
    results = tsim.main(["--clients", "2", "--rounds", "1", "--device",
                         "cpu", "--export", str(out)])
    printed = json.loads(capsys.readouterr().out)
    assert printed["rounds_completed"] == results["rounds_completed"] == 1
    assert "round_history" not in printed
    saved = json.loads(out.read_text())
    assert saved["config"]["num_clients"] == 2
    assert len(saved["round_history"]) == 1


def test_metrics_collector_equals_the_reference():
    """The collector is host code copied from the reference: one
    lifecycle through both gives the same progress and summaries."""
    got, want = tmetrics.MetricsCollector(), jmetrics.MetricsCollector()
    for c in (got, want):
        for r, acc in enumerate((0.2, 0.4, 0.5, 0.65)):
            c.start_round(r)
            c.record_client_update(r, "a", 10, 1.0 - acc, acc)
            c.record_client_update(r, "b", 30, 1.2 - acc)
            c.complete_round(r, 1.0 - acc, acc, 0.1 * r,
                             aggregation_time_s=0.01)
        c.record_client_failure("b")
    gp, wp = got.get_training_progress(), want.get_training_progress()
    for k in ("rounds_completed", "latest_accuracy", "best_accuracy",
              "latest_loss", "accuracy_series", "loss_series"):
        assert gp[k] == wp[k], k
    assert (gp["estimated_completion"] is None) == \
        (wp["estimated_completion"] is None)
    gs, ws = got.get_client_summary(), want.get_client_summary()
    for cid in ws:
        for k in ("rounds_participated", "total_samples", "avg_loss",
                  "avg_accuracy", "failures"):
            assert gs[cid][k] == ws[cid][k], (cid, k)
    sample = tmetrics.sample_system_metrics()
    assert sample.device_count == torch.cuda.device_count()
    got.record_system_sample()
    assert got.get_system_summary()["device_count"] == sample.device_count
