"""The port's deployment round (``fl_tpu_torch.services``: the client FSM,
the coordinator servicer, the gRPC wire, ``backend="grpc"``) against the
reference's, on the CPU over localhost gRPC.

- The FSM's DP-budget timing (``tests/test_trainer_fsm.py:71-102``) with a
  stub client: a transmitted-but-rejected upload is charged, a failure
  before transmission is not, a successful round is charged once.
- The secret DP root (``tests/test_dp_noise_secret.py``): the noise seed
  is not derivable from the public client id, an injected or file-held
  secret reproduces it, and the noise differs across secrets.
- The servicer's RPCs called directly on both packages' servicers with the
  same requests: registration, the lazy initial model, a stale round, the
  aggregation trigger, status, metrics, health.
- Wire adaptive clipping (``tests/test_adaptive_clip_wire.py:95-186``):
  the geometric update and its broadcast, the validator bound, silence,
  the refusals, the indicator through the proto.
- One gRPC round end to end, port against reference: 2 clients, IID
  shards of ``batch_size`` images (one full-batch step an epoch), dropout
  0 through both FSMs' model factory, ε = 1e12 (σ far under f32's
  resolution), and the reference's initial SimpleCNN served by both
  coordinators. The global weights agree within the port's f32 engine
  tolerance (``tests/test_torch_engine.py``: at least 99.9% of the
  elements within 1e-5 and all within lr, since f32 sums in another order
  move Adam's first step where a gradient is near zero: 8 of fc1's
  401,408 elements here), the clients' losses within rtol 1e-5; the
  rounds, the participants and ε spent are equal.

Secure aggregation, distributed DP and ``persistence=`` are held to the
reference in ``tests/test_torch_secagg.py``,
``tests/test_torch_secure_deployment.py`` and
``tests/test_torch_coordinator_services.py``.
"""

import math
import os
import stat
import time

import numpy as np
import pytest
import torch

import fl_tpu.orchestration.simulation as jsim
import fl_tpu.services.federated_trainer as jft
import fl_tpu.services.grpc_server as jgs
from fl_tpu.core import types as jtypes
from fl_tpu.models import get_model_for_dataset as jax_model_for
from fl_tpu_torch.core import prng
from fl_tpu_torch.core import types as ttypes
from fl_tpu_torch.models import get_model_for_dataset
from fl_tpu_torch.orchestration import simulation as tsim
from fl_tpu_torch.services import federated_learning_pb2 as pb
from fl_tpu_torch.services import federated_trainer as tft
from fl_tpu_torch.services import grpc_server as tgs
from fl_tpu_torch.services.grpc_client import FederatedLearningClient
from fl_tpu_torch.services.grpc_utils import ProtobufConverter


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests on one intra-op thread, restored after it: the
    gRPC handlers' torch calls run on the server's thread pool, and
    several test processes share the CPU under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference_init():
    """The reference's initial SimpleCNN weights (flax, PRNGKey(0)) as
    numpy, in ``get_model_weights`` keys, which the port's weight dict
    shares."""
    import jax

    from fl_tpu.models import create_model

    model = create_model("simple_cnn")
    variables = model.init(jax.random.PRNGKey(0))
    return {k: np.asarray(v)
            for k, v in model.get_model_weights(variables).items()}


# --- the FSM's budget timing (tests/test_trainer_fsm.py:71-102) -------------------

class _StubClient:
    """An in-process stand-in for FederatedLearningClient."""

    def __init__(self, weights, submit_success=True):
        self.weights = weights
        self.submit_success = submit_success
        self.submitted = []

    def join_training_round(self, round_number):
        return ttypes.RoundConfig(round_number=round_number, local_epochs=1,
                                  batch_size=8, learning_rate=1e-3,
                                  optimizer_type="sgd")

    def get_global_model(self, round_number):
        return ttypes.GlobalModel(round_number=round_number,
                                  model_weights=dict(self.weights))

    def submit_model_update(self, update):
        self.submitted.append(update)
        return {"success": self.submit_success,
                "message": "ok" if self.submit_success else "stale round"}


@pytest.fixture(scope="module")
def budget_trainer_weights():
    from fl_tpu_torch.models import create_model, get_model_weights
    from fl_tpu_torch.models import init_variables

    return {k: v.numpy() for k, v in get_model_weights(
        init_variables(create_model("simple_cnn"), seed=0)).items()}


def _budget_trainer(weights, submit_success=True, **kwargs):
    t = tft.FederatedTrainer(
        client_id="budget_test",
        privacy=ttypes.PrivacyConfig(epsilon=1.0, delta=1e-5,
                                     max_grad_norm=1.0),
        epsilon_per_round=0.25, delta_per_round=1e-6,
        compression_algorithm=None,
        n_train_synth=64, n_test_synth=16, num_clients=4, device="cpu",
        **kwargs,
    )
    t.initialize()
    t.client = _StubClient(weights, submit_success)
    return t


def test_rejected_submission_still_charges_budget(budget_trainer_weights):
    """The payload hit the wire: even a success=False ack is a release."""
    t = _budget_trainer(budget_trainer_weights, submit_success=False)
    with pytest.raises(RuntimeError, match="rejected"):
        t._run_one_round(0)
    assert len(t.client.submitted) == 1  # it WAS transmitted
    assert t.budget_tracker.consumed_epsilon == pytest.approx(0.25)


def test_pre_transmit_failure_does_not_charge_budget(budget_trainer_weights):
    """A round refused before transmission (the budget is spent) sends
    nothing and charges nothing."""
    t = _budget_trainer(budget_trainer_weights)
    for r in range(4):
        t._run_one_round(r)
    assert t.budget_tracker.consumed_epsilon == pytest.approx(1.0)
    with pytest.raises(RuntimeError, match="privacy budget exhausted"):
        t._run_one_round(4)
    assert len(t.client.submitted) == 4  # the fifth never left
    assert t.budget_tracker.consumed_epsilon == pytest.approx(1.0)


def test_successful_round_charges_once(budget_trainer_weights):
    t = _budget_trainer(budget_trainer_weights)
    t._run_one_round(0)
    assert t.budget_tracker.consumed_epsilon == pytest.approx(0.25)
    assert t.rounds_completed == 1
    up = t.client.submitted[0]
    assert up.privacy_budget_used == pytest.approx(0.25)
    assert up.training_metrics.epochs_completed == 1
    assert all(isinstance(v, np.ndarray) for v in up.model_weights.values())
    assert set(up.model_weights) == set(budget_trainer_weights)
    h = t.training_history[0]
    assert {"train_s", "privacy_s", "compress_s", "upload_s"} <= set(h)


# --- the secret DP root (tests/test_dp_noise_secret.py) ----------------------------

def _mk(client_id="c0", **kw):
    # construction only: no network, no initialize()
    return tft.FederatedTrainer(client_id=client_id, device="cpu", **kw)


def test_dp_root_not_derivable_from_client_id():
    a, b = _mk(), _mk()
    assert a._dp_root_seed != b._dp_root_seed
    assert a._dp_root_seed != a._root_seed


def test_shuffle_root_still_deterministic():
    a, b = _mk(), _mk()
    assert a._root_seed == b._root_seed
    assert _mk("c1")._root_seed != a._root_seed


def test_injected_secret_reproduces_noise_stream():
    s1, s2 = os.urandom(32), os.urandom(32)
    a = _mk(dp_noise_secret=s1)
    b = _mk(dp_noise_secret=s1)
    c = _mk(dp_noise_secret=s2)
    assert a._dp_root_seed == b._dp_root_seed
    assert a._dp_root_seed != c._dp_root_seed
    assert a.dp_noise_seed(3) == b.dp_noise_seed(3) != c.dp_noise_seed(3)


def test_dp_secret_path_persists_0600(tmp_path):
    p = tmp_path / "state" / "dp.secret"
    a = _mk(dp_secret_path=str(p))
    assert p.exists()
    assert stat.S_IMODE(p.stat().st_mode) == 0o600
    b = _mk(dp_secret_path=str(p))
    assert a._dp_root_seed == b._dp_root_seed


def test_dp_secret_path_rejects_weak_file(tmp_path):
    p = tmp_path / "weak.secret"
    p.write_bytes(b"short")
    with pytest.raises(ValueError, match="entropy"):
        _mk(dp_secret_path=str(p))


def test_root_seed_from_digest_uses_more_than_the_first_bytes():
    base = bytes(range(16))
    tail_flip = base[:8] + bytes([b ^ 0xFF for b in base[8:]])
    assert prng.root_seed_from_digest(base) != \
        prng.root_seed_from_digest(tail_flip)
    with pytest.raises(ValueError):
        prng.root_seed_from_digest(b"tooshort")


def test_noise_is_keyed_by_the_secret_and_gaussian():
    """The DP_NOISE stream of the same (round, client index) differs
    under different secrets; the release's noise is N(0, σ²) by its
    moments (σ from the clipped norm at ε = 1)."""
    from fl_tpu_torch.fl.privacy import clip_and_noise_tree

    a = _mk(dp_noise_secret=b"A" * 32)
    b = _mk(dp_noise_secret=b"B" * 32)
    assert a.dp_noise_seed(3) != b.dp_noise_seed(3)
    tree = {"w": torch.zeros(200_000)}
    tree["w"][0] = 3.0  # norm 3 > C = 1: clipped, sensitivity 1
    na, sens, sigma = clip_and_noise_tree(tree, a.dp_noise_seed(3), 1.0,
                                          1e-5, 1.0)
    nb, _, _ = clip_and_noise_tree(tree, b.dp_noise_seed(3), 1.0, 1e-5, 1.0)
    assert float(sens) == pytest.approx(1.0)
    want_sigma = math.sqrt(2 * math.log(1.25 / 1e-5))
    assert float(sigma) == pytest.approx(want_sigma, rel=1e-6)
    z = (na["w"][1:] / sigma).double()
    assert abs(float(z.mean())) < 0.01
    assert float(z.std()) == pytest.approx(1.0, abs=0.01)
    assert not torch.allclose(na["w"], nb["w"])


def test_tls_refusals_equal_the_reference():
    from fl_tpu.services.grpc_client import FederatedLearningClient as JC

    for kw in ({"tls_cert_path": "c"}, {"tls_root_cert_path": "r",
                                        "tls_cert_path": "c"}):
        with pytest.raises(ValueError) as je:
            JC(**kw)
        with pytest.raises(ValueError) as te:
            FederatedLearningClient(**kw)
        assert str(te.value) == str(je.value)
    for kw in ({"tls_cert_path": "c"}, {"tls_client_ca_path": "ca"}):
        with pytest.raises(ValueError) as je:
            jgs.CoordinatorGRPCServer(jgs.FederatedLearningServicer(), **kw)
        with pytest.raises(ValueError) as te:
            tgs.CoordinatorGRPCServer(
                tgs.FederatedLearningServicer(device="cpu"), **kw)
        assert str(te.value) == str(je.value)


# --- the servicer's RPCs, called directly on both packages ---------------------------

def _msg(m, drop=()):
    from google.protobuf.json_format import MessageToDict

    d = MessageToDict(m, preserving_proto_field_name=True)
    for k in drop:
        d.pop(k, None)
    return d


def _upload(weights, cid, rnd, n, loss, shift):
    conv = ProtobufConverter()
    return conv.model_update_to_proto(ttypes.ModelUpdate(
        client_id=cid, round_number=rnd,
        model_weights={k: v + shift for k, v in weights.items()},
        num_samples=n, training_loss=loss, timestamp=time.time(),
        training_metrics=ttypes.TrainingMetrics(
            loss=loss, accuracy=0.5 + shift, epochs_completed=1,
            training_time=0.1, samples_processed=n)))


def _wait_round(servicer, rnd, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if servicer.current_round == rnd and not servicer._aggregating:
            return
        time.sleep(0.02)
    pytest.fail(f"the servicer did not reach round {rnd}")


def test_servicer_rpcs_equal_the_reference(reference_init):
    pc = (1.0, 1e-5, 1.0)
    servicers = [
        jgs.FederatedLearningServicer(round_config=jtypes.RoundConfig(
            min_clients=2, max_clients=4, local_epochs=1, batch_size=8,
            privacy_config=jtypes.PrivacyConfig(*pc))),
        tgs.FederatedLearningServicer(round_config=ttypes.RoundConfig(
            min_clients=2, max_clients=4, local_epochs=1, batch_size=8,
            privacy_config=ttypes.PrivacyConfig(*pc)), device="cpu"),
    ]
    assert servicers[1].aggregator.validator.max_abs_weight == \
        servicers[0].aggregator.validator.max_abs_weight
    out = []
    for s, types in zip(servicers, (jtypes, ttypes)):
        s.global_model = types.GlobalModel(0, dict(reference_init))
        reg = [s.RegisterClient(pb.ClientRegistration(
            client_id=cid, capabilities=pb.ClientCapabilities(
                compute_power=pb.COMPUTE_POWER_MEDIUM,
                network_bandwidth_mbps=10, available_samples=100)), None)
            for cid in ("a", "b", "")]
        join = s.JoinTrainingRound(pb.RoundJoinRequest(client_id="a"), None)
        cfg = s.GetRoundConfig(pb.RoundConfigRequest(client_id="a"), None)
        gm = s.GetGlobalModel(pb.ModelRequest(client_id="a"), None)
        stale = s.SubmitModelUpdate(
            _upload(reference_init, "a", 5, 10, 0.4, 0.0), None)
        first = s.SubmitModelUpdate(
            _upload(reference_init, "a", 0, 30, 0.4, 0.01), None)
        status_mid = s.GetTrainingStatus(pb.StatusRequest(), None)
        second = s.SubmitModelUpdate(
            _upload(reference_init, "b", 0, 10, 0.6, -0.02), None)
        _wait_round(s, 1)
        status = s.GetTrainingStatus(pb.StatusRequest(), None)
        health = s.HealthCheck(pb.HealthRequest(), None)
        metrics = s.GetMetrics(pb.MetricsRequest(
            metric_names=["clients_per_round", "train_loss"]), None)
        late = s.SubmitModelUpdate(
            _upload(reference_init, "a", 0, 30, 0.4, 0.0), None)
        out.append(dict(
            reg=[_msg(r) for r in reg], join=_msg(join), cfg=_msg(cfg),
            gm=_msg(gm, ("model_weights",)), stale=_msg(stale),
            first=_msg(first), second=_msg(second), late=_msg(late),
            status_mid=_msg(status_mid, ("client_statuses",)),
            status=_msg(status, ("client_statuses",)),
            states=[(c.client_id, c.state, c.rounds_participated, c.last_loss)
                    for c in status.client_statuses],
            health=_msg(health, ("timestamp",)),
            metrics={k: [p.value for p in v.points]
                     for k, v in metrics.metrics.items()},
            model=s.global_model))
    want, got = out
    for k in ("reg", "join", "cfg", "gm", "stale", "first", "second", "late",
              "status_mid", "states", "health", "metrics"):
        assert got[k] == want[k], k
    for k in ("current_round", "active_clients", "round_progress",
              "round_status"):
        assert got["status"].get(k) == want["status"].get(k), k
    assert got["status"].get("global_accuracy", 0.0) == pytest.approx(
        want["status"].get("global_accuracy", 0.0))
    assert got["status"]["convergence_score"] == pytest.approx(
        want["status"]["convergence_score"], rel=1e-6)
    gmod, wmod = got["model"], want["model"]
    assert sorted(gmod.participating_clients) == \
        sorted(wmod.participating_clients)
    assert gmod.accuracy_metrics == pytest.approx(wmod.accuracy_metrics)
    for k, v in wmod.model_weights.items():
        assert isinstance(gmod.model_weights[k], torch.Tensor)
        np.testing.assert_allclose(gmod.model_weights[k].numpy(),
                                   np.asarray(v), rtol=1e-6, atol=1e-7)
    for s in servicers:
        s._agg_pool.shutdown(wait=True)


def test_lazy_initial_model_is_the_ports_simple_cnn(reference_init):
    s = tgs.FederatedLearningServicer(device="cpu")
    resp = s.GetGlobalModel(pb.ModelRequest(client_id="x"), None)
    w = ProtobufConverter().weights_from_bytes(resp.model_weights)
    assert {k: v.shape for k, v in w.items()} == \
        {k: v.shape for k, v in reference_init.items()}
    assert sum(v.size for v in w.values()) == 421_642
    assert resp.success and resp.round_number == 0
    s.close()


# --- wire adaptive clipping (tests/test_adaptive_clip_wire.py:95-186) ------------------

PC = (8.0, 1e-5, 4.0)


def _metrics(indicator=None):
    extra = ({} if indicator is None
             else {"adaptive_clip_indicator": float(indicator),
                   "adaptive_clip_norm": 4.0})
    return ttypes.TrainingMetrics(loss=0.5, accuracy=0.8, epochs_completed=1,
                                  training_time=0.1, samples_processed=64,
                                  additional_metrics=extra)


def _run_one_wire_round(port, indicators):
    clients = []
    try:
        for i in range(len(indicators)):
            c = FederatedLearningClient(host="127.0.0.1", port=port,
                                        client_id=f"ac_{i}", timeout_s=10.0)
            c.connect()
            clients.append(c)
        rnd = None
        for c, ind in zip(clients, indicators):
            c.join_training_round()
            gm = c.get_global_model()
            rnd = gm.round_number
            w = {k: np.asarray(v) for k, v in gm.model_weights.items()}
            r = c.submit_model_update(ttypes.ModelUpdate(
                client_id=c.client_id, round_number=rnd,
                model_weights={k: v + 0.01 for k, v in w.items()},
                num_samples=64, training_loss=0.5,
                training_metrics=_metrics(ind)))
            assert r["success"], r["message"]
        deadline = time.time() + 30
        while time.time() < deadline:
            if clients[0].get_training_status().current_round == rnd + 1:
                return rnd
            time.sleep(0.05)
        pytest.fail("aggregation did not advance the round")
    finally:
        for c in clients:
            c.close()


@pytest.fixture()
def adaptive_server(reference_init):
    servicer = tgs.FederatedLearningServicer(
        round_config=ttypes.RoundConfig(
            min_clients=2, max_clients=4, local_epochs=1,
            privacy_config=ttypes.PrivacyConfig(*PC)),
        adaptive_clipping=True, clip_target_quantile=0.5,
        clip_learning_rate=0.2, clip_count_stddev=0.5, device="cpu")
    servicer.global_model = ttypes.GlobalModel(0, dict(reference_init))
    srv = tgs.CoordinatorGRPCServer(servicer, host="127.0.0.1", port=0)
    port = srv.start()
    yield servicer, port
    srv.stop()


def test_geometric_update_matches_the_reference_and_broadcasts(
        adaptive_server):
    from fl_tpu.fl.privacy import geometric_clip_update

    servicer, port = adaptive_server
    c0 = float(servicer.round_config.privacy_config.max_grad_norm)
    _run_one_wire_round(port, [1.0, 1.0])
    expected = c0 * math.exp(-0.2 * (1.0 - 0.5))
    got = float(servicer.round_config.privacy_config.max_grad_norm)
    assert got == pytest.approx(expected, rel=1e-12)
    assert got == pytest.approx(float(geometric_clip_update(
        np.float32(c0), np.float32(1.0), 0.5, 0.2)), rel=1e-6)
    c = FederatedLearningClient(host="127.0.0.1", port=port,
                                client_id="probe", timeout_s=10.0)
    c.connect()
    try:
        assert c.get_round_config().privacy_config.max_grad_norm == \
            pytest.approx(expected, rel=1e-6)
    finally:
        c.close()
    assert servicer.metrics_history["clip_norm"][-1][1] == pytest.approx(
        expected, rel=1e-12)


def test_unclipped_fleet_grows_c_and_validator_bound_tracks(adaptive_server):
    from fl_tpu.fl.privacy import adaptive_clip_delta_multiplier

    servicer, port = adaptive_server
    c0 = float(servicer.round_config.privacy_config.max_grad_norm)
    bound0 = servicer.aggregator.validator.max_abs_weight
    _run_one_wire_round(port, [0.0, 0.0])
    c1 = float(servicer.round_config.privacy_config.max_grad_norm)
    assert c1 == pytest.approx(c0 * math.exp(0.2 * 0.5), rel=1e-12)
    z = math.sqrt(2 * math.log(1.25 / PC[1])) / PC[0]
    z_delta = adaptive_clip_delta_multiplier(z, 0.5)
    assert servicer.aggregator.validator.max_abs_weight == pytest.approx(
        10.0 + 8.0 * z_delta * c1, rel=1e-9)
    assert servicer.aggregator.validator.max_abs_weight != bound0


def test_mixed_fleet_without_indicators_leaves_c_untouched(adaptive_server):
    servicer, port = adaptive_server
    c0 = float(servicer.round_config.privacy_config.max_grad_norm)
    _run_one_wire_round(port, [None, None])
    assert float(servicer.round_config.privacy_config.max_grad_norm) == c0
    assert not servicer.metrics_history.get("clip_norm")


def test_adaptive_refusals_equal_the_reference():
    def both(kw, round_config):
        with pytest.raises(Exception) as je:
            jgs.FederatedLearningServicer(
                round_config=jtypes.RoundConfig(**round_config(jtypes)),
                adaptive_clipping=True, **kw)
        with pytest.raises(Exception) as te:
            tgs.FederatedLearningServicer(
                round_config=ttypes.RoundConfig(**round_config(ttypes)),
                adaptive_clipping=True, device="cpu", **kw)
        assert type(te.value).__name__ == type(je.value).__name__
        assert str(te.value) == str(je.value)

    base = lambda t: {"min_clients": 2,  # noqa: E731
                      "privacy_config": t.PrivacyConfig(*PC)}
    both({}, lambda t: {"min_clients": 2})
    both({"clip_target_quantile": 1.5}, base)
    both({"clip_learning_rate": 0.0}, base)
    both({"clip_count_stddev": 0.5}, lambda t: {
        "min_clients": 2, "privacy_config": t.PrivacyConfig(0.1, 1e-5, 1.0)})
    with pytest.raises(ValueError) as je:
        jft.FederatedTrainer(client_id="x", adaptive_clipping=True)
    with pytest.raises(ValueError) as te:
        tft.FederatedTrainer(client_id="x", adaptive_clipping=True,
                             device="cpu")
    assert str(te.value) == str(je.value)


def test_additional_metrics_round_trip_through_proto():
    conv = ProtobufConverter()
    up = ttypes.ModelUpdate(client_id="c", round_number=3,
                            model_weights={"w": np.ones((2, 2), np.float32)},
                            num_samples=10, training_loss=0.4,
                            training_metrics=_metrics(0.875))
    back = conv.model_update_from_proto(conv.model_update_to_proto(up))
    assert back.training_metrics.additional_metrics == {
        "adaptive_clip_indicator": 0.875, "adaptive_clip_norm": 4.0}


def test_adaptive_clip_wire_e2e():
    """2 FSMs x 2 rounds against a live coordinator: C starts far above
    every delta norm, every client reports (noisily) clipped, C shrinks
    after each aggregation."""
    sim = tsim.FederatedLearningSimulation(tsim.SimulationConfig(
        dataset="mnist", num_clients=2, num_rounds=2,
        target_accuracy=0.999, backend="grpc",
        n_train_synth=128, n_test_synth=32,
        local_epochs=1, batch_size=8,
        privacy_epsilon=16.0, dp_mode="delta", timeout_s=120,
        heterogeneous_clients=False, max_grad_norm=100.0,
        dp_noise_seed=7, adaptive_clipping=True, clip_count_stddev=0.4,
        clip_target_quantile=0.5, clip_learning_rate=0.2,
    ), device="cpu")
    results = sim.run_simulation()
    assert results["rounds_completed"] >= 2
    history = results["clip_norm_history"]
    assert len(history) >= 2
    assert history[0] < 100.0
    assert history[1] < history[0]


# --- one gRPC round end to end, port against reference ----------------------------------

SPC = 8
PARITY = dict(dataset="mnist", num_clients=2, num_rounds=1,
              target_accuracy=0.999, backend="grpc",
              partition_strategy="iid", n_train_synth=2 * SPC,
              n_test_synth=16, local_epochs=1, batch_size=SPC,
              privacy_epsilon=1e12, dp_mode="delta", timeout_s=240,
              heterogeneous_clients=False, dp_noise_seed=3)


def _grpc_round(sim_mod, ft_mod, gs_mod, model_for, init, device=None):
    """One ``backend="grpc"`` run of ``PARITY`` with dropout 0 and
    ``init`` as the served initial model; returns (results, servicer)."""
    mp = pytest.MonkeyPatch()
    made = []
    init_fn = gs_mod.FederatedLearningServicer.__init__

    def record(self, *a, **kw):
        init_fn(self, *a, **kw)
        made.append(self)

    types = ttypes if device is not None else jtypes
    mp.setattr(ft_mod, "get_model_for_dataset",
               lambda name: model_for(name, dropout_rate=0.0))
    mp.setattr(gs_mod.FederatedLearningServicer, "__init__", record)
    mp.setattr(gs_mod.FederatedLearningServicer,
               "_create_initial_global_model",
               lambda self: types.GlobalModel(0, dict(init)))
    try:
        kw = {} if device is None else {"device": device}
        results = sim_mod.FederatedLearningSimulation(
            sim_mod.SimulationConfig(**PARITY), **kw).run_simulation()
    finally:
        mp.undo()
    return results, made[0]


def test_grpc_round_equals_the_reference(reference_init):
    want, jserv = _grpc_round(jsim, jft, jgs, jax_model_for, reference_init)
    got, tserv = _grpc_round(tsim, tft, tgs, get_model_for_dataset,
                             reference_init, device="cpu")
    assert got["backend"] == want["backend"] == "grpc"
    assert got["stop_reason"] == want["stop_reason"]
    assert got["rounds_completed"] == want["rounds_completed"] == 1
    assert set(got) == set(want)
    assert sorted(tserv.global_model.participating_clients) == \
        sorted(jserv.global_model.participating_clients) == ["sim_0",
                                                            "sim_1"]
    for cid, ws in want["client_results"].items():
        gs = got["client_results"][cid]
        assert gs["rounds_completed"] == ws["rounds_completed"] == 1
        assert [h["epsilon_used"] for h in gs["history"]] == \
            [h["epsilon_used"] for h in ws["history"]]
        assert gs["budget"]["consumed_epsilon"] == \
            ws["budget"]["consumed_epsilon"]
        assert gs["history"][0]["loss"] == pytest.approx(
            ws["history"][0]["loss"], rel=1e-5)
    moved, diffs = 0.0, []
    for k, v in jserv.global_model.model_weights.items():
        g = ttypes.to_numpy(tserv.global_model.model_weights[k])
        diffs.append(np.abs(g - np.asarray(v)).ravel())
        moved = max(moved, float(np.abs(np.asarray(v)
                                        - reference_init[k]).max()))
    diffs = np.concatenate(diffs)
    lr = PARITY.get("learning_rate", 1e-3)
    assert (diffs <= 1e-5).mean() >= 0.999 and diffs.max() <= lr
    assert moved > 1e-4  # the round moved the model
    assert got["final_accuracy"] == pytest.approx(want["final_accuracy"],
                                                  abs=1e-6)
