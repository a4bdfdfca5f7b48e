"""The port's coordinator services (``fl_tpu_torch.services.database``,
``persistence``, ``rest_api``, ``coordinator_main``, ``client_main`` and
``fl_tpu_torch.utils.logging_config``, ``monitoring``,
``error_tracking``) against the reference's, on the CPU.

- sqlite CRUD (``tests/test_aux_components.py``), and a database file
  written by either package read by the other.
- A persistence directory written by either package restored by the
  other bit for bit; the servicer's restart resume (round, global model,
  the distributed-DP ledger).
- Every REST route's JSON equal to the reference's ``CoordinatorAPI.
  handle`` over the same state (host-clock fields masked), plus a real
  HTTP round trip on port 0 with the Prometheus text.
- The logging, monitoring and error-tracking cases of
  ``tests/test_aux_components.py`` on the port's modules, and their
  categorizations and alert verdicts equal to the reference's.
- One in-process ``CoordinatorService`` (gRPC and REST on port 0) +
  ``ClientService`` round from dict configs.
"""

import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fl_tpu.core import types as jtypes
from fl_tpu.orchestration import failure as jfailure
from fl_tpu.orchestration import metrics as jmetrics
from fl_tpu.orchestration import round_manager as jrm
from fl_tpu.services import database as jdb
from fl_tpu.services import persistence as jpersist
from fl_tpu.services import rest_api as jrest
from fl_tpu.utils import error_tracking as jerr
from fl_tpu.utils import monitoring as jmon
from fl_tpu_torch.core import types as ttypes
from fl_tpu_torch.orchestration import failure as tfailure
from fl_tpu_torch.orchestration import metrics as tmetrics
from fl_tpu_torch.orchestration import round_manager as trm
from fl_tpu_torch.services import database as tdb
from fl_tpu_torch.services import grpc_server as tgs
from fl_tpu_torch.services import persistence as tpersist
from fl_tpu_torch.services import rest_api as trest
from fl_tpu_torch.utils import error_tracking as terr
from fl_tpu_torch.utils import logging_config as tlog
from fl_tpu_torch.utils import monitoring as tmon


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def restore_root_logging():
    """``setup_logging`` replaces the root handlers: put them back."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in list(root.handlers):
        root.removeHandler(h)
    for h in handlers:
        root.addHandler(h)
    root.setLevel(level)


def _weights(seed):
    rng = np.random.default_rng(seed)
    return {"conv1.kernel": rng.normal(size=(3, 3, 1, 4)).astype(np.float32),
            "conv1.bias": rng.normal(size=(4,)).astype(np.float32),
            "fc.kernel": rng.normal(size=(16, 10)).astype(np.float32)}


# --- the database ----------------------------------------------------------------

def test_database_round_and_update_crud(tmp_path):
    repo = tdb.init_database(f"sqlite:///{tmp_path}/fl.db")
    repo.save_round(0, "in_progress", started_at=time.time())
    repo.save_client_update("a", 0, 100, 0.9)
    repo.save_client_update("b", 0, 300, 0.7)
    repo.save_round(0, "completed", completed_at=time.time(),
                    participating_clients=2, total_samples=400,
                    avg_training_loss=0.75, global_accuracy=0.8)
    rnd = repo.get_round(0)
    assert rnd["status"] == "completed" and rnd["total_samples"] == 400
    assert len(repo.get_round_updates(0)) == 2
    assert repo.list_rounds()[0]["round_number"] == 0
    assert repo.get_round(7) is None


def test_database_clients_failures_models(tmp_path):
    repo = tdb.init_database(f"sqlite:///{tmp_path}/fl.db")
    repo.upsert_client("c1", compute_power="high", available_samples=500)
    repo.increment_participation("c1")
    assert repo.get_client("c1")["rounds_participated"] == 1
    assert [c["client_id"] for c in repo.list_clients()] == ["c1"]
    repo.save_failure("c1", "timeout", action_taken="exclude_round",
                      round_number=2)
    assert repo.list_failures("c1")[0]["failure_type"] == "timeout"
    assert len(repo.list_failures()) == 1
    repo.save_global_model(3, "/models/round3.npz",
                           {"test_accuracy": 0.9}, 0.05)
    latest = repo.get_latest_global_model()
    assert latest["round_number"] == 3
    assert latest["model_path"].endswith(".npz")
    repo.save_system_metrics(10.0, 20.0, 30.0, active_clients=2)
    assert repo.db.query("SELECT * FROM system_metrics")[0][
        "active_clients"] == 2
    repo.db.close()


@pytest.mark.parametrize("url", ["postgresql://host/db", "mysql://h/db"])
def test_database_refusals_equal_the_reference(url):
    with pytest.raises(ValueError) as je:
        jdb.init_database(url)
    with pytest.raises(ValueError) as te:
        tdb.init_database(url)
    assert str(te.value) == str(je.value) and "sqlite" in str(te.value)


def _fill(repo):
    repo.save_round(0, "completed", started_at=1.0, completed_at=2.0,
                    participating_clients=2, total_samples=300,
                    avg_training_loss=0.5, global_accuracy=0.75,
                    convergence_score=0.1, config={"lr": 0.001})
    repo.save_client_update("a", 0, 100, 0.9, 0.25, 0.5)
    repo.upsert_client("a", compute_power="low", network_bandwidth=5,
                       available_samples=100)
    repo.increment_participation("a")
    repo.save_failure("a", "timeout", "exclude_round", 0, "late")
    repo.save_global_model(0, "/m/r0.npz", {"train_accuracy": 0.5}, 0.1)
    repo.save_system_metrics(1.0, 2.0, 3.0, 4)


_VOLATILE = {"submitted_at", "registered_at", "last_seen", "occurred_at",
             "created_at", "recorded_at"}


def _dump(repo):
    out = {}
    for table in ("training_rounds", "client_updates", "clients",
                  "client_failures", "global_models", "system_metrics"):
        out[table] = [{k: v for k, v in row.items() if k not in _VOLATILE}
                      for row in repo.db.query(f"SELECT * FROM {table}")]
    return out


@pytest.mark.parametrize("write,read", [(jdb, tdb), (tdb, jdb)],
                         ids=["reference-writes", "port-writes"])
def test_database_file_reads_in_the_other_package(tmp_path, write, read):
    url = f"sqlite:///{tmp_path}/shared.db"
    writer = write.init_database(url)
    _fill(writer)
    want = _dump(writer)
    writer.db.close()
    reader = read.init_database(url)  # CREATE IF NOT EXISTS: no change
    assert _dump(reader) == want
    assert reader.get_latest_global_model()["model_path"] == "/m/r0.npz"
    assert reader.get_client("a")["rounds_participated"] == 1
    schema = sorted(r["sql"] for r in reader.db.query(
        "SELECT sql FROM sqlite_master WHERE type='table'"))
    reader.db.close()
    other = jdb if read is tdb else tdb
    mem = other.init_database("sqlite:///:memory:")
    assert schema == sorted(r["sql"] for r in mem.db.query(
        "SELECT sql FROM sqlite_master WHERE type='table'"))


# --- persistence and the restart resume ----------------------------------------

@pytest.mark.parametrize("write,read,types", [
    (jpersist, tpersist, jtypes), (tpersist, jpersist, ttypes)],
    ids=["reference-writes", "port-writes"])
def test_persistence_restores_in_the_other_package(tmp_path, write, read,
                                                   types):
    store = write.CoordinatorPersistence(str(tmp_path / "models"))
    for rnd in range(3):
        gm = types.GlobalModel(
            round_number=rnd, model_weights=_weights(rnd),
            accuracy_metrics={"train_accuracy": 0.1 * rnd,
                              "ddp_epsilon_total": 0.5 * rnd},
            participating_clients=["a", "b"], convergence_score=0.01 * rnd)
        path = store.save_global_model(gm, train_loss=1.0 / (rnd + 1))
        assert path.endswith(f"global_model_round_{rnd}.npz")
    store.repository.db.close()
    got = read.CoordinatorPersistence(str(tmp_path / "models")).load_latest()
    assert got is not None and got[0] == 2
    model = got[1]
    want = _weights(2)
    assert set(model.model_weights) == set(want)
    for k, v in want.items():
        assert model.model_weights[k].dtype == v.dtype
        np.testing.assert_array_equal(model.model_weights[k], v)
    assert model.accuracy_metrics == {"train_accuracy": 0.2,
                                      "ddp_epsilon_total": 1.0}
    assert model.convergence_score == 0.02
    row = read.CoordinatorPersistence(
        str(tmp_path / "models")).repository.get_round(2)
    assert row["status"] == "completed" and row["global_accuracy"] == 0.2


def test_persistence_of_device_tensors_and_a_missing_file(tmp_path):
    store = tpersist.CoordinatorPersistence(str(tmp_path))
    assert store.load_latest() is None
    w = {k: torch.as_tensor(v) for k, v in _weights(1).items()}
    store.save_global_model(ttypes.GlobalModel(4, w))
    _, model = store.load_latest()
    for k, v in w.items():
        np.testing.assert_array_equal(model.model_weights[k], v.numpy())
    os.remove(tmp_path / "global_model_round_4.npz")
    assert store.load_latest() is None


def _plain_round(servicer, weights):
    from fl_tpu_torch.services import federated_learning_pb2 as pb
    from fl_tpu_torch.services.grpc_utils import ProtobufConverter

    conv = ProtobufConverter()
    for i, cid in enumerate(("a", "b")):
        servicer.RegisterClient(pb.ClientRegistration(client_id=cid), None)
        servicer.SubmitModelUpdate(conv.model_update_to_proto(
            ttypes.ModelUpdate(
                client_id=cid, round_number=servicer.current_round,
                model_weights={k: v + i for k, v in weights.items()},
                num_samples=10 * (i + 1), training_loss=0.5)), None)
    deadline = time.time() + 30
    while servicer._aggregating or servicer.pending_updates.get(
            servicer.current_round):
        assert time.time() < deadline
        time.sleep(0.02)


def test_servicer_restart_resumes_bit_equal(tmp_path):
    cfg = ttypes.RoundConfig(min_clients=2, max_clients=2)
    first = tgs.FederatedLearningServicer(
        round_config=cfg, device="cpu",
        persistence=tpersist.CoordinatorPersistence(str(tmp_path)))
    first.global_model = ttypes.GlobalModel(0, _weights(0))
    for _ in range(2):
        rnd = first.current_round
        _plain_round(first, _weights(0))
        assert first.current_round == rnd + 1
    final = {k: ttypes.to_numpy(v)
             for k, v in first.global_model.model_weights.items()}
    first.close()
    restarted = tgs.FederatedLearningServicer(
        round_config=cfg, device="cpu",
        persistence=tpersist.CoordinatorPersistence(str(tmp_path)))
    assert restarted.current_round == 2
    assert restarted.ddp_epsilon_total == 0.0
    for k, v in final.items():
        np.testing.assert_array_equal(restarted.global_model.model_weights[k],
                                      v)
    # the next round starts from the restored model and persists round 2
    _plain_round(restarted, final)
    assert restarted.current_round == 3
    assert restarted.persistence.load_latest()[0] == 2
    restarted.close()
    # the distributed-DP ledger rides the persisted model's metrics
    store = tpersist.CoordinatorPersistence(str(tmp_path / "ddp"))
    store.save_global_model(ttypes.GlobalModel(
        5, _weights(5), accuracy_metrics={"ddp_epsilon_total": 3.25}))
    ddp = tgs.FederatedLearningServicer(
        round_config=ttypes.RoundConfig(
            privacy_config=ttypes.PrivacyConfig(1.0, 1e-5)),
        secure_aggregation=True, distributed_dp=True, persistence=store,
        device="cpu")
    assert (ddp.current_round, ddp.ddp_epsilon_total) == (6, 3.25)
    ddp.close()


# --- the REST API ------------------------------------------------------------------

PKG = {
    "reference": (jtypes, jrm, jmetrics, jfailure, jrest, {}),
    "port": (ttypes, trm, tmetrics, tfailure, trest, {"device": "cpu"}),
}


def _api(name, tmp_path):
    types, rm_mod, m_mod, f_mod, rest, kw = PKG[name]
    rm = rm_mod.RoundManager(round_config=types.RoundConfig(
        min_clients=2, max_clients=3, timeout_seconds=60), **kw)
    for cid in ("a", "b", "c"):
        rm.register_client(cid, {"available_samples": 10})
    mc = m_mod.MetricsCollector()
    fh = f_mod.FailureHandler()
    api = rest.CoordinatorAPI(round_manager=rm, metrics=mc,
                              failure_handler=fh, host="127.0.0.1", port=0)
    rnd = rm.start_round(["a", "b"])
    mc.start_round(rnd.round_number)
    for i, cid in enumerate(("a", "b")):
        rm.submit_update(types.ModelUpdate(
            client_id=cid, round_number=rnd.round_number,
            model_weights={"w": np.full(4, float(i), np.float32)},
            num_samples=10, training_loss=0.5 + i))
        mc.record_client_update(rnd.round_number, cid, 10, 0.5 + i, 0.25)
    mc.complete_round(rnd.round_number, 1.0, 0.5, 0.1, 0.01)
    fh.handle_failure("c", f_mod.FailureType.TIMEOUT, round_number=1)
    fh.handle_failure("c", f_mod.FailureType.TIMEOUT, round_number=1)
    return api


_HOST_CLOCK = {"uptime_s", "timestamp", "registered_at", "last_seen",
               "started_at", "completed_at", "elapsed_s", "avg_round_time",
               "avg_round_duration_s", "estimated_completion",
               "excluded_until", "last_failure", "time"}


def _mask(obj):
    """Host-clock fields replaced by their presence."""
    if isinstance(obj, dict):
        if "__raw_text__" in obj:  # the Prometheus text
            return [ln for ln in obj["__raw_text__"].splitlines()
                    if not ln.startswith("fl_avg_round_time_seconds ")]
        return {k: ("<clock>" if k in _HOST_CLOCK and v is not None
                    else _mask(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


ROUTES = [
    ("GET", "/health", None), ("GET", "/status", None),
    ("GET", "/training/status", None), ("GET", "/training/rounds", None),
    ("GET", "/clients", None), ("GET", "/clients/a", None),
    ("GET", "/clients/ghost", None), ("GET", "/clients/c/health", None),
    ("POST", "/clients/b/exclude", {"permanent": True}),
    ("GET", "/clients/b/health", None), ("POST", "/clients/b/include", None),
    ("GET", "/metrics", None), ("GET", "/metrics/system", None),
    ("GET", "/metrics/training", None), ("GET", "/metrics/clients", None),
    ("GET", "/metrics/prometheus", None), ("GET", "/config", None),
    ("GET", "/config/privacy", None),
    ("POST", "/config/privacy", {"epsilon": 2.0, "delta": 1e-6}),
    ("GET", "/config/privacy", None),
    ("POST", "/config/privacy", {"epsilon": -1.0, "delta": 1e-6}),
    ("POST", "/config/privacy", {"bogus": 1}),
    ("GET", "/failures", None), ("GET", "/failures/statistics", None),
    ("POST", "/training/stop", None), ("POST", "/training/start", None),
    ("GET", "/training/status", None), ("POST", "/training/stop", None),
    ("GET", "/training/rounds", None), ("GET", "/teapot", None),
    ("DELETE", "/health", None), ("POST", "/admin/reset", None),
    ("GET", "/training/status", None),
]


def test_rest_routes_equal_the_reference(tmp_path):
    apis = {name: _api(name, tmp_path) for name in PKG}
    for method, path, body in ROUTES:
        got = apis["port"].handle(method, path, body)
        want = apis["reference"].handle(method, path, body)
        assert got[0] == want[0], (method, path, got, want)
        assert _mask(got[1]) == _mask(want[1]), (method, path)
    for name, api in apis.items():
        out = str(tmp_path / f"{name}.json")
        code, body = api.handle("POST", "/metrics/export", {"path": out})
        assert (code, body) == (200, {"exported": out})
        assert json.load(open(out))["rounds"][0]["participating_clients"] \
            == 2
    code, logs = apis["port"].handle("GET", "/admin/logs", None)
    assert code == 200 and isinstance(logs["logs"], list)


def test_rest_over_http_with_the_grpc_bridge(tmp_path):
    api = _api("port", tmp_path)
    servicer = tgs.FederatedLearningServicer(device="cpu")
    api.grpc_servicer = servicer
    port = api.start_server()
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(base + "/status", timeout=5) as r:
            status = json.load(r)
            assert r.headers["Access-Control-Allow-Origin"] == "*"
        assert status["grpc"] == {"current_round": 0,
                                  "registered_clients": [],
                                  "pending_updates": 0,
                                  "global_model_round": None}
        assert status["training"]["registered_clients"] == 3
        with urllib.request.urlopen(base + "/metrics/prometheus/",
                                    timeout=5) as r:
            assert "text/plain" in r.headers["Content-Type"]
            text = r.read().decode()
        assert "# TYPE fl_registered_clients gauge" in text
        assert "fl_completed_rounds 1" in text and "fl_latest_loss 1.0" in text
        req = urllib.request.Request(base + "/config/privacy",
                                     data=json.dumps({"epsilon": 3.0,
                                                      "delta": 1e-6}).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=5) as r:
            assert json.load(r)["epsilon"] == 3.0
        for path, code in (("/teapot", 404), ("/clients/ghost", 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + path, timeout=5)
            assert e.value.code == code
        bad = urllib.request.Request(base + "/training/start", data=b"{x",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=5)
        assert e.value.code == 400
    finally:
        api.stop_server()
        servicer.close()
    assert api._server is None


def test_prometheus_text_equals_the_reference(tmp_path):
    got = _api("port", tmp_path)._prometheus_text().splitlines()
    want = _api("reference", tmp_path)._prometheus_text().splitlines()
    assert [ln for ln in got if "round_time" not in ln] == \
        [ln for ln in want if "round_time" not in ln]


# --- logging, monitoring, error tracking (tests/test_aux_components.py) ---------

def test_json_formatter_carries_context():
    fmt = tlog.JSONFormatter("test-svc")
    rec = logging.LogRecord("fl.x", logging.INFO, __file__, 1, "hello %s",
                            ("world",), None)
    rec.client_id = "c9"
    rec.round_number = 4
    out = json.loads(fmt.format(rec))
    assert out["message"] == "hello world"
    assert out["client_id"] == "c9" and out["round_number"] == 4
    assert out["service"] == "test-svc"
    assert tlog.FL_CONTEXT_FIELDS == ("client_id", "round_number",
                                      "request_id", "service")


def test_setup_logging_writes_rotating_files(tmp_path, restore_root_logging):
    log_file = tmp_path / "svc.log"
    root = tlog.setup_logging(level="INFO", log_file=str(log_file),
                              service_name="t")
    logger = logging.getLogger("fl.test")
    tlog.log_federated_event(logger, "round_started", client_id="c1",
                             round_number=2, loss=0.5)
    logger.error("boom")
    for h in root.handlers:
        h.flush()
    lines = [json.loads(line) for line in
             log_file.read_text().strip().splitlines()]
    started = [ln for ln in lines if "round_started" in ln["message"]]
    assert started and started[0]["client_id"] == "c1"
    assert started[0]["round_number"] == 2 and started[0]["service"] == "t"
    err = [json.loads(line) for line in
           log_file.with_suffix(".error.log").read_text().splitlines()]
    assert [e["message"] for e in err] == ["boom"]


def test_metrics_logger(tmp_path):
    path = tmp_path / "metrics.jsonl"
    ml = tlog.MetricsLogger(str(path))
    ml.log_round_metrics(3, {"loss": 0.5, "accuracy": 0.9})
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(lines) == 2
    assert lines[0]["tags"]["round"] == 3
    assert [ln["metric"] for ln in lines] == ["loss", "accuracy"]


def test_system_metrics_sample():
    m = tmon.collect_system_metrics()
    assert m.timestamp > 0
    assert 0 <= m.cpu_percent <= 100
    assert [f for f in tmon.SystemMetrics.__dataclass_fields__] == \
        [f for f in jmon.SystemMetrics.__dataclass_fields__]


@pytest.mark.parametrize("metrics", [
    {"cpu_percent": 95.0, "memory_percent": 10.0, "disk_percent": 10.0,
     "latency_ms": 9000.0},
    {"cpu_percent": 10.0},
    {"memory_percent": 85.5, "disk_percent": 99.0},
])
def test_alert_rules_equal_the_reference(metrics):
    verdicts = []
    for mon in (tmon, jmon):
        mgr = mon.AlertManager()
        fired = []
        mgr.on_alert(fired.append)
        mgr.on_alert(lambda a: 1 / 0)  # a failing callback is logged
        alerts = mgr.evaluate(metrics)
        assert len(fired) == len(alerts) == len(mgr.alert_history)
        verdicts.append([(a.name, a.severity, a.message, a.threshold)
                         for a in alerts])
    assert verdicts[0] == verdicts[1]


def test_custom_alert_rule_and_monitor():
    mgr = tmon.AlertManager(rules=[])
    mgr.add_rule(tmon.AlertRule("low_acc", "accuracy", 0.5,
                                comparator="lt"))
    assert mgr.evaluate({"accuracy": 0.3})
    assert not mgr.evaluate({"accuracy": 0.9})
    pm = tmon.PerformanceMonitor(interval_s=100)
    pm.collector.record_communication(tmon.CommunicationMetrics(
        timestamp=time.time(), operation="submit_update", latency_ms=6000.0,
        payload_bytes=10, success=True))
    alerts = pm.check()
    assert "high_latency" in {a.name for a in alerts}
    assert pm.collector.latest() is not None
    pm.start()
    pm.stop()


@pytest.mark.parametrize("exc", [
    ConnectionError("connection refused by peer"),
    ValueError("privacy budget exhausted"),
    RuntimeError("training diverged with nan loss"),
    MemoryError("out of memory"), KeyError("unknown model"),
    ValueError("fedavg insufficient clients"), OSError("weird"),
])
def test_error_categorization_equals_the_reference(exc):
    t, j = terr.ErrorTracker(), jerr.ErrorTracker()
    got, want = t.track_error(exc), j.track_error(exc)
    assert (got.category.value, got.severity.value, got.signature) == \
        (want.category.value, want.severity.value, want.signature)


def test_error_dedup_and_patterns():
    t = terr.ErrorTracker()
    for _ in range(5):
        t.track_error(TimeoutError("connection timeout"), client_id="c")
    summary = t.get_error_summary()
    assert summary["unique_errors"] == 1
    assert summary["total_errors"] == 5
    assert summary["by_category"] == {"network": 5}
    patterns = t.detect_error_patterns()
    assert patterns and patterns[0].count == 5
    assert summary["patterns"] == [patterns[0].signature]


def test_error_handler_context_manager():
    h = terr.create_error_handler()
    with pytest.raises(RuntimeError):
        with h.capture(client_id="cx", round_number=1):
            raise RuntimeError("training diverged with nan loss")
    with h.capture(reraise=False):
        raise ValueError("invalid shape")
    summary = h.tracker.get_error_summary()
    assert summary["total_errors"] == 2
    # "nan" is a validation keyword, checked before the training ones
    assert summary["by_category"] == {"validation": 2}


# --- the two command lines' services, in process ---------------------------------

def test_coordinator_and_client_services_run_a_round(tmp_path):
    from fl_tpu_torch.services import client_main, coordinator_main

    coord = coordinator_main.CoordinatorService({
        "server": {"host": "127.0.0.1", "grpc_port": 0, "http_port": 0},
        "training": {"min_clients": 2, "max_clients": 2, "local_epochs": 1,
                     "batch_size": 16, "learning_rate": 0.001,
                     "auto_start": False},
        "privacy": {"enabled": True, "epsilon": 8.0, "delta": 1e-5,
                    "max_grad_norm": 1.0, "noise_multiplier": 1.0},
        "storage": {"model_dir": str(tmp_path / "models")},
    }, device="cpu")
    coord.start()
    order = []
    for name in ("rest_api", "grpc_server", "metrics_tracker",
                 "round_manager", "database"):
        comp = getattr(coord, name)
        stop = "stop_server" if name == "rest_api" else (
            "close" if name == "database" else "stop")
        inner = getattr(comp, stop)

        def wrapped(*a, _inner=inner, _name=name, **kw):
            order.append(_name)
            return _inner(*a, **kw)

        setattr(comp, stop, wrapped)
    clients, threads = [], []
    try:
        for i in range(2):
            svc = client_main.ClientService({
                "client": {"id": f"cli_{i}", "coordinator_host": "127.0.0.1",
                           "coordinator_port": coord.grpc_server.port},
                "privacy": {"enabled": True, "epsilon": 8.0,
                            "delta": 1e-5},
                "data": {"num_clients": 64, "partition_strategy": "iid"},
            }, device="cpu")
            th = threading.Thread(target=svc.start, daemon=True)
            th.start()
            clients.append(svc)
            threads.append(th)
        servicer = coord.grpc_server.servicer
        deadline = time.time() + 120
        while servicer.current_round < 1 or any(
                c.trainer is None or c.trainer.rounds_completed < 1
                for c in clients):
            assert time.time() < deadline, "the round did not complete"
            time.sleep(0.05)
        base = f"http://127.0.0.1:{coord.rest_api.port}"
        with urllib.request.urlopen(base + "/health", timeout=5) as r:
            assert json.load(r)["status"] == "healthy"
        with urllib.request.urlopen(base + "/status", timeout=5) as r:
            grpc_view = json.load(r)["grpc"]
        assert grpc_view["registered_clients"] == ["cli_0", "cli_1"]
        assert grpc_view["global_model_round"] == 0
        with urllib.request.urlopen(base + "/metrics/prometheus",
                                    timeout=5) as r:
            assert "fl_current_round" in r.read().decode()
        assert coord.grpc_server.servicer.persistence.load_latest()[0] == 0
        for c in clients:
            h = c.trainer.training_history[0]
            assert h["epsilon_used"] == 8.0 and np.isfinite(h["loss"])
    finally:
        for c in clients:
            c.stop()
        for th in threads:
            th.join(timeout=30)
        coord.stop()
    assert order == ["rest_api", "grpc_server", "metrics_tracker",
                     "round_manager", "database"]
    assert not any(th.is_alive() for th in threads)


def test_command_lines_parse_their_arguments(monkeypatch):
    from fl_tpu_torch.services import client_main, coordinator_main

    seen = {}

    class Stop(Exception):
        pass

    def fake(cls_name):
        def init(self, config, device=None):
            seen[cls_name] = (config, device)
            raise Stop

        return init

    monkeypatch.setattr(coordinator_main.CoordinatorService, "__init__",
                        fake("coordinator"))
    monkeypatch.setattr(client_main.ClientService, "__init__",
                        fake("client"))
    monkeypatch.setenv("COORDINATOR_HOST", "example-host")
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        with pytest.raises(Stop):
            coordinator_main.main(["--device", "cpu", "--log-level",
                                   "WARNING"])
        with pytest.raises(Stop):
            client_main.main(["--client-id", "z9", "--device", "cpu"])
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
        for h in handlers:
            root.addHandler(h)
        root.setLevel(level)
    cfg, device = seen["coordinator"]
    assert device == "cpu" and cfg["server"]["grpc_port"] == 50051
    cfg, device = seen["client"]
    assert device == "cpu" and cfg["client"]["id"] == "z9"
    assert cfg["client"]["coordinator_host"] == "example-host"
