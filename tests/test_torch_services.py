"""The port's host side of the deployment round against the reference's,
on the CPU: the payload validator, the host FedAvg and robust aggregators,
the round manager, the failure handler, the wire codecs, the proto
converter, the local trainer, the YAML config and the capability adapter.

Every comparison feeds the same numpy inputs, made from a seed, to the
reference (``fl_tpu``) and to the port (``fl_tpu_torch``, ``device="cpu"``):
verdicts, messages, stats and metadata equal; averaged weights within
rtol 1e-6 (the port reduces in f32 on its device as the reference does on
its default JAX device). The round-manager and failure-handler cases of
``tests/test_coordinator_components.py`` run on both packages. The import
of the modules a card's machine runs, without ``grpcio`` or ``protobuf``,
is checked in a subprocess whose ``sys.modules`` hides both.
"""

import dataclasses
import logging
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from google.protobuf.json_format import MessageToDict

import fl_tpu.core.types as jtypes
import fl_tpu.fl.fedavg as jfedavg
import fl_tpu.fl.robust_agg as jrobust
import fl_tpu.orchestration.failure as jfailure
import fl_tpu.orchestration.round_manager as jrm
import fl_tpu.services.capability_adapter as jcap
import fl_tpu.services.config as jconfig
import fl_tpu.services.grpc_utils as jgu
import fl_tpu.services.serialization as jser
import fl_tpu.utils.validation as jval
import fl_tpu_torch.core.types as ttypes
import fl_tpu_torch.fl.fedavg as tfedavg
import fl_tpu_torch.fl.robust_agg as trobust
import fl_tpu_torch.orchestration.failure as tfailure
import fl_tpu_torch.orchestration.round_manager as trm
import fl_tpu_torch.services.capability_adapter as tcap
import fl_tpu_torch.services.config as tconfig
import fl_tpu_torch.services.grpc_utils as tgu
import fl_tpu_torch.services.serialization as tser
import fl_tpu_torch.utils.validation as tval

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
SHAPES = {"params/conv/kernel": (3, 3, 1, 4), "params/conv/bias": (4,),
          "params/fc/kernel": (16, 10)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests on one intra-op thread, restored after it:
    several test processes share the CPU under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def weights(seed, scale=0.1, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in shapes.items()}


def updates(types, n=4, seed=0, metrics=True, round_number=0, **kw):
    """``n`` updates of the same numpy weights in ``types``' classes."""
    rng = np.random.default_rng(seed + 100)
    out = []
    for i in range(n):
        tm = (types.TrainingMetrics(
            loss=0.5 + 0.1 * i, accuracy=0.2 + 0.05 * i,
            epochs_completed=1, training_time=0.1,
            samples_processed=10) if metrics and i % 2 == 0 else None)
        out.append(types.ModelUpdate(
            client_id=f"c{i}", round_number=round_number,
            model_weights=weights(seed + i), num_samples=int(
                rng.integers(10, 200)),
            training_loss=float(0.3 + 0.2 * i), training_metrics=tm, **kw))
    return out


def assert_weights_close(got, want, rtol=1e-6):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(ttypes.to_numpy(got[k]),
                                   np.asarray(want[k]), rtol=rtol,
                                   atol=1e-7, err_msg=k)


def messages(caplog, name):
    return [r.getMessage() for r in caplog.records if r.name == name]


# --- the payload validator ---------------------------------------------------

def _validation_cases(types):
    base = weights(1)
    big = dict(base, **{"params/fc/kernel": np.full((16, 10), 11.0,
                                                    np.float32)})
    nan = dict(base, **{"params/conv/bias": np.asarray(
        [0.0, np.nan, 0.0, 0.0], np.float32)})
    now = time.time()
    mk = types.ModelUpdate
    return [
        mk("ok", 0, base, 10, 0.5, timestamp=now),
        mk("big", 0, big, 10, 0.5, timestamp=now),
        mk("big_dp", 0, big, 10, 0.5, privacy_budget_used=0.5,
           timestamp=now),
        mk("nan", 0, nan, 10, 0.5, timestamp=now),
        mk("nan_dp", 0, nan, 10, 0.5, privacy_budget_used=0.5,
           timestamp=now),
        mk("old", 0, base, 10, 0.5, timestamp=now - 2 * 24 * 3600),
        mk("future", 0, base, 10, 0.5, timestamp=now + 3600),
        mk("", 0, base, 10, 0.5, timestamp=now),
        mk("neg_round", -1, base, 10, 0.5, timestamp=now),
        mk("no_samples", 0, base, 0, 0.5, timestamp=now),
        mk("budget", 0, base, 10, 0.5, privacy_budget_used=1.5,
           timestamp=now),
        mk("ratio", 0, base, 10, 0.5, compression_ratio=2.0, timestamp=now),
    ]


def test_update_validator_verdicts_and_messages(caplog):
    caplog.set_level(logging.WARNING)
    jv, tv = jval.ModelUpdateValidator(), tval.ModelUpdateValidator()
    want = [jv.validate_model_update(u) for u in _validation_cases(jtypes)]
    got = [tv.validate_model_update(u) for u in _validation_cases(ttypes)]
    assert got == want
    assert want == [True, False, True, False, False, False, False, False,
                    False, False, False, False]
    assert messages(caplog, "fl_tpu_torch.utils.validation") == \
        messages(caplog, "fl_tpu.utils.validation")
    # tensors are read where they lie
    u = _validation_cases(ttypes)[1]
    u.model_weights = {k: torch.as_tensor(v)
                       for k, v in u.model_weights.items()}
    assert not tv.validate_model_update(u)


def test_other_validators_and_compatibility():
    for eps, delta, c in [(1.0, 1e-5, 1.0), (200.0, 1e-5, 1.0),
                          (1.0, 1e-5, 500.0)]:
        got = tval.PrivacyConfigValidator().validate_privacy_config(
            ttypes.PrivacyConfig(eps, delta, c))
        want = jval.PrivacyConfigValidator().validate_privacy_config(
            jtypes.PrivacyConfig(eps, delta, c))
        assert got == want
    for bw, n in [(10, 100), (0, 100), (10, 0)]:
        got = tval.ClientCapabilitiesValidator().validate_capabilities(
            ttypes.ClientCapabilities(ttypes.ComputePowerLevel.LOW, bw, n))
        want = jval.ClientCapabilitiesValidator().validate_capabilities(
            jtypes.ClientCapabilities(jtypes.ComputePowerLevel.LOW, bw, n))
        assert got == want
    for acc, score in [(0.5, 0.2), (1.5, 0.2), (0.5, 2.0)]:
        got = tval.GlobalModelValidator().validate_global_model(
            ttypes.GlobalModel(1, weights(0), {"test_accuracy": acc},
                               convergence_score=score))
        want = jval.GlobalModelValidator().validate_global_model(
            jtypes.GlobalModel(1, weights(0), {"test_accuracy": acc},
                               convergence_score=score))
        assert got == want
    a = weights(0)
    for b in (dict(a, extra=np.zeros(2)),
              dict(a, **{"params/conv/bias": np.zeros(5)})):
        with pytest.raises(jval.ValidationError) as je:
            jval.validate_model_compatibility(a, b)
        with pytest.raises(tval.ValidationError) as te:
            tval.validate_model_compatibility(
                a, {k: torch.as_tensor(v) for k, v in b.items()})
        assert str(te.value) == str(je.value)
    cfg = {"min_clients": 0, "max_clients": -1, "local_epochs": 0,
           "batch_size": 0, "learning_rate": 2.0, "timeout_seconds": 0}
    assert tval.validate_training_round_config(cfg) == \
        jval.validate_training_round_config(cfg)


def test_dp_widened_validator_equals_the_servicer_bound():
    from fl_tpu.services.grpc_server import FederatedLearningServicer

    for eps, delta, c in [(1.0, 1e-5, 1.0), (3.0, 1e-5, 0.5),
                          (0.1, 1e-6, 4.0)]:
        ref = FederatedLearningServicer(round_config=jtypes.RoundConfig(
            privacy_config=jtypes.PrivacyConfig(eps, delta, c)))
        got = tval.dp_widened_validator(ttypes.PrivacyConfig(eps, delta, c))
        assert got.max_abs_weight == ref.aggregator.validator.max_abs_weight


# --- the host FedAvg aggregators ------------------------------------------------

def _stats(agg):
    s = agg.get_aggregation_stats()
    s.pop("avg_aggregation_time", None)
    return s


@pytest.mark.parametrize("case", ["samples", "weights", "max_clients",
                                  "incompatible", "invalid"])
def test_fedavg_aggregator_equals_the_reference(case):
    kw, call = {}, {}
    ups = (updates(jtypes), updates(ttypes))
    if case == "weights":
        call = {"weights": [0.1, 0.4, 0.2, 0.3]}
    elif case == "max_clients":
        kw = {"max_clients": 2}
    elif case == "incompatible":
        for u in (ups[0][2], ups[1][2]):
            u.model_weights = dict(u.model_weights, extra=np.ones(3))
    elif case == "invalid":
        for u in (ups[0][1], ups[1][1]):
            u.model_weights["params/fc/kernel"][0, 0] = np.inf
    ja = jfedavg.FedAvgAggregator(**kw)
    ta = tfedavg.FedAvgAggregator(device="cpu", **kw)
    want = ja.aggregate_updates(ups[0], **call)
    got = ta.aggregate_updates(ups[1], **call)
    assert all(isinstance(v, torch.Tensor)
               for v in got.model_weights.values())
    assert_weights_close(got.model_weights, want.model_weights)
    assert got.accuracy_metrics == pytest.approx(want.accuracy_metrics,
                                                 rel=1e-6)
    assert got.participating_clients == want.participating_clients
    assert got.round_number == want.round_number
    ts, js = _stats(ta), _stats(ja)
    assert ts.keys() == js.keys()
    assert ts["avg_training_loss"] == pytest.approx(js["avg_training_loss"],
                                                    rel=1e-6)
    for k in ("total_aggregations", "avg_clients_per_round",
              "avg_samples_per_round", "client_participation"):
        assert ts[k] == js[k], k
    prev_w = ttypes.GlobalModel(0, weights(9))
    prev_j = jtypes.GlobalModel(0, weights(9))
    assert ta.calculate_convergence_metrics(prev_w, got) == pytest.approx(
        ja.calculate_convergence_metrics(prev_j, want), rel=1e-5)
    assert ta.calculate_convergence_metrics(None, got) == 1.0


def test_fedavg_errors_equal_the_reference():
    cases = [
        ([], None, {}),
        (None, [1.0], {}),
        (None, [1.0, -1.0, 1.0, 1.0], {}),
        (None, [0.0, 0.0, 0.0, 0.0], {}),
        (None, None, {"min_clients": 5}),
    ]
    for ups, w, kw in cases:
        with pytest.raises(jfedavg.FedAvgError) as je:
            jfedavg.FedAvgAggregator(**kw).aggregate_updates(
                updates(jtypes) if ups is None else ups, w)
        with pytest.raises(tfedavg.FedAvgError) as te:
            tfedavg.FedAvgAggregator(device="cpu", **kw).aggregate_updates(
                updates(ttypes) if ups is None else ups, w)
        assert str(te.value) == str(je.value)
    assert _stats(tfedavg.FedAvgAggregator(device="cpu")) == \
        _stats(jfedavg.FedAvgAggregator())


def test_adaptive_fedavg_equals_the_reference():
    ja = jfedavg.create_fedavg_aggregator("adaptive", performance_weight=0.3)
    ta = tfedavg.create_fedavg_aggregator("adaptive", performance_weight=0.3,
                                          device="cpu")
    assert isinstance(ta, tfedavg.AdaptiveFedAvg)
    for r in range(3):
        want = ja.aggregate_updates(updates(jtypes, seed=r, round_number=r))
        got = ta.aggregate_updates(updates(ttypes, seed=r, round_number=r))
        assert_weights_close(got.model_weights, want.model_weights)
        assert ta._adaptive_weights(updates(ttypes, seed=r)) == \
            pytest.approx(ja._adaptive_weights(updates(jtypes, seed=r)),
                          rel=1e-12)
    assert ta.client_performance_history == ja.client_performance_history
    assert isinstance(tfedavg.create_fedavg_aggregator(device="cpu"),
                      tfedavg.FedAvgAggregator)


def test_fedavg_stacked_and_convergence_score():
    rng = np.random.default_rng(3)
    stacked = {"a": rng.normal(size=(5, 7, 3)).astype(np.float32),
               "b": rng.normal(size=(5, 4)).astype(np.float32)}
    counts = rng.integers(1, 50, 5).astype(np.float32)
    want = jfedavg.fedavg_stacked(stacked, counts)
    got = tfedavg.fedavg_stacked(
        {k: torch.as_tensor(v) for k, v in stacked.items()},
        torch.as_tensor(counts))
    assert_weights_close(got, want)
    old, new = weights(1), weights(2)
    assert float(tfedavg.convergence_score(
        {k: torch.as_tensor(v) for k, v in old.items()},
        {k: torch.as_tensor(v) for k, v in new.items()})) == pytest.approx(
        float(jfedavg.convergence_score(old, new)), rel=1e-6)
    res = tfedavg.benchmark_aggregation_performance((2, 3), 4000,
                                                    device="cpu")
    assert set(res) == {"2_clients", "3_clients"}
    assert set(res["2_clients"]) == {"aggregation_time", "throughput",
                                     "memory_usage"}


@pytest.mark.parametrize("method,kw", [
    ("median", {}), ("trimmed_mean", {"trim_k": 1, "min_clients": 3}),
    ("krum", {"krum_f": 1, "krum_m": 2, "min_clients": 5})])
def test_robust_aggregator_equals_the_reference(method, kw):
    ja = jrobust.RobustAggregator(method=method, **kw)
    ta = trobust.RobustAggregator(method=method, device="cpu", **kw)
    n = 6 if method == "krum" else 5
    want = ja.aggregate_updates(updates(jtypes, n=n, seed=4))
    got = ta.aggregate_updates(updates(ttypes, n=n, seed=4))
    assert_weights_close(got.model_weights, want.model_weights)
    assert got.accuracy_metrics == pytest.approx(want.accuracy_metrics)
    assert got.participating_clients == want.participating_clients
    assert ta.aggregation_history[-1]["avg_training_loss"] == pytest.approx(
        ja.aggregation_history[-1]["avg_training_loss"])
    with pytest.raises(jfedavg.FedAvgError) as je:
        ja.aggregate_updates(updates(jtypes, n=1))
    with pytest.raises(tfedavg.FedAvgError) as te:
        ta.aggregate_updates(updates(ttypes, n=1))
    assert str(te.value) == str(je.value)


def test_robust_aggregator_refusals_equal_the_reference():
    for kw in ({"method": "mean"}, {"method": "trimmed_mean", "trim_k": 1},
               {"method": "krum", "krum_f": 2, "min_clients": 5}):
        with pytest.raises(ValueError) as je:
            jrobust.RobustAggregator(**kw)
        with pytest.raises(ValueError) as te:
            trobust.RobustAggregator(device="cpu", **kw)
        assert str(te.value) == str(je.value)


# --- the round manager (tests/test_coordinator_components.py:40-135) --------------

PACKAGES = {
    "fl_tpu": (jtypes, jrm, {}),
    "fl_tpu_torch": (ttypes, trm, {"device": "cpu"}),
}


def _upd(types, cid, rnd, val, n=100, loss=0.5):
    return types.ModelUpdate(
        client_id=cid, round_number=rnd,
        model_weights={"layer/w": np.full((4, 4), val, np.float32)},
        num_samples=n, training_loss=loss)


def _manager(pkg, timeout=5, **kw):
    types, rm, dev = PACKAGES[pkg]
    cfg = types.RoundConfig(min_clients=2, max_clients=10,
                            timeout_seconds=timeout)
    return types, rm, rm.RoundManager(round_config=cfg, **dev, **kw)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_round_lifecycle_completes(pkg):
    types, rm, m = _manager(pkg)
    for c in ("a", "b", "c"):
        m.register_client(c)
    rnd = m.start_round()
    assert rnd.state == rm.RoundState.IN_PROGRESS
    assert set(rnd.selected_clients) == {"a", "b", "c"}
    m.submit_update(_upd(types, "a", 0, 1.0, n=100))
    m.submit_update(_upd(types, "b", 0, 3.0, n=300))
    assert m.submit_update(_upd(types, "c", 0, 2.0, n=100))
    assert m.current_round is None
    assert m.round_history[-1].state == rm.RoundState.COMPLETED
    # weighted mean: (100*1 + 300*3 + 100*2)/500 = 2.4
    np.testing.assert_allclose(
        ttypes.to_numpy(m.global_model.model_weights["layer/w"]), 2.4,
        rtol=1e-6)
    assert m.global_model.participating_clients == ["a", "b", "c"]
    assert m.registered_clients["b"]["rounds_participated"] == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_round_rejects_stale_and_double_start(pkg):
    types, _, m = _manager(pkg)
    m.register_client("a")
    m.register_client("b")
    m.start_round()
    assert not m.submit_update(_upd(types, "a", 99, 1.0))
    with pytest.raises(RuntimeError, match="already in progress"):
        m.start_round()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_round_requires_min_clients(pkg):
    _, _, m = _manager(pkg)
    m.register_client("only")
    with pytest.raises(RuntimeError, match="not enough clients: 1 < 2"):
        m.start_round()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_timeout_aggregates_if_min_reached(pkg):
    types, rm, m = _manager(pkg, timeout=0)
    for c in ("a", "b", "c"):
        m.register_client(c)
    rnd = m.start_round()
    m.submit_update(_upd(types, "a", 0, 1.0))
    m.submit_update(_upd(types, "b", 0, 1.0))
    m._handle_round_timeout(rnd)
    assert m.round_history[-1].state == rm.RoundState.COMPLETED
    assert rnd.client_states["c"] == rm.ClientRoundState.DROPPED


@pytest.mark.parametrize("pkg", PACKAGES)
def test_timeout_fails_below_min(pkg):
    types, rm, m = _manager(pkg, timeout=0)
    failed = []
    m.on_round_failed.append(lambda r: failed.append(
        (r.round_number, r.failure_reason)))
    for c in ("a", "b"):
        m.register_client(c)
    rnd = m.start_round()
    m.submit_update(_upd(types, "a", 0, 1.0))
    m._handle_round_timeout(rnd)
    assert m.round_history[-1].state == rm.RoundState.FAILED
    assert failed == [(0, "timeout with only 1 updates")]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_management_loop_auto_start(pkg):
    _, _, m = _manager(pkg, auto_start=True, tick_interval_s=0.05)
    m.register_client("a")
    m.register_client("b")
    m.start()
    try:
        deadline = time.time() + 3
        while time.time() < deadline and m.current_round is None:
            time.sleep(0.05)
        assert m.current_round is not None
    finally:
        m.stop()
    assert m._thread is None


def test_status_reporting_equals_the_reference():
    got = []
    for pkg in PACKAGES:
        types, _, m = _manager(pkg)
        for c in ("a", "b"):
            m.register_client(c)
        m.start_round()
        s0 = m.get_training_status()
        assert s0["round_state"] == "in_progress"
        assert s0["registered_clients"] == 2
        m.submit_update(_upd(types, "a", 0, 1.0, loss=0.4))
        m.submit_update(_upd(types, "b", 0, 2.0, loss=0.6))
        s1 = m.get_training_status()
        assert s1["completed_rounds"] == 1
        for s in (s0, s1):
            s.pop("avg_round_time")
        hist = m.get_round_history()
        for h in hist:
            h.pop("elapsed_s")
        got.append((s0, s1, hist, m.global_model.convergence_score,
                    m.detector.get_convergence_summary()))
    (j0, j1, jh, jc, jd), (t0, t1, th, tc, td) = got
    assert (t0, t1, th) == (j0, j1, jh)
    assert tc == pytest.approx(jc, rel=1e-6)
    assert td.keys() == jd.keys()


# --- the failure handler ---------------------------------------------------------

FAILURE = {"fl_tpu": jfailure, "fl_tpu_torch": tfailure}


@pytest.mark.parametrize("pkg", FAILURE)
def test_failure_policy_and_patterns(pkg):
    f = FAILURE[pkg]
    h = f.FailureHandler()
    assert h.handle_failure("c1", f.FailureType.CONNECTION_LOST) == \
        f.FailureAction.RETRY
    assert h.handle_failure("c2", f.FailureType.TIMEOUT) == \
        f.FailureAction.EXCLUDE_ROUND
    assert h.handle_failure("c3", f.FailureType.RESOURCE_EXHAUSTION) == \
        f.FailureAction.REDUCE_LOAD
    assert h.handle_failure("evil", f.FailureType.PRIVACY_VIOLATION) == \
        f.FailureAction.EXCLUDE_PERMANENT
    assert "evil" in h.get_excluded_clients()
    assert h.get_healthy_clients(["evil", "good"]) == ["good"]
    acts = [h.handle_failure("flaky", f.FailureType.TRAINING_ERROR)
            for _ in range(3)]
    assert acts[0] == f.FailureAction.RETRY
    assert acts[2] == f.FailureAction.EXCLUDE_TEMPORARY
    assert "repeated_training_error" in h.tracker.get_health(
        "flaky")["patterns"]


@pytest.mark.parametrize("pkg", FAILURE)
def test_failure_exclusions_and_health(pkg):
    f = FAILURE[pkg]
    h = f.FailureHandler(temporary_exclusion_s=0.1)
    h.handle_failure("slow", f.FailureType.PROTOCOL_ERROR)
    assert "slow" in h.get_excluded_clients()
    time.sleep(0.15)
    assert "slow" not in h.get_excluded_clients()
    h.exclude_client("ops", permanent=True)
    assert "ops" in h.get_excluded_clients()
    h.include_client("ops")
    assert "ops" not in h.get_excluded_clients()
    h.handle_failure("c", f.FailureType.TIMEOUT)
    low = h.tracker.get_health("c")["health_score"]
    for _ in range(5):
        h.record_success("c")
    assert h.tracker.get_health("c")["health_score"] > low


def test_failure_statistics_equal_the_reference():
    stats = []
    for f in FAILURE.values():
        h = f.FailureHandler()
        for cid, kind in [("a", "TIMEOUT"), ("b", "PRIVACY_VIOLATION"),
                          ("a", "TIMEOUT"), ("c", "UNKNOWN"),
                          ("c", "INVALID_UPDATE")]:
            h.handle_failure(cid, f.FailureType[kind])
        s = h.get_failure_statistics()
        s["health"] = [h.tracker.get_health(c)["health_score"]
                       for c in "abc"]
        stats.append(s)
    assert stats[1] == stats[0]


# --- the wire codecs, both ways ----------------------------------------------------

def _fixture_weights():
    with np.load(os.path.join(FIXTURES, "ref_weights_expected.npz")) as z:
        return {k: z[k] for k in z.files}


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


@pytest.mark.parametrize("codec", ["npz", "torch"])
def test_codecs_decode_in_the_other_package(codec):
    w = dict(weights(5), steps=np.arange(6, dtype=np.int32).reshape(2, 3),
             half=np.linspace(0, 1, 8).astype(np.float16))
    for enc, dec in ((tser, jser), (jser, tser)):
        data = enc.ModelWeightSerializer(codec).serialize_weights(w)
        _equal(dec.ModelWeightSerializer().deserialize_weights(data), w)
        hex_str = enc.ModelWeightSerializer(codec).serialize_weights_hex(w)
        _equal(dec.ModelWeightSerializer().deserialize_weights_hex(hex_str),
               w)
    # tensors (any device) go through the host
    tw = {k: torch.as_tensor(v) for k, v in w.items()}
    data = tser.ModelWeightSerializer(codec).serialize_weights(tw)
    _equal(jser.ModelWeightSerializer().deserialize_weights(data), w)
    assert tser.validate_serialization_roundtrip(tw, codec)


@pytest.mark.parametrize("fixture", ["ref_weights_torch.bin",
                                     "ref_weights_torch_legacy.bin"])
def test_reference_fixtures_decode_in_the_port(fixture):
    data = open(os.path.join(FIXTURES, fixture), "rb").read()
    _equal(tser.ModelWeightSerializer().deserialize_weights(data),
           _fixture_weights())
    hex_str = open(os.path.join(FIXTURES, "ref_weights_torch_hex.txt")).read()
    _equal(tgu.ProtobufConverter().weights_from_bytes(hex_str.encode()),
           _fixture_weights())


def test_compressed_pickle_package_is_refused_with_the_reference_message():
    import pickle
    import zlib

    blob = pickle.dumps({"compressed_data": zlib.compress(b"x" * 64),
                         "metadata": {"algorithm": "zlib"}})
    with pytest.raises(jser.SerializationError) as je:
        jser.ModelWeightSerializer().deserialize_weights(blob)
    with pytest.raises(tser.SerializationError) as te:
        tser.ModelWeightSerializer().deserialize_weights(blob)
    assert str(te.value) == str(je.value)
    with pytest.raises(tser.SerializationError, match="Unknown codec"):
        tser.ModelWeightSerializer("pickle")


def test_envelope_serializers_equal_the_reference():
    up = (updates(jtypes, n=1)[0], updates(ttypes, n=1)[0])
    up[0].timestamp = up[1].timestamp = 1234.5
    dj = jser.ModelUpdateSerializer().serialize_model_update(up[0])
    dt = tser.ModelUpdateSerializer().serialize_model_update(up[1])
    assert {k: v for k, v in dt.items() if k != "model_weights"} == \
        {k: v for k, v in dj.items() if k != "model_weights"}
    back = jser.ModelUpdateSerializer().deserialize_model_update(dt)
    _equal(back.model_weights, up[0].model_weights)
    back = tser.ModelUpdateSerializer().deserialize_model_update(dj)
    assert isinstance(back, ttypes.ModelUpdate)
    _equal(back.model_weights, up[0].model_weights)
    gm = ttypes.GlobalModel(3, {k: torch.as_tensor(v)
                                for k, v in weights(2).items()},
                            {"train_accuracy": 0.5}, ["a"], 0.1, 99.0)
    dg = tser.GlobalModelSerializer().serialize_global_model(gm)
    back = jser.GlobalModelSerializer().deserialize_global_model(dg)
    _equal(back.model_weights, weights(2))
    assert (back.round_number, back.accuracy_metrics,
            back.participating_clients, back.created_at) == (
        3, {"train_accuracy": 0.5}, ["a"], 99.0)
    obj = {"a": 1, "b": [1, 2]}
    assert tser.CompactSerializer.deserialize(
        tser.CompactSerializer.serialize(obj)) == obj
    assert tser.CompactSerializer.serialize(obj) == \
        jser.CompactSerializer.serialize(obj)


# --- the proto converter -------------------------------------------------------------

def _dict(msg):
    d = MessageToDict(msg, preserving_proto_field_name=True)
    d.pop("model_weights", None)
    return d


def _pair(build):
    return build(jtypes), build(ttypes)


def test_protobuf_converter_messages_equal_field_for_field():
    jc, tc = jgu.ProtobufConverter(), tgu.ProtobufConverter()
    pc = _pair(lambda t: t.PrivacyConfig(2.0, 1e-6, 0.5, 1.1))
    assert _dict(tc.privacy_config_to_proto(pc[1])) == \
        _dict(jc.privacy_config_to_proto(pc[0]))
    caps = _pair(lambda t: t.ClientCapabilities(
        t.ComputePowerLevel.HIGH, 25, 321, ["simple_cnn"],
        t.PrivacyConfig(1.0, 1e-5)))
    assert _dict(tc.client_capabilities_to_proto(caps[1])) == \
        _dict(jc.client_capabilities_to_proto(caps[0]))
    ups = _pair(lambda t: t.ModelUpdate(
        "c", 3, weights(1), 10, 0.25, 0.5, 0.75, 1234.0,
        t.TrainingMetrics(0.3, 0.7, 1, 2.5, 40,
                          {"adaptive_clip_indicator": 0.875})))
    mj, mt = jc.model_update_to_proto(ups[0]), tc.model_update_to_proto(
        ups[1])
    assert _dict(mt) == _dict(mj)
    _equal(jc.weights_from_bytes(mt.model_weights), weights(1))
    back = tc.model_update_from_proto(mj)
    want = jc.model_update_from_proto(mj)
    _equal(back.model_weights, want.model_weights)
    assert dataclasses.asdict(back.training_metrics) == \
        dataclasses.asdict(want.training_metrics)
    for f in ("client_id", "round_number", "num_samples", "training_loss",
              "privacy_budget_used", "compression_ratio", "timestamp"):
        assert getattr(back, f) == getattr(want, f), f
    gms = _pair(lambda t: t.GlobalModel(2, weights(3),
                                        {"train_accuracy": 0.25}))
    gj = jc.global_model_to_proto(gms[0], message="m")
    gt = tc.global_model_to_proto(gms[1], message="m")
    assert _dict(gt) == _dict(gj)
    g_back = tc.global_model_from_proto(gj)
    assert (g_back.round_number, g_back.accuracy_metrics) == (
        2, {"train_accuracy": 0.25})
    _equal(g_back.model_weights, weights(3))
    rcs = _pair(lambda t: t.RoundConfig(
        4, 3, 9, 2, 16, 0.01, 60, "sgd", t.PrivacyConfig(1.0, 1e-5),
        {"k": "v"}))
    rj, rt = jc.round_config_to_proto(rcs[0]), tc.round_config_to_proto(
        rcs[1])
    assert _dict(rt) == _dict(rj)
    assert dataclasses.asdict(tc.round_config_from_proto(rj)) == \
        dataclasses.asdict(jc.round_config_from_proto(rj))
    sts = _pair(lambda t: t.TrainingStatus(5, 3, 0.5, 0.75, 0.1, 77.0))
    sj = jc.training_status_to_proto(sts[0])
    st = tc.training_status_to_proto(sts[1])
    assert _dict(st) == _dict(sj)
    assert dataclasses.asdict(tc.training_status_from_proto(sj)) == \
        dataclasses.asdict(jc.training_status_from_proto(sj))
    # the hex transport quirk, byte for byte
    hj = jgu.ProtobufConverter("torch", hex_wire=True)
    ht = tgu.ProtobufConverter("torch", hex_wire=True)
    _equal(hj.weights_from_bytes(ht.weights_to_bytes(weights(4))),
           weights(4))
    assert {k: tuple(c.DESCRIPTOR.full_name for c in v)
            for k, v in tgu.RPC_TABLE.items()} == \
        {k: tuple(c.DESCRIPTOR.full_name for c in v)
         for k, v in jgu.RPC_TABLE.items()}
    assert tgu.GRPC_OPTIONS == jgu.GRPC_OPTIONS


# --- the local trainer (tests/test_local_trainer.py:23-77) -------------------------

@pytest.fixture(scope="module")
def local_setup():
    from fl_tpu_torch.data import load_dataset
    from fl_tpu_torch.models import create_model, init_variables

    splits = load_dataset("mnist", n_train_synth=512, n_test_synth=128)
    model = create_model("simple_cnn")
    return splits, model, init_variables(model, seed=0)


def _trainer(model, **kw):
    from fl_tpu_torch.fl.local_trainer import LocalTrainer
    from fl_tpu_torch.fl.local_training import FederatedTrainingConfig

    ckpt = kw.pop("checkpoint_dir", None)
    return LocalTrainer(model, FederatedTrainingConfig(**kw),
                        checkpoint_dir=ckpt, device="cpu")


def test_local_trainer_validation_split(local_setup):
    from fl_tpu_torch.models import get_model_weights

    splits, model, variables = local_setup
    trainer = _trainer(model, local_epochs=2, batch_size=16,
                       validation_split=0.2)
    new_vars, summary = trainer.train_local_model(
        variables, splits.train_images[:256], splits.train_labels[:256],
        splits.mean, splits.std)
    assert summary["epochs_completed"] == 2
    assert summary["final_val_loss"] is not None
    assert len(summary["history"]) == 2
    assert summary["samples_processed"] == 2 * 205
    w0, w1 = get_model_weights(variables), get_model_weights(new_vars)
    assert any(not torch.allclose(w0[k], w1[k]) for k in w0)


def test_local_trainer_early_stopping(local_setup):
    splits, model, variables = local_setup
    trainer = _trainer(model, local_epochs=30, batch_size=16,
                       validation_split=0.25, early_stopping_patience=1,
                       learning_rate=2.0)  # lr huge: diverges
    _, summary = trainer.train_local_model(
        variables, splits.train_images[:128], splits.train_labels[:128],
        splits.mean, splits.std)
    assert summary["epochs_completed"] < 30


def test_local_trainer_checkpoint_roundtrip(local_setup, tmp_path):
    from fl_tpu_torch.models import get_model_weights

    splits, model, variables = local_setup
    trainer = _trainer(model, local_epochs=1, batch_size=16,
                       save_checkpoints=True, checkpoint_dir=str(tmp_path))
    new_vars, _ = trainer.train_local_model(
        variables, splits.train_images[:64], splits.train_labels[:64],
        splits.mean, splits.std)
    assert (tmp_path / "latest_checkpoint.npz").exists()
    restored, meta = trainer.load_checkpoint(variables)
    assert meta["epoch"] == 0
    wr, wn = get_model_weights(restored), get_model_weights(new_vars)
    for k in wn:
        assert torch.equal(wr[k], wn[k])


def test_local_trainer_evaluation_equals_the_reference(local_setup):
    """The per-class evaluation of the reference's initial SimpleCNN,
    carried into the port, against ``fl_tpu``'s LocalTrainer."""
    import jax

    from fl_tpu.fl.local_trainer import LocalTrainer as JaxTrainer
    from fl_tpu.models import create_model as jax_create
    from fl_tpu_torch.models import set_model_weights

    splits, model, variables = local_setup
    jmodel = jax_create("simple_cnn")
    jvars = jmodel.init(jax.random.PRNGKey(0))
    want = JaxTrainer(jmodel).evaluate_model(
        jvars, splits.test_images, splits.test_labels, splits.mean,
        splits.std)
    carried = set_model_weights(variables, {
        k: np.asarray(v) for k, v in jmodel.get_model_weights(jvars).items()})
    got = _trainer(model).evaluate_model(
        carried, splits.test_images, splits.test_labels, splits.mean,
        splits.std)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-6)
    np.testing.assert_allclose(got["per_class_accuracy"],
                               want["per_class_accuracy"], atol=1e-6)
    assert len(got["per_class_accuracy"]) == 10


def test_validate_training_data_equals_the_reference(local_setup):
    from fl_tpu.fl.local_trainer import validate_training_data as jv
    from fl_tpu_torch.fl.local_trainer import validate_training_data as tv

    splits, *_ = local_setup
    for x, y in [(splits.train_images[:64], splits.train_labels[:64]),
                 (splits.train_images[:4], np.asarray([0, 1, 99, 2])),
                 (splits.train_images[:3], splits.train_labels[:4])]:
        assert tv(x, y) == jv(x, y)
    ok = tv(splits.train_images[:64], splits.train_labels[:64])
    assert ok["valid"] and ok["num_samples"] == 64


# --- the YAML config and the capability adapter --------------------------------------

def test_config_equals_the_reference(tmp_path, monkeypatch):
    path = tmp_path / "c.yaml"
    path.write_text("training:\n  min_clients: 3\n  local_epochs: 2\n"
                    "privacy:\n  epsilon: 4.0\n")
    for defaults in ("DEFAULT_COORDINATOR_CONFIG", "DEFAULT_CLIENT_CONFIG"):
        assert getattr(tconfig, defaults) == getattr(jconfig, defaults)
    jc = jconfig.load_config(str(path), jconfig.DEFAULT_COORDINATOR_CONFIG)
    tc = tconfig.load_config(str(path), tconfig.DEFAULT_COORDINATOR_CONFIG)
    assert tc == jc
    assert dataclasses.asdict(tconfig.round_config_from(tc)) == \
        dataclasses.asdict(jconfig.round_config_from(jc))
    assert dataclasses.asdict(tconfig.training_config_from(tc)) == {
        k: v for k, v in dataclasses.asdict(
            jconfig.training_config_from(jc)).items()
        if k in dataclasses.asdict(tconfig.training_config_from(tc))}
    monkeypatch.setenv("CLIENT_ID", "edge-7")
    monkeypatch.setenv("COORDINATOR_PORT", "6000")
    monkeypatch.setenv("DATABASE_URL", "sqlite://")
    for role, d in (("client", "DEFAULT_CLIENT_CONFIG"),
                    ("coordinator", "DEFAULT_COORDINATOR_CONFIG")):
        assert tconfig.apply_env_overrides(getattr(tconfig, d), role) == \
            jconfig.apply_env_overrides(getattr(jconfig, d), role)


def test_capability_adapter_equals_the_reference():
    from fl_tpu.fl.local_training import FederatedTrainingConfig as JCfg
    from fl_tpu_torch.fl.local_training import FederatedTrainingConfig as TCfg

    for cpu, mem, acc, cores in [(10, 10, None, 2), (90, 10, None, 4),
                                 (90, 90, 95.0, 8), (10, 90, None, 16)]:
        jm = jcap.ResourceMetrics(0.0, cpu, mem, 100.0, acc, cores)
        tm = tcap.ResourceMetrics(0.0, cpu, mem, 100.0, acc, cores)
        ja, ta = jcap.CapabilityAdapter(), tcap.CapabilityAdapter()
        jcfg = ja.adapt_training_config(JCfg(local_epochs=3, batch_size=64),
                                        jm)
        tcfg = ta.adapt_training_config(TCfg(local_epochs=3, batch_size=64),
                                        tm)
        assert (tcfg.batch_size, tcfg.local_epochs, tcfg.learning_rate) == \
            (jcfg.batch_size, jcfg.local_epochs, jcfg.learning_rate)
        assert ta.assess_compute_power(tm).value == \
            ja.assess_compute_power(jm).value
        assert [e["reasons"] for e in ta.adaptation_log] == \
            [e["reasons"] for e in ja.adaptation_log]
    m = tcap.sample_resources("cpu")
    assert m.accelerator_memory_percent is None and m.cpu_cores >= 1


# --- the modules a card's machine runs, without grpcio or protobuf ---------------------

def test_deployment_modules_import_without_grpc_or_protobuf():
    """``sys.modules`` maps ``grpc`` and ``google.protobuf`` to None (an
    import of either raises) before anything of the port is imported."""
    code = """
import sys
sys.modules["grpc"] = None
sys.modules["google.protobuf"] = None
import fl_tpu_torch.services.federated_trainer as ft
import fl_tpu_torch.orchestration.round_manager
import fl_tpu_torch.fl.fedavg
import fl_tpu_torch.services.serialization
import fl_tpu_torch.fl.local_trainer
from fl_tpu_torch.services.grpc_client import ClientConnectionManager
t = ft.FederatedTrainer("edge", device="cpu")
assert isinstance(t.connection, ClientConnectionManager)
try:
    import fl_tpu_torch.services.grpc_utils
except ImportError:
    pass
else:
    raise SystemExit("grpc_utils imported without protobuf")
from fl_tpu_torch.orchestration.simulation import (
    FederatedLearningSimulation, SimulationConfig)
try:
    FederatedLearningSimulation(SimulationConfig(backend="grpc"),
                                device="cpu").run_simulation()
except ImportError as e:
    print("REFUSED", e)
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "fl_tpu" or m.startswith("fl_tpu.")]
print("LEAKED", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "REFUSED" in out.stdout and "grpcio" in out.stdout
    assert "protobuf" in out.stdout
    assert "LEAKED []" in out.stdout
