"""The port's secure deployment round (``fl_tpu_torch.services``: the
servicer's secure-aggregation RPCs, the FSM's masked upload, distributed
DP over the wire) against the reference's, on the CPU over localhost gRPC.

- One ``backend="grpc"`` masked round of both packages on the same data
  and seeds (2 IID clients of 8 images, dropout 0 through both FSMs' model
  factory, ε = 1e12, the reference's initial SimpleCNN served by both
  coordinators): the global models agree within the deployment tolerance
  of ``tests/test_torch_deployment.py`` (99.9% of the elements within 1e-5
  and all within lr), and the port's masked aggregate lies within
  roster · 2^-16 of its own unmasked run's aggregate.
- A distributed-DP wire round of both packages: each client's ε charge
  and the coordinator's ``ddp_epsilon_total`` equal the reference's
  exactly; no per-client metric crosses the wire.
- The servicer's and trainer's validation errors, message for message.
- The four-phase protocol driven by hand over the wire against the port's
  servicer with the port's gRPC client and a roster mixing port and
  reference sessions, with and without a dropout after the share phase:
  the aggregate on the servicer's device equals the fixed-point decode of
  the clients' plaintexts bit for bit.
- The registry guards of ``tests/test_secagg_wire.py:340-540``: the
  pubkey-replacement guard, the frozen roster snapshot, the stalled-round
  reset, the non-roster refusal, the crash that clears a round.
- The FSM's secure upload refused before transmission
  (``tests/test_trainer_fsm.py``): nothing sent, no ε charged.
"""

import time

import numpy as np
import pytest
import torch

import fl_tpu.orchestration.simulation as jsim
import fl_tpu.services.federated_trainer as jft
import fl_tpu.services.grpc_server as jgs
from fl_tpu.core import types as jtypes
from fl_tpu.models import get_model_for_dataset as jax_model_for
from fl_tpu.services import federated_learning_pb2 as jpb
from fl_tpu.services import secagg_wire as jsw
from fl_tpu_torch.core import types as ttypes
from fl_tpu_torch.models import get_model_for_dataset
from fl_tpu_torch.orchestration import simulation as tsim
from fl_tpu_torch.services import federated_learning_pb2 as pb
from fl_tpu_torch.services import federated_trainer as tft
from fl_tpu_torch.services import grpc_server as tgs
from fl_tpu_torch.services import secagg_wire as tsw
from fl_tpu_torch.services.grpc_client import FederatedLearningClient


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference_init():
    import jax

    from fl_tpu.models import create_model

    model = create_model("simple_cnn")
    variables = model.init(jax.random.PRNGKey(0))
    return {k: np.asarray(v)
            for k, v in model.get_model_weights(variables).items()}


# --- one backend="grpc" round of both packages ---------------------------------------

SPC = 8
PARITY = dict(dataset="mnist", num_clients=2, num_rounds=1,
              target_accuracy=0.999, backend="grpc",
              partition_strategy="iid", n_train_synth=2 * SPC,
              n_test_synth=16, local_epochs=1, batch_size=SPC,
              privacy_epsilon=1e12, dp_mode="delta", timeout_s=240,
              heterogeneous_clients=False, dp_noise_seed=3)
DDP = dict(dataset="mnist", num_clients=2, num_rounds=1,
           target_accuracy=0.999, backend="grpc", n_train_synth=2 * SPC,
           n_test_synth=16, local_epochs=1, batch_size=SPC,
           privacy_epsilon=1e6, privacy_delta=1e-6, dp_mode="none",
           noise_multiplier=0.05, timeout_s=240,
           heterogeneous_clients=False, secure_aggregation=True,
           distributed_dp=True, dp_noise_seed=5)


def _grpc_round(sim_mod, ft_mod, gs_mod, model_for, init, config,
                device=None):
    """One ``backend="grpc"`` run of ``config`` with dropout 0 and ``init``
    as the served initial model; returns (results, servicer)."""
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
            sim_mod.SimulationConfig(**config), **kw).run_simulation()
    finally:
        mp.undo()
    return results, made[0]


def _port_round(init, **overrides):
    return _grpc_round(tsim, tft, tgs, get_model_for_dataset, init,
                       {**PARITY, **overrides}, device="cpu")


def _weights(servicer):
    return {k: ttypes.to_numpy(v)
            for k, v in servicer.global_model.model_weights.items()}


def test_masked_grpc_round_equals_the_reference(reference_init):
    want, jserv = _grpc_round(jsim, jft, jgs, jax_model_for, reference_init,
                              {**PARITY, "secure_aggregation": True})
    got, tserv = _port_round(reference_init, secure_aggregation=True)
    plain, pserv = _port_round(reference_init)
    assert got["rounds_completed"] == want["rounds_completed"] == 1
    assert got["stop_reason"] == want["stop_reason"]
    assert got["final_accuracy"] is None and want["final_accuracy"] is None
    assert sorted(tserv.global_model.participating_clients) == \
        sorted(jserv.global_model.participating_clients) == ["sim_0",
                                                            "sim_1"]
    for cid, ws in want["client_results"].items():
        gs = got["client_results"][cid]
        assert [h["epsilon_used"] for h in gs["history"]] == \
            [h["epsilon_used"] for h in ws["history"]]
        assert gs["budget"]["consumed_epsilon"] == \
            ws["budget"]["consumed_epsilon"]
    # the masked aggregate lives on the servicer's device, as the plain one
    assert all(isinstance(v, torch.Tensor)
               for v in tserv.global_model.model_weights.values())
    masked, unmasked = _weights(tserv), _weights(pserv)
    grid = PARITY["num_clients"] * 2.0 ** -16
    moved, diffs = 0.0, []
    for k, v in jserv.global_model.model_weights.items():
        assert np.abs(masked[k] - unmasked[k]).max() <= grid
        diffs.append(np.abs(masked[k] - np.asarray(v)).ravel())
        moved = max(moved, float(np.abs(np.asarray(v)
                                        - reference_init[k]).max()))
    diffs = np.concatenate(diffs)
    assert (diffs <= 1e-5).mean() >= 0.999 and diffs.max() <= 1e-3
    assert moved > 1e-4  # the round moved the model
    # no per-client metric crossed the wire under the masked pipeline
    assert all(c["last_loss"] == 0.0 for c in tserv.clients.values())
    assert plain["rounds_completed"] == 1


def test_distributed_dp_grpc_round_charges_equal_the_reference(
        reference_init):
    want, jserv = _grpc_round(jsim, jft, jgs, jax_model_for, reference_init,
                              DDP)
    got, tserv = _grpc_round(tsim, tft, tgs, get_model_for_dataset,
                             reference_init, DDP, device="cpu")
    assert got["rounds_completed"] == want["rounds_completed"] == 1
    assert got["final_accuracy"] is None and want["final_accuracy"] is None
    charges = []
    for cid, ws in want["client_results"].items():
        gs = got["client_results"][cid]
        assert [h["epsilon_used"] for h in gs["history"]] == \
            [h["epsilon_used"] for h in ws["history"]]
        assert gs["budget"]["consumed_epsilon"] == \
            ws["budget"]["consumed_epsilon"] > 0
        charges.append(gs["history"][0]["epsilon_used"])
    assert tserv.ddp_epsilon_total == jserv.ddp_epsilon_total > 0
    # each client charged at the threshold, the coordinator at the
    # realized survivors; both 2 here
    assert charges == [tserv.ddp_epsilon_total] * 2
    assert tserv.global_model.accuracy_metrics["ddp_epsilon_total"] == \
        tserv.ddp_epsilon_total
    # the decoded average delta moved the model by the plan's noise scale
    gap = max(float(np.abs(_weights(tserv)[k] - reference_init[k]).max())
              for k in reference_init)
    assert 0 < gap < 1.0


# --- validation, message for message ------------------------------------------------

def _both(make):
    out = []
    for pkg in ("reference", "port"):
        try:
            make(pkg)
        except ValueError as e:
            out.append(str(e))
        else:
            out.append(None)
    assert out[0] is not None and out[0] == out[1], out
    return out[0]


def _trainer(pkg, **kw):
    if pkg == "port":
        return tft.FederatedTrainer(client_id="x", device="cpu", **kw)
    return jft.FederatedTrainer(client_id="x", **kw)


def _servicer(pkg, **kw):
    types = ttypes if pkg == "port" else jtypes
    pc = kw.pop("pc", None)
    rc = types.RoundConfig(privacy_config=(types.PrivacyConfig(*pc)
                                           if pc else None))
    if pkg == "port":
        return tgs.FederatedLearningServicer(round_config=rc, device="cpu",
                                             **kw)
    return jgs.FederatedLearningServicer(round_config=rc, **kw)


def _pc(pkg):
    types = ttypes if pkg == "port" else jtypes
    return types.PrivacyConfig(1.0, 1e-5)


@pytest.mark.parametrize("case", [
    "ddp-without-secagg", "ddp-without-privacy", "adaptive-with-ddp",
    "adaptive-with-secagg"])
def test_trainer_secure_validation_equals_the_reference(case):
    def make(pkg):
        if case == "ddp-without-secagg":
            _trainer(pkg, distributed_dp=True, privacy=_pc(pkg))
        elif case == "ddp-without-privacy":
            _trainer(pkg, distributed_dp=True, secure_aggregation=True)
        elif case == "adaptive-with-ddp":
            _trainer(pkg, adaptive_clipping=True, distributed_dp=True,
                     secure_aggregation=True, privacy=_pc(pkg))
        else:
            _trainer(pkg, adaptive_clipping=True, secure_aggregation=True,
                     privacy=_pc(pkg))

    msg = _both(make)
    assert {"ddp-without-secagg": "secure_aggregation",
            "ddp-without-privacy": "PrivacyConfig",
            "adaptive-with-ddp": "distributed_dp",
            "adaptive-with-secagg": "withheld"}[case] in msg


@pytest.mark.parametrize("case", [
    "ddp-without-secagg", "ddp-without-privacy", "adaptive-with-ddp",
    "adaptive-with-secagg"])
def test_servicer_secure_validation_equals_the_reference(case):
    pc = (1.0, 1e-5)

    def make(pkg):
        if case == "ddp-without-secagg":
            _servicer(pkg, distributed_dp=True)
        elif case == "ddp-without-privacy":
            _servicer(pkg, secure_aggregation=True, distributed_dp=True)
        elif case == "adaptive-with-ddp":
            _servicer(pkg, pc=pc, adaptive_clipping=True,
                      secure_aggregation=True, distributed_dp=True)
        else:
            _servicer(pkg, pc=pc, adaptive_clipping=True,
                      secure_aggregation=True)

    msg = _both(make)
    assert {"ddp-without-secagg": "secure_aggregation",
            "ddp-without-privacy": "privacy_config",
            "adaptive-with-ddp": "distributed_dp",
            "adaptive-with-secagg": "withheld"}[case] in msg


def test_secure_entry_points_construct():
    t = tft.FederatedTrainer(client_id="x", device="cpu",
                             secure_aggregation=True, distributed_dp=True,
                             privacy=ttypes.PrivacyConfig(1.0, 1e-5),
                             ddp_bits=12, secagg_phase_timeout_s=5.0)
    assert len(t._secagg_pk) == 32 and t.ddp_bits == 12
    s = _servicer("port", pc=(1.0, 1e-5), secure_aggregation=True,
                  distributed_dp=True, secagg_threshold=3,
                  secagg_grace_s=2.0, ddp_bits=12)
    assert (s.secagg_threshold, s.secagg_grace_s, s.ddp_bits,
            s.ddp_epsilon_total) == (3, 2.0, 12, 0.0)
    sim = tsim.FederatedLearningSimulation(tsim.SimulationConfig(
        backend="grpc", num_clients=2, secure_aggregation=True,
        distributed_dp=True), device="cpu")
    assert sim.config.distributed_dp


# --- the protocol by hand over the wire ---------------------------------------------

def _wire_coordinator(min_clients, max_clients, grace_s=15.0,
                      threshold=None):
    from fl_tpu_torch.services.grpc_server import CoordinatorGRPCServer

    servicer = tgs.FederatedLearningServicer(
        round_config=ttypes.RoundConfig(min_clients=min_clients,
                                        max_clients=max_clients,
                                        local_epochs=1, batch_size=8),
        secure_aggregation=True, secagg_threshold=threshold,
        secagg_grace_s=grace_s, device="cpu")
    srv = CoordinatorGRPCServer(servicer, host="127.0.0.1", port=0)
    return servicer, srv, srv.start()


def _wire_client(port, cid, pk):
    caps = ttypes.ClientCapabilities(
        compute_power=ttypes.ComputePowerLevel.MEDIUM,
        network_bandwidth=10, available_samples=100)
    c = FederatedLearningClient(host="127.0.0.1", port=port, client_id=cid,
                                timeout_s=10.0)
    c.connect()
    c.register(caps, metadata={tsw.PUBKEY_METADATA_KEY: pk.hex()})
    return c


@pytest.mark.parametrize("dropout", [False, True], ids=["all", "dropout"])
def test_wire_round_with_mixed_sessions(dropout):
    servicer, srv, port = _wire_coordinator(3, 3, grace_s=0.5,
                                            threshold=2 if dropout else 3)
    ids = ["da", "db", "dc"]
    wire = {"da": tsw, "db": jsw, "dc": tsw}
    keys = {cid: wire[cid].generate_keypair() for cid in ids}
    alive = ["da", "dc"] if dropout else ids
    clients = {}
    try:
        for cid in ids:
            clients[cid] = _wire_client(port, cid, keys[cid][1])
        ready, info = clients["da"].get_secagg_roster(0)
        assert ready and [p[0] for p in info["peers"]] == ids
        assert len(info["nonce"]) == 16 and info["frac_bits"] == 16
        sessions = {cid: wire[cid].SecAggClientSession(
            cid, keys[cid][0], 0, info["peers"], info["nonce"],
            info["threshold"], info["frac_bits"]) for cid in ids}
        for cid in ids:
            clients[cid].submit_secagg_shares(
                0, info["nonce"], sessions[cid].make_share_uploads())
        for cid in ids:
            ready, bundles = clients[cid].get_secagg_shares(0)
            assert ready and len(bundles) == 2
            sessions[cid].receive_shares(bundles)
        base = {k: ttypes.to_numpy(v) for k, v in
                clients["da"].get_global_model().model_weights.items()}
        rng = np.random.default_rng(4)
        plain = {cid: {k: (v + rng.normal(0, 0.01, v.shape)).astype(
            np.float32) for k, v in base.items()} for cid in ids}
        n = {cid: 50 * (i + 1) for i, cid in enumerate(ids)}
        for cid in alive:
            ack = clients[cid].submit_model_update(ttypes.ModelUpdate(
                client_id=cid, round_number=0,
                model_weights=sessions[cid].mask_payload(plain[cid], n[cid]),
                num_samples=n[cid], training_loss=0.0))
            assert ack["success"], ack["message"]
        for cid in alive:
            deadline = time.time() + 30
            while True:
                ready, survivors, dropped, nonce = \
                    clients[cid].get_secagg_reveal(0)
                if ready:
                    break
                assert time.time() < deadline, "survivor set never froze"
                time.sleep(0.05)
            assert survivors == alive
            clients[cid].submit_secagg_reveal(
                0, nonce, sessions[cid].reveal(survivors, dropped))
        deadline = time.time() + 30
        while servicer.current_round == 0 and time.time() < deadline:
            time.sleep(0.05)
        assert servicer.current_round == 1, "aggregation did not fire"
        gm = servicer.global_model
        assert gm.participating_clients == alive
        total = float(sum(n[c] for c in alive))
        for k, v in gm.model_weights.items():
            assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
            acc = sum(np.round(plain[c][k].astype(np.float64) * n[c]
                               * 65536.0).astype(np.int64) for c in alive)
            want = (acc / 65536.0 / total).astype(np.float32)
            np.testing.assert_array_equal(v.numpy(), want)
        # a late reveal after the round advanced is not an error
        assert not clients[alive[0]].submit_secagg_reveal(0, nonce, [])
    finally:
        for c in clients.values():
            c.close()
        srv.stop()


def _register(servicer, cid, pub, proto=pb, key=tsw.PUBKEY_METADATA_KEY):
    req = proto.ClientRegistration(client_id=cid)
    req.metadata[key] = pub.hex()
    return servicer.RegisterClient(req, None)


def _direct(pkg, min_clients=2, max_clients=4, timeout=300):
    types = ttypes if pkg == "port" else jtypes
    rc = types.RoundConfig(min_clients=min_clients, max_clients=max_clients,
                           timeout_seconds=timeout)
    if pkg == "port":
        return tgs.FederatedLearningServicer(round_config=rc,
                                             secure_aggregation=True,
                                             device="cpu")
    return jgs.FederatedLearningServicer(round_config=rc,
                                         secure_aggregation=True)


PROTO = {"port": (pb, tsw), "reference": (jpb, jsw)}


def test_pubkey_replacement_guard_equals_the_reference():
    out = {}
    for pkg, (proto, wire) in PROTO.items():
        s = _direct(pkg)
        (_, pk_a), (_, pk_b) = wire.generate_keypair(), \
            wire.generate_keypair()
        steps = [_register(s, "a", pk_a, proto).success,
                 _register(s, "b", pk_b, proto).success]
        roster = s.GetSecAggRoster(
            proto.SecAggRosterRequest(client_id="a", round_number=0), None)
        steps.append((roster.ready, roster.threshold, len(roster.peers)))
        _, pk_a2 = wire.generate_keypair()
        resp = _register(s, "a", pk_a2, proto)
        steps.append((resp.success, resp.message))
        steps.append(_register(s, "a", pk_a, proto).success)
        # the frozen roster keeps the freeze-time keys
        s.clients["a"]["secagg_pubkey"] = pk_a2
        r2 = s.GetSecAggRoster(
            proto.SecAggRosterRequest(client_id="b", round_number=0), None)
        steps.append(dict((p.client_id, bytes(p.public_key))
                          for p in r2.peers)["a"] == pk_a)
        steps.append(bytes(r2.roster_nonce) == bytes(roster.roster_nonce))
        s.secagg_rounds.clear()
        steps.append(_register(s, "a", pk_a2, proto).success)
        out[pkg] = steps
    assert out["port"] == out["reference"]
    assert out["port"][3][0] is False and "roster" in out["port"][3][1]


def test_stalled_round_resets_with_a_fresh_nonce():
    out = {}
    for pkg, (proto, wire) in PROTO.items():
        s = _direct(pkg, timeout=1)
        for cid in ("a", "b"):
            _register(s, cid, wire.generate_keypair()[1], proto)
        req = proto.SecAggRosterRequest(client_id="a", round_number=0)
        first = bytes(s.GetSecAggRoster(req, None).roster_nonce)
        same = bytes(s.GetSecAggRoster(req, None).roster_nonce)
        s.pending_updates[0] = {"a": object()}
        s.round_start_time -= 5.0  # past the round's timeout
        fresh = bytes(s.GetSecAggRoster(req, None).roster_nonce)
        out[pkg] = (first == same, fresh != first, 0 in s.secagg_rounds,
                    s.pending_updates.get(0))
        # a stale-nonce share upload belongs to the purged roster
        up = proto.SecAggShareUpload(client_id="a", round_number=0,
                                     roster_nonce=first)
        r = s.SubmitSecAggShares(up, None)
        out[pkg] += (r.success, r.message)
        r = s.GetSecAggShares(proto.SecAggRosterRequest(
            client_id="a", round_number=3), None)
        out[pkg] += (r.ready, r.message)
    assert out["port"] == out["reference"]
    assert out["port"][:4] == (True, True, True, None)


def test_non_roster_and_disabled_refusals_equal_the_reference():
    out = {}
    for pkg, (proto, wire) in PROTO.items():
        s = _direct(pkg, min_clients=2, max_clients=2)
        conv = s.converter
        types = ttypes if pkg == "port" else jtypes
        upd = types.ModelUpdate(client_id="zz", round_number=0,
                                model_weights={"w": np.ones(4, np.uint32)},
                                num_samples=1, training_loss=0.0)
        before = s.SubmitModelUpdate(conv.model_update_to_proto(upd), None)
        for cid in ("ra", "rb"):
            _register(s, cid, wire.generate_keypair()[1], proto)
        lone = s.GetSecAggReveal(proto.SecAggRevealRequest(
            client_id="ra", round_number=0), None)
        roster = s.GetSecAggRoster(proto.SecAggRosterRequest(
            client_id="ra", round_number=0), None)
        _register(s, "zz", wire.generate_keypair()[1], proto)
        after = s.SubmitModelUpdate(conv.model_update_to_proto(upd), None)
        off = (jgs if pkg == "reference" else tgs).FederatedLearningServicer(
            **({"device": "cpu"} if pkg == "port" else {}))
        dis = off.GetSecAggRoster(proto.SecAggRosterRequest(
            client_id="x", round_number=0), None)
        out[pkg] = [(before.success, before.message),
                    (lone.ready, lone.message), roster.ready,
                    (after.success, after.message), (dis.ready, dis.message)]
    assert out["port"] == out["reference"]
    assert not out["port"][3][0] and "roster" in out["port"][3][1]


def test_unmasking_crash_clears_the_round():
    s = _direct("port", min_clients=2, max_clients=2)
    ids = ["ka", "kb"]
    keys = {cid: tsw.generate_keypair() for cid in ids}
    for cid in ids:
        _register(s, cid, keys[cid][1])
    assert s.GetSecAggRoster(pb.SecAggRosterRequest(
        client_id="ka", round_number=0), None).ready
    rnd = s.secagg_rounds[0]
    sessions = {cid: tsw.SecAggClientSession(cid, keys[cid][0], 0,
                                             rnd.roster, rnd.nonce,
                                             rnd.threshold) for cid in ids}
    for cid in ids:
        rnd.add_share_upload(cid, sessions[cid].make_share_uploads())
    for cid in ids:
        sessions[cid].receive_shares(rnd.shares_for(cid))
    conv = s.converter
    good = ttypes.ModelUpdate(client_id="ka", round_number=0,
                              model_weights=sessions["ka"].mask_payload(
                                  {"w": np.ones((2, 2), np.float32)}, 10),
                              num_samples=10, training_loss=0.0)
    bad = ttypes.ModelUpdate(client_id="kb", round_number=0,
                             model_weights={"DIFFERENT": np.ones(
                                 3, np.uint32)},
                             num_samples=10, training_loss=0.0)
    assert s.SubmitModelUpdate(conv.model_update_to_proto(good), None).success
    assert s.SubmitModelUpdate(conv.model_update_to_proto(bad), None).success
    for cid in ids:
        req = pb.SecAggRevealUpload(client_id=cid, round_number=0,
                                    roster_nonce=rnd.nonce)
        for subject, is_key, blob in sessions[cid].reveal(ids, []):
            req.shares.add(subject_client_id=subject, is_key_share=is_key,
                           share=blob)
        s.SubmitSecAggReveal(req, None)
    deadline = time.time() + 20
    while time.time() < deadline:
        with s._lock:
            if (not s._aggregating and 0 not in s.pending_updates
                    and 0 not in s.secagg_rounds):
                break
        time.sleep(0.02)
    assert not s._aggregating and 0 not in s.pending_updates
    assert 0 not in s.secagg_rounds and s.current_round == 0
    s.close()


# --- the FSM's secure upload before transmission (tests/test_trainer_fsm.py) -------

class _RosterStub:
    """A stand-in for FederatedLearningClient up to the roster phase."""

    def __init__(self, weights, roster, ready=True):
        self.weights, self.roster, self.ready = weights, roster, ready
        self.submitted = []

    def join_training_round(self, round_number):
        return ttypes.RoundConfig(round_number=round_number, local_epochs=1,
                                  batch_size=8, learning_rate=1e-3,
                                  optimizer_type="sgd")

    def get_global_model(self, round_number):
        return ttypes.GlobalModel(round_number, dict(self.weights))

    def get_secagg_roster(self, round_number):
        return self.ready, {"peers": self.roster, "nonce": b"\x00" * 16,
                            "threshold": 2, "frac_bits": 16}

    def submit_model_update(self, update):
        self.submitted.append(update)
        return {"success": True, "message": "ok"}


@pytest.mark.parametrize("case", ["not-in-roster", "roster-timeout"])
def test_secure_pre_transmit_failure_does_not_charge_budget(case):
    from fl_tpu_torch.models import create_model, init_variables
    from fl_tpu_torch.models.factory import get_model_weights

    t = tft.FederatedTrainer(
        client_id="budget_test", device="cpu", secure_aggregation=True,
        secagg_phase_timeout_s=0.2,
        privacy=ttypes.PrivacyConfig(epsilon=1.0, delta=1e-5),
        epsilon_per_round=0.25, delta_per_round=1e-6,
        compression_algorithm=None, n_train_synth=64, n_test_synth=16,
        num_clients=4)
    t.initialize()
    weights = {k: v.numpy() for k, v in get_model_weights(
        init_variables(create_model("simple_cnn"), seed=0)).items()}
    other = [("someone_else", tsw.generate_keypair()[1])]
    t.client = _RosterStub(weights, other, ready=case == "not-in-roster")
    with pytest.raises(RuntimeError, match="not in the round 0 secagg "
                       "roster" if case == "not-in-roster"
                       else "roster freeze not ready"):
        t._run_one_round(0)
    assert t.client.submitted == []  # never transmitted
    assert t.budget_tracker.consumed_epsilon == pytest.approx(0.0)
