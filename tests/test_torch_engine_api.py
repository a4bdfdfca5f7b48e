"""The port engine's other entry points: ``run_rounds_fused``, checkpoint
and resume, ``get_model_weights`` / ``set_model_weights`` and
``profile_round``.

The fused runner must equal a loop of ``run_round`` over the same masks
bit for bit (it runs the same superstep; only the host's reads move to the
end): the parameters, the uplink state, each round's metrics and ε, the
ledgers. A checkpoint saved after round 2 and restored into a fresh engine
must continue as the uninterrupted engine bit for bit through rounds 3 and
4, for delta DP with the int8 uplink, client_dp with adaptive clipping
(Poisson masks drawn by the engine: the sampler's state is in the
checkpoint), FedAdam, SCAFFOLD and FedDyn. The weights' keys are the
reference's ``FLModel.get_model_weights`` keys.

SimpleCNN with ``fused_conv_block="residual"`` at 4 clients of 16 samples,
one full-batch local step a round, on the CPU.
"""

import copy
import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch

from fl_tpu.core import pytree as jpt
from fl_tpu.models import create_model as jax_create_model
from fl_tpu_torch.core.types import PrivacyConfig
from fl_tpu_torch.data import load_dataset, make_federated_arrays
from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
from fl_tpu_torch.fl.privacy import PrivacyError
from fl_tpu_torch.models import create_model, params_from_flax
from fl_tpu_torch.orchestration import FederatedRoundEngine, RoundEngineConfig
from fl_tpu_torch.orchestration.checkpoint import (
    CheckpointManager,
    restore_engine_checkpoint,
    save_engine_checkpoint,
)

C = 4
SPLITS = load_dataset("mnist", n_train_synth=256, n_test_synth=32)
ARRAYS = make_federated_arrays(SPLITS, num_clients=C, strategy="iid",
                               samples_per_client=16, seed=0)
PRIVACY = dict(epsilon=1e9, delta=1e-5, max_grad_norm=1.0)
SGD0 = dict(optimizer_type="sgd", momentum=0.0, learning_rate=0.05)

CONFIGS = {
    "delta-int8": ({}, dict(dp_mode="delta", epsilon_per_round=1.0,
                            delta_per_round=1e-7, uplink_compression="int8",
                            privacy=PrivacyConfig(**PRIVACY))),
    "client_dp": ({}, dict(dp_mode="client_dp", participation_rate=0.5,
                           privacy=PrivacyConfig(epsilon=50.0, delta=1e-5,
                                                 noise_multiplier=1.0))),
    "client_dp-adaptive": ({}, dict(
        dp_mode="client_dp", participation_rate=0.5, adaptive_clipping=True,
        clip_count_stddev=4.0,
        privacy=PrivacyConfig(epsilon=50.0, delta=1e-5,
                              noise_multiplier=1.0))),
    "fedadam": ({}, dict(server_optimizer="fedadam", server_lr=0.01)),
    "scaffold": (SGD0, dict(scaffold=True)),
    "feddyn": (SGD0, dict(feddyn_alpha=0.1)),
    "qffl-peft": (SGD0, dict(qffl_q=1.0, trainable_patterns=(r"conv",))),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def engine(name, test_set=False):
    train, cfg = CONFIGS[name]
    kw = {}
    if test_set:
        kw = dict(test_images=SPLITS.normalized(SPLITS.test_images),
                  test_labels=SPLITS.test_labels)
    return FederatedRoundEngine(
        create_model("simple_cnn", fused_conv_block="residual"), ARRAYS,
        RoundEngineConfig(training=FederatedTrainingConfig(
            **dict(dict(local_epochs=1, batch_size=16), **train)), seed=0,
            **cfg), device="cpu", **kw)


def assert_params_equal(a, b):
    pa, pb = a.global_variables["params"], b.global_variables["params"]
    assert sorted(pa) == sorted(pb)
    for l in pa:
        for k in pa[l]:
            assert torch.equal(pa[l][k], pb[l][k]), f"{l}/{k}"


def assert_state_equal(a, b):
    """Model, carried device state and host ledgers, bit for bit."""
    assert a.round_number == b.round_number
    assert_params_equal(a, b)
    assert torch.equal(a.uplink_error, b.uplink_error)
    for name in ("scaffold_c", "scaffold_ci", "feddyn_h", "feddyn_grads"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None and y is None) or torch.equal(x, y), name
    if a.server_opt_state is not None:
        assert a.server_opt_state["count"] == b.server_opt_state["count"]
        for key in ("mu", "nu"):
            for l, d in a.server_opt_state[key].items():
                for k, v in d.items():
                    assert torch.equal(v, b.server_opt_state[key][l][k])
    if a.budget_tracker is not None:
        assert (a.budget_tracker.state_dict()
                == b.budget_tracker.state_dict())
    if a.rdp_accountant is not None:
        assert (a.rdp_accountant.state_dict()
                == b.rdp_accountant.state_dict())
    assert a.clip_norm == b.clip_norm
    assert a._pld_steps_taken == b._pld_steps_taken


# ---------------------------------------------------------------------------
# run_rounds_fused
# ---------------------------------------------------------------------------

MASKS = np.asarray([[1, 1, 1, 1], [1, 0, 1, 1], [0, 1, 1, 1]], np.float32)


@pytest.mark.parametrize("name", ["delta-int8", "client_dp", "qffl-peft"])
def test_fused_rounds_equal_sequential_run_round(name):
    seq, fused = engine(name), engine(name)
    want = [seq.run_round(mask=m, evaluate=False) for m in MASKS]
    got = fused.run_rounds_fused(3, masks=MASKS, evaluate=False)
    assert_state_equal(seq, fused)
    for w, g in zip(want, got):
        for field in ("round_number", "train_loss", "train_accuracy",
                      "participating_clients", "epsilon_spent",
                      "uplink_ef_norm"):
            assert getattr(g, field) == getattr(w, field), field
    assert np.array_equal(fused.last_client_losses, seq.last_client_losses)
    if name == "qffl-peft":
        assert np.array_equal(fused.last_client_pre_losses,
                              seq.last_client_pre_losses)
    def ledger(eng):
        return [(e["epsilon"], e["noise_scale"])
                for e in eng.accountant.get_privacy_ledger()]

    assert ledger(fused) == ledger(seq)
    assert len(ledger(fused)) == (0 if name == "qffl-peft" else 3)


def test_fused_rounds_chunked_by_evaluate_every():
    """evaluate_every = 2 over 3 rounds: chunks of 2 and 1, the test set
    evaluated after each, the model as three sequential rounds'."""
    seq, fused = engine("delta-int8"), engine("delta-int8", test_set=True)
    for m in MASKS:
        seq.run_round(mask=m, evaluate=False)
    got = fused.run_rounds_fused(3, masks=MASKS, evaluate_every=2)
    assert_state_equal(seq, fused)
    assert [r.test_accuracy is not None for r in got] == [False, True,
                                                           True]
    assert got[-1].test_accuracy == fused.evaluate()["accuracy"]


@pytest.mark.parametrize("name", ["delta-int8", "client_dp"])
def test_fused_budget_is_checked_for_all_rounds_up_front(name):
    """A budget that admits 2 of 3 rounds: the whole call is refused and
    nothing is dispatched or charged."""
    eng = engine(name)
    if name == "client_dp":
        acc, eps = copy.deepcopy(eng.rdp_accountant), []
        for _ in range(3):
            acc.accumulate(eng._round_rdp)
            eps.append(acc.get_epsilon(1e-5))
        budget = (eps[1] + eps[2]) / 2
    else:
        budget = 2.5      # 1.0 a round
    eng.privacy = dataclasses.replace(eng.privacy, epsilon=budget)
    eng.budget_tracker.initial_epsilon = budget
    with pytest.raises(PrivacyError, match="^3 "):
        eng.run_rounds_fused(3, masks=MASKS)
    assert eng.round_number == 0 and eng.history == []
    assert eng.budget_tracker.consumed_epsilon == 0.0
    assert eng.rdp_accountant is None or not eng.rdp_accountant._rdp.any()
    assert len(eng.run_rounds_fused(2, masks=MASKS[:2])) == 2


def test_fused_masks_shape_is_checked():
    with pytest.raises(ValueError, match=r"masks must have shape \(2, 4\)"):
        engine("delta-int8").run_rounds_fused(2, masks=MASKS)


# ---------------------------------------------------------------------------
# checkpoint and resume
# ---------------------------------------------------------------------------

CKPT = ["delta-int8", "client_dp-adaptive", "fedadam", "scaffold", "feddyn"]


@pytest.mark.parametrize("name", CKPT)
def test_restore_continues_bit_for_bit(tmp_path, name):
    a = engine(name)
    for _ in range(2):
        a.run_round(evaluate=False)
    save_engine_checkpoint(a, str(tmp_path))
    for _ in range(2):
        a.run_round(evaluate=False)
    b = engine(name)
    assert restore_engine_checkpoint(b, str(tmp_path)) == 2
    for _ in range(2):
        b.run_round(evaluate=False)
    assert_state_equal(a, b)
    assert [r.train_loss for r in b.history] == [r.train_loss
                                                  for r in a.history[2:]]
    assert ([r.participating_clients for r in b.history]
            == [r.participating_clients for r in a.history[2:]])


def test_checkpoint_layout_and_max_to_keep(tmp_path):
    eng = engine("feddyn")
    for _ in range(5):
        save_engine_checkpoint(eng, str(tmp_path), max_to_keep=2)
        eng.run_round(evaluate=False)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    step = tmp_path / "round_00000004"
    assert sorted(p.name for p in step.iterdir()) == [
        "feddyn.pt", "meta.json", "variables.pt"]
    meta = json.loads((step / "meta.json").read_text())
    assert meta["version"] == 1 and meta["round_number"] == 4
    assert meta["host_state"]["seed"] == 0
    assert set(meta["host_state"]["detector"]) == {
        "best_accuracy", "best_loss", "rounds_without_improvement"}
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_restore_refuses_another_model(tmp_path):
    save_engine_checkpoint(engine("feddyn"), str(tmp_path))
    other = FederatedRoundEngine(
        create_model("simple_cnn", num_classes=7), ARRAYS,
        RoundEngineConfig(), device="cpu")
    with pytest.raises(ValueError, match="fc2/kernel"):
        restore_engine_checkpoint(other, str(tmp_path))


# ---------------------------------------------------------------------------
# weights and the profiler
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reference_weights():
    """The reference model's initial variables and its flat weights (its
    init as one compiled program, not op by op)."""
    jmodel = jax_create_model("simple_cnn")
    jvars = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    return jvars, jmodel.get_model_weights(jvars)


def test_model_weights_keys_are_the_reference_keys():
    _, want = reference_weights()
    eng = engine("fedadam")
    got = eng.get_model_weights()
    assert sorted(got) == sorted(want)
    assert all(tuple(got[k].shape) == tuple(want[k].shape) for k in want)
    # the reference's weights go in and come back out unchanged
    eng.set_model_weights({k: np.asarray(v) for k, v in want.items()})
    back = eng.get_model_weights()
    for k in want:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(want[k]))
    assert eng.global_variables["params"]["fc1"]["kernel"].dtype == \
        torch.float32
    # a copy: writing into it leaves the engine alone
    back["params/fc2/bias"].add_(1.0)
    assert not torch.equal(eng.get_model_weights()["params/fc2/bias"],
                           back["params/fc2/bias"])


@pytest.mark.parametrize("change", ["missing", "shape"])
def test_set_model_weights_mismatch_raises_the_reference_message(change):
    jvars, current = reference_weights()
    bad = {k: np.asarray(v) for k, v in current.items()}
    if change == "missing":
        del bad["params/fc2/bias"]
    else:
        bad["params/fc2/bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError) as want:
        jpt.assert_same_structure(current, bad)
    eng = engine("fedadam")
    eng.global_variables = {"params": params_from_flax(jvars["params"])}
    with pytest.raises(ValueError) as got:
        eng.set_model_weights(bad)
    assert str(got.value) == str(want.value)


def test_profile_round_writes_a_chrome_trace(tmp_path):
    eng = engine("fedadam")
    result = eng.profile_round(str(tmp_path / "trace"))
    assert result.round_number == 0 and eng.round_number == 1
    trace = json.loads(open(eng.last_trace_path).read())
    assert eng.last_trace_path.startswith(str(tmp_path / "trace"))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n or "bmm" in n for n in names)
