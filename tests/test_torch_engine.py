"""One round of the port's engine vs fl_tpu's FederatedRoundEngine, and the
port's round loop, data copies and import boundary.

Engine parity takes the random draws out of the comparison: dropout 0;
``samples_per_client == batch_size == 16``, so each epoch is one
full-batch step and the shuffle cannot change it; ε = 1e9, so the clip is
exercised and the noise is negligible. The port starts from the JAX
engine's initial parameters, and both engines build the model with the same
``fused_conv_block`` (False, True or "residual"). Tolerances: in bf16 the reference's own
one-round tolerances for two formulations of the segment (params rtol
2e-2 / atol 1e-3, train_loss rtol 5e-2, tests/test_conv_block_engine.py);
in f32 at least 99.9% of parameter elements within 1e-5 and all within
lr (f32 sums in another order can move an Adam step on a few elements).

The compressed rounds (each uplink and downlink kind, and downlink int8 +
uplink top-k together) start both engines from the same uplink state: the
JAX engine's (its PowerSGD Q factors; the two packages' random inits
differ by construction) with an error feedback drawn from a seed, loaded
into the port by ``load_uplink_state``. The error feedback after the round
is held like the parameters.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl_tpu.core.types import PrivacyConfig as JaxPrivacyConfig
from fl_tpu.data import load_dataset as jax_load_dataset
from fl_tpu.data import make_federated_arrays as jax_make_arrays
from fl_tpu.fl.local_training import \
    FederatedTrainingConfig as JaxTrainingConfig
from fl_tpu.fl.partition import partition_indices as jax_partition
from fl_tpu.models import create_model as jax_create_model
from fl_tpu.orchestration import FederatedRoundEngine as JaxEngine
from fl_tpu.orchestration import RoundEngineConfig as JaxConfig
from fl_tpu_torch.core.types import PrivacyConfig
from fl_tpu_torch.data import load_dataset, make_federated_arrays
from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
from fl_tpu_torch.fl.partition import partition_indices
from fl_tpu_torch.fl.privacy import PrivacyError
from fl_tpu_torch.models import (
    create_model,
    load_uplink_state,
    params_from_flax,
    params_to_flax,
)
from fl_tpu_torch.ops.flatten import padded_dim
from fl_tpu_torch.orchestration import FederatedRoundEngine, RoundEngineConfig

LR = 1e-3
SIMPLE_CNN_D = 421_642


FORMULATIONS = [False, True, "residual"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engines(dtype_name, participation_rate=1.0, num_clients=4,
             fused="residual", **compression):
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[dtype_name]
    state = "bfloat16" if dtype_name == "bf16" else None
    common = dict(dp_mode="delta", min_clients=2, seed=0,
                  participation_rate=participation_rate, **compression)
    jarr = jax_make_arrays(jax_load_dataset("mnist", n_train_synth=256,
                                            n_test_synth=64),
                           num_clients=num_clients, strategy="iid",
                           samples_per_client=16, seed=0)
    tarr = make_federated_arrays(load_dataset("mnist", n_train_synth=256,
                                              n_test_synth=64),
                                 num_clients=num_clients, strategy="iid",
                                 samples_per_client=16, seed=0)
    jeng = JaxEngine(
        jax_create_model("simple_cnn", dtype=jdt, fused_conv_block=fused,
                         dropout_rate=0.0), jarr,
        JaxConfig(training=JaxTrainingConfig(
            local_epochs=2, batch_size=16, learning_rate=LR,
            optimizer_type="adam", optimizer_state_dtype=state),
            privacy=JaxPrivacyConfig(epsilon=1e9, delta=1e-5,
                                     max_grad_norm=1.0), **common))
    teng = FederatedRoundEngine(
        create_model("simple_cnn", dtype=tdt, dropout_rate=0.0,
                     fused_conv_block=fused), tarr,
        RoundEngineConfig(training=FederatedTrainingConfig(
            local_epochs=2, batch_size=16, learning_rate=LR,
            optimizer_state_dtype=state),
            privacy=PrivacyConfig(epsilon=1e9, delta=1e-5,
                                  max_grad_norm=1.0), **common),
        device="cpu")
    teng.global_variables = {"params": params_from_flax(
        jax.device_get(jeng.global_variables["params"]))}
    return jeng, teng


def _flat(jeng, teng):
    jp = jax.device_get(jeng.global_variables["params"])
    tp = params_to_flax(teng.global_variables["params"])
    return ({f"{l}/{k}": np.asarray(jp[l][k], np.float32) for l in jp
             for k in jp[l]},
            {f"{l}/{k}": tp[l][k] for l in tp for k in tp[l]})


@pytest.mark.parametrize("fused", FORMULATIONS, ids=str)
def test_round_matches_jax_bf16(fused):
    jeng, teng = _engines("bf16", fused=fused)
    jr = jeng.run_round(evaluate=False)
    tr = teng.run_round(evaluate=False)
    assert tr.participating_clients == jr.participating_clients == 4
    np.testing.assert_allclose(tr.train_loss, jr.train_loss, rtol=5e-2)
    ja, ta = _flat(jeng, teng)
    assert sorted(ja) == sorted(ta)
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=2e-2, atol=1e-3,
                                   err_msg=k)


def test_round_matches_jax_f32():
    jeng, teng = _engines("f32")
    jr = jeng.run_round(evaluate=False)
    tr = teng.run_round(evaluate=False)
    np.testing.assert_allclose(tr.train_loss, jr.train_loss, rtol=1e-5)
    np.testing.assert_allclose(tr.epsilon_spent, jr.epsilon_spent)
    ja, ta = _flat(jeng, teng)
    diff = np.concatenate([np.abs(ta[k] - ja[k]).ravel() for k in ja])
    assert (diff <= 1e-5).mean() >= 0.999
    assert diff.max() <= LR


# ---------------------------------------------------------------------------
# compressed rounds against the JAX engine
# ---------------------------------------------------------------------------

COMPRESSED = {
    "uplink-int8": {"uplink_compression": "int8"},
    "uplink-topk": {"uplink_compression": "topk"},
    "uplink-powersgd": {"uplink_compression": "powersgd"},
    "downlink-bfloat16": {"downlink_compression": "bfloat16"},
    "downlink-int8": {"downlink_compression": "int8"},
    "downlink-int8+uplink-topk": {"downlink_compression": "int8",
                                  "uplink_compression": "topk"},
}
# the starting error feedback's scale. Top-k's is large beside a round's
# deltas (about 2·lr), so its threshold sits far from the last-bit
# differences of the two packages' local steps and both keep the same
# coordinates; int8's and PowerSGD's are the size of the deltas.
EF_SCALE = {"int8": 1e-3, "topk": 10.0, "powersgd": 1e-3}


@pytest.fixture(scope="module",
                params=[(k, d) for k in COMPRESSED for d in ("f32", "bf16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def compressed_round(request):
    """Both engines of one compressed configuration, one round each on the
    same participation mask (some of the 4 clients sit it out), built once
    for the tests that read them."""
    kind, dtype = request.param
    jeng, teng = _engines(dtype, participation_rate=0.75,
                          **COMPRESSED[kind])
    up = COMPRESSED[kind].get("uplink_compression", "none")
    state = np.array(jax.device_get(jeng.uplink_error), np.float32)
    if up != "none":
        state[:, :SIMPLE_CNN_D] = np.random.default_rng(5).normal(
            0, EF_SCALE[up], (state.shape[0], SIMPLE_CNN_D))
        jeng.uplink_error = jnp.asarray(state)
    load_uplink_state(teng, state)
    mask = jeng.sample_participation()
    np.testing.assert_array_equal(teng.sample_participation(), mask)
    jr = jeng.run_round(mask, evaluate=False)
    tr = teng.run_round(mask, evaluate=False)
    return dict(dtype=dtype, uplink=up, jeng=jeng, teng=teng, jr=jr, tr=tr,
                state0=state, mask=mask)


def _close(got, want, dtype, atol_bf16=1e-3):
    """f32: at least 99.9% within 1e-5 and all within lr; bf16: rtol 2e-2,
    atol 1e-3 (the module docstring's tolerances)."""
    if dtype == "bf16":
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=atol_bf16)
    else:
        diff = np.abs(got - want)
        assert (diff <= 1e-5).mean() >= 0.999 and diff.max() <= LR


def test_compressed_round_matches_jax(compressed_round):
    r = compressed_round
    jr, tr = r["jr"], r["tr"]
    assert tr.participating_clients == jr.participating_clients \
        == r["mask"].sum() < 4
    np.testing.assert_allclose(tr.train_loss, jr.train_loss,
                               rtol=5e-2 if r["dtype"] == "bf16" else 1e-5)
    ja, ta = _flat(r["jeng"], r["teng"])
    assert sorted(ja) == sorted(ta)
    _close(np.concatenate([ta[k].ravel() for k in sorted(ta)]),
           np.concatenate([ja[k].ravel() for k in sorted(ja)]), r["dtype"])


def test_compressed_round_carries_the_same_uplink_state(compressed_round):
    r = compressed_round
    want = np.asarray(jax.device_get(r["jeng"].uplink_error))
    got = r["teng"].uplink_error.numpy()
    assert got.shape == want.shape
    if r["uplink"] == "none":
        assert got.shape[1] == 1 and not got.any() and not want.any()
        assert r["tr"].uplink_ef_norm is None
        return
    # a client's error feedback holds its own delta, where the parameters
    # move by the participants' weighted mean of them: in bf16 its absolute
    # tolerance is the parameters' times the number of participants
    _close(got, want, r["dtype"], atol_bf16=1e-3 * r["mask"].sum())
    # the clients that sat the round out kept their state bit for bit
    out = r["mask"] == 0
    np.testing.assert_array_equal(got[out], r["state0"][out])
    ef = want[:, :padded_dim(SIMPLE_CNN_D)]
    ef_norm = np.sqrt((ef.astype(np.float64) ** 2).sum(1)).sum() / len(ef)
    np.testing.assert_allclose(r["tr"].uplink_ef_norm, ef_norm, rtol=1e-4)


def test_participation_masks_match_jax():
    jeng, teng = _engines("f32", participation_rate=0.5, num_clients=16)
    for _ in range(4):
        np.testing.assert_array_equal(teng.sample_participation(),
                                      jeng.sample_participation())
    np.testing.assert_array_equal(teng.sample_participation(exclude=[0, 1]),
                                  jeng.sample_participation(exclude=[0, 1]))


# ---------------------------------------------------------------------------
# the port's round loop on its own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", FORMULATIONS, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_every_formulation_runs_every_round_path(fused, dtype):
    """Nothing in the engine or the local trainer assumes one conv
    formulation: dp_mode none through run() with evaluation, and delta
    through run_round and run_rounds_pipelined."""
    splits = load_dataset("mnist", n_train_synth=64, n_test_synth=32)
    arr = make_federated_arrays(splits, 2, "iid", samples_per_client=16)
    model = create_model("simple_cnn", dtype=dtype, fused_conv_block=fused)
    training = FederatedTrainingConfig(local_epochs=1, batch_size=8)
    plain = FederatedRoundEngine(
        model, arr, RoundEngineConfig(training=training), device="cpu",
        test_images=splits.normalized(splits.test_images),
        test_labels=splits.test_labels)
    hist = plain.run(num_rounds=1)
    assert np.isfinite(hist[0].train_loss) and hist[0].test_accuracy is not None
    assert np.isfinite(plain.evaluate()["loss"])
    private = FederatedRoundEngine(model, arr, RoundEngineConfig(
        training=training, dp_mode="delta", epsilon_per_round=1.0,
        delta_per_round=1e-7, privacy=PrivacyConfig(epsilon=1e9, delta=1e-5)),
        device="cpu")
    results = [private.run_round(evaluate=False)]
    results += private.run_rounds_pipelined(2)
    assert [r.round_number for r in results] == [0, 1, 2]
    assert all(np.isfinite(r.train_loss) for r in results)


def _port_engine(epsilon=1e9, eps_r=1.0, num_clients=4):
    arr = make_federated_arrays(load_dataset("mnist", n_train_synth=256,
                                             n_test_synth=64),
                                num_clients=num_clients, strategy="iid",
                                samples_per_client=16, seed=0)
    return FederatedRoundEngine(
        create_model("simple_cnn", dropout_rate=0.25), arr,
        RoundEngineConfig(
            training=FederatedTrainingConfig(local_epochs=1, batch_size=8),
            dp_mode="delta", epsilon_per_round=eps_r, delta_per_round=1e-7,
            privacy=PrivacyConfig(epsilon=epsilon, delta=1e-5)),
        device="cpu")


def test_pipelined_rounds_equal_a_run_round_loop():
    a, b = _port_engine(), _port_engine()
    ra = a.run_rounds_pipelined(3)
    rb = [b.run_round(evaluate=False) for _ in range(3)]
    assert [r.round_number for r in ra] == [0, 1, 2]
    assert [r.train_loss for r in ra] == [r.train_loss for r in rb]
    for l, leaves in a.global_variables["params"].items():
        for k, v in leaves.items():
            assert torch.equal(v, b.global_variables["params"][l][k])


def test_pipelined_zero_rounds_is_empty():
    eng = _port_engine()
    assert eng.run_rounds_pipelined(0) == []
    assert eng.round_number == 0 and eng.history == []


def test_budget_exhaustion_finalizes_every_dispatched_round():
    """ε = 1 at 0.4 a round admits two rounds; the third dispatch raises,
    and the round already in flight is finalized exactly once."""
    eng = _port_engine(epsilon=1.0, eps_r=0.4)
    with pytest.raises(PrivacyError):
        eng.run_rounds_pipelined(3)
    assert [r.round_number for r in eng.history] == [0, 1]
    assert len(eng.accountant.get_privacy_ledger()) == 2
    assert eng.budget_tracker.consumed_epsilon == pytest.approx(0.8)


def test_evaluate_and_run():
    splits = load_dataset("mnist", n_train_synth=256, n_test_synth=64)
    arr = make_federated_arrays(splits, 4, "iid", samples_per_client=16)
    eng = FederatedRoundEngine(
        create_model("simple_cnn"), arr, RoundEngineConfig(
            training=FederatedTrainingConfig(local_epochs=1, batch_size=8)),
        device="cpu", test_images=splits.normalized(splits.test_images),
        test_labels=splits.test_labels)
    hist = eng.run(num_rounds=2)
    assert len(hist) == 2 and all(r.test_accuracy is not None for r in hist)
    ev = eng.evaluate()
    assert 0.0 <= ev["accuracy"] <= 1.0 and np.isfinite(ev["loss"])


@pytest.mark.parametrize("kwargs", [
    {"dp_mode": "dp_ftrl"}, {"adaptive_clipping": True},
], ids=lambda kw: next(iter(kw)))
def test_unported_features_are_refused(kwargs):
    """Every dp_mode is ported; what stays refused is what the reference
    refuses, naming the field: dp_ftrl without its tree size, adaptive
    clipping outside client_dp."""
    name = next(iter(kwargs))
    with pytest.raises(ValueError, match=name):
        RoundEngineConfig(**kwargs)


_DP = PrivacyConfig(epsilon=100.0, delta=1e-5, noise_multiplier=1.0)


@pytest.mark.parametrize("kwargs", [
    {"feddyn_alpha": 0.1}, {"qffl_q": 1.0},
    {"trainable_patterns": (r".*conv.*",)},
    {"dp_mode": "dp_sgd", "privacy": _DP},
    {"dp_mode": "dp_ftrl", "ftrl_rounds": 4, "privacy": _DP},
    {"dp_mode": "distributed", "privacy": _DP},
], ids=lambda kw: "-".join(str(v) for v in list(kw.values())[:1])
    if "dp_mode" in kw else next(iter(kw)))
def test_formerly_unported_features_are_accepted(kwargs):
    """Refused until FedDyn, q-FFL, PEFT and the DP-SGD, DP-FTRL and
    distributed-DP mechanisms were ported; now each is taken and builds an
    engine (their rounds are held to the JAX engine in
    tests/test_torch_feddyn_qffl_peft.py, test_torch_dp_sgd.py,
    test_torch_dp_ftrl.py and test_torch_distributed_dp.py)."""
    arr = make_federated_arrays(load_dataset("mnist", n_train_synth=64,
                                             n_test_synth=8), 2, "iid")
    eng = FederatedRoundEngine(create_model("simple_cnn"), arr,
                               RoundEngineConfig(**kwargs), device="cpu")
    name = next(iter(kwargs))
    assert getattr(eng.config, name) == kwargs[name]


@pytest.mark.parametrize("kwargs,message", [
    ({"uplink_compression": "gzip"},
     "uplink_compression='gzip' not in ('none', 'int8', 'topk', "
     "'powersgd')"),
    ({"downlink_compression": "int4"},
     "downlink_compression='int4' not in ('none', 'bfloat16', 'int8')"),
], ids=["uplink", "downlink"])
def test_compression_kinds_are_checked_with_the_reference_messages(
        kwargs, message):
    with pytest.raises(ValueError) as err:
        RoundEngineConfig(**kwargs)
    assert str(err.value) == message
    with pytest.raises(ValueError) as jerr:
        JaxEngine(jax_create_model("simple_cnn"), jax_make_arrays(
            jax_load_dataset("mnist", n_train_synth=64, n_test_synth=8), 2,
            "iid"), JaxConfig(**kwargs))
    assert str(jerr.value) == message


def test_powersgd_rank_below_one_is_refused():
    arr = make_federated_arrays(load_dataset("mnist", n_train_synth=64,
                                             n_test_synth=8), 2, "iid")
    with pytest.raises(ValueError, match="powersgd rank must be ≥ 1"):
        FederatedRoundEngine(create_model("simple_cnn"), arr,
                             RoundEngineConfig(uplink_compression="powersgd",
                                               uplink_powersgd_rank=0),
                             device="cpu")


def test_downlink_int8_round_with_no_local_work_leaves_the_master():
    """lr = 0: every client returns θ̂ itself, every delta is zero, and the
    full-precision master must come out bit for bit as it went in (θ̂'s
    quantization error is never absorbed)."""
    arr = make_federated_arrays(load_dataset("mnist", n_train_synth=128,
                                             n_test_synth=8), 4, "iid",
                                samples_per_client=16)
    eng = FederatedRoundEngine(
        create_model("simple_cnn", fused_conv_block="residual"), arr,
        RoundEngineConfig(training=FederatedTrainingConfig(
            local_epochs=1, batch_size=8, learning_rate=0.0),
            downlink_compression="int8"), device="cpu")
    before = {l: {k: v.clone() for k, v in d.items()}
              for l, d in eng.global_variables["params"].items()}
    eng.run_round(evaluate=False)
    for l, leaves in before.items():
        for k, v in leaves.items():
            assert torch.equal(eng.global_variables["params"][l][k], v)


@pytest.mark.parametrize("kwargs", [
    {"optimizer_type": "sgd"}, {"proximal_mu": 0.01},
    {"param_storage_dtype": "bfloat16"},
], ids=lambda kw: next(iter(kw)))
def test_training_options_are_the_reference_config(kwargs):
    """Formerly refused; now each is taken and the config equals the
    reference's field for field (the rounds are held to the JAX engine in
    tests/test_torch_fl_variants.py)."""
    assert (FederatedTrainingConfig(**kwargs).to_dict()
            == JaxTrainingConfig(**kwargs).to_dict())


def _profile_script_engine(**overrides):
    """``scripts/profile_bench_round.py``'s engine (its ``use_pallas_dp``
    choice among the overrides), at 4 clients of 16 samples on the CPU."""
    arr = make_federated_arrays(load_dataset("mnist", n_train_synth=64,
                                             n_test_synth=8), 4, "iid",
                                samples_per_client=16)
    cfg = RoundEngineConfig(
        training=FederatedTrainingConfig(local_epochs=1, batch_size=16,
                                         learning_rate=0.001,
                                         optimizer_type="adam",
                                         optimizer_state_dtype="bfloat16"),
        dp_mode="delta",
        privacy=PrivacyConfig(epsilon=1.0, delta=1e-5, max_grad_norm=1.0),
        epsilon_per_round=0.02, delta_per_round=1e-7, max_clients=4, seed=0,
        **overrides)
    return FederatedRoundEngine(
        create_model("simple_cnn", dtype=torch.bfloat16), arr, cfg,
        device="cpu")


def test_use_pallas_dp_false_takes_the_plain_version(monkeypatch):
    """The reference's ``use_pallas_dp``: None dispatches by device
    (``ops.dp.clip_noise``: K3 on a card, the plain version here), False
    calls the plain version directly; on the CPU both give the same round
    bit for bit."""
    from fl_tpu_torch.ops import dp as dp_ops

    calls = []
    dispatch = dp_ops.clip_noise
    monkeypatch.setattr(dp_ops, "clip_noise", lambda *a: (
        calls.append("dispatch"), dispatch(*a))[1])
    weights = {}
    for use in (None, False):
        calls.clear()
        eng = _profile_script_engine(use_pallas_dp=use)
        eng.run_round(evaluate=False)
        weights[use] = eng.get_model_weights()
        assert calls == (["dispatch"] * 2 if use is None else []), use
    for k, v in weights[None].items():
        assert torch.equal(weights[False][k], v), k


def test_use_pallas_dp_true_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        _profile_script_engine(use_pallas_dp=True)


def test_compute_dtype_is_accepted_and_ignored():
    """The reference declares ``compute_dtype`` and reads it nowhere; the
    port takes it and leaves the round to the model's dtype."""
    assert RoundEngineConfig().compute_dtype == JaxConfig().compute_dtype
    want = _profile_script_engine()
    got = _profile_script_engine(compute_dtype="bfloat16")
    want.run_round(evaluate=False)
    got.run_round(evaluate=False)
    for k, v in want.get_model_weights().items():
        assert torch.equal(got.get_model_weights()[k], v), k


def test_delta_dp_needs_a_privacy_config():
    arr = make_federated_arrays(load_dataset("mnist", n_train_synth=64,
                                             n_test_synth=8), 2, "iid")
    with pytest.raises(ValueError, match="PrivacyConfig"):
        FederatedRoundEngine(create_model("simple_cnn"), arr,
                             RoundEngineConfig(dp_mode="delta"), device="cpu")


def test_default_device_is_the_gpu_and_raises_without_one():
    """No ``device`` argument means the card: where there is none the engine
    says so instead of carrying on on the CPU."""
    arr = make_federated_arrays(load_dataset("mnist", n_train_synth=64,
                                             n_test_synth=8), 2, "iid")
    if torch.cuda.is_available():
        eng = FederatedRoundEngine(create_model("simple_cnn"), arr,
                                   RoundEngineConfig())
        assert eng.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            FederatedRoundEngine(create_model("simple_cnn"), arr,
                                 RoundEngineConfig())


# ---------------------------------------------------------------------------
# the copied numpy modules and the import boundary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["iid", "non_iid", "pathological"])
def test_data_copies_are_byte_identical(strategy):
    js = jax_load_dataset("mnist", n_train_synth=512, n_test_synth=64,
                          seed=3)
    ts = load_dataset("mnist", n_train_synth=512, n_test_synth=64, seed=3)
    for f in ("train_images", "train_labels", "test_images", "test_labels"):
        assert np.array_equal(getattr(js, f), getattr(ts, f))
    jp = jax_partition(js.train_labels, 8, strategy, seed=1)
    tp = partition_indices(ts.train_labels, 8, strategy, seed=1)
    assert all(np.array_equal(a, b) for a, b in zip(jp, tp))
    ja = jax_make_arrays(js, 8, strategy, seed=1)
    ta = make_federated_arrays(ts, 8, strategy, seed=1)
    for f in ("images", "labels", "num_samples", "mean", "std"):
        a, b = getattr(ja, f), getattr(ta, f)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_port_imports_no_jax():
    code = (
        "import sys, importlib, pkgutil, fl_tpu_torch\n"
        "for m in pkgutil.walk_packages(fl_tpu_torch.__path__, "
        "'fl_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'fl_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('fl_tpu_torch')]))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
