"""Engine rounds of the slice's four configurations against fl_tpu's
FederatedRoundEngine, and the feature rules of the new features against
``fl_tpu.orchestration.features.validate_config``'s messages.

The configurations are those that ``chip_smoke.py`` drives on the card
(``phase_fl_variants``) at 4 clients:

- V1: SGD with momentum 0.9, FedNova, epoch budgets 1..3 of 3, delta DP;
- V2: AdamW, FedProx, bf16 parameter storage, coordinate median, delta DP;
- V3: SCAFFOLD with plain SGD, no DP;
- V4: FedAdam on the server (lr 0.01), secure aggregation, delta DP.

Round 1 runs through ``run_round`` and round 2 through
``run_rounds_pipelined``. The draws are out of the comparison as in
``tests/test_torch_engine.py``: dropout 0, ``samples_per_client ==
batch_size == 16`` and ε = 1e8 a round (σ ≈ 6e-8). The models compute in
f32: at least 99.9% of the parameters within 1e-5 and all within 2e-3,
2·lr of Adam (whose step can turn on the sign of a near-zero gradient; the
SGD cells stay far inside it), train loss
rtol 1e-5 — except V2, whose bf16 parameter storage is held at the
reference's bf16 round tolerances (rtol 2e-2 / atol 1e-3, loss rtol
5e-2), with the port's rounding seeds replaced by the reference's so that
both round with the same bits, and round 2 started from the reference's
round-1 model: a value 1e-7 apart rounds to the other bf16 neighbour now
and then (6e-5 after round 1), and that one ulp turns the sign of the
first Adam step of round 2 on about 2% of fc1's near-zero gradients, 2·lr
each, whichever package is right. V4's pairwise masks differ in their
bits and cancel to within float error. SCAFFOLD's c and c_i (rtol 1e-4 /
atol 1e-5: the variates divide the deltas by K·lr) and FedAdam's moments
after round 1 are compared as well, the moments through the
pseudo-gradient they hold.
"""

import numpy as np
import pytest
import torch

import jax
from fl_tpu.core import prng as jprng
from fl_tpu.core.types import PrivacyConfig as JaxPrivacyConfig
from fl_tpu.data import load_dataset as jax_load_dataset
from fl_tpu.data import make_federated_arrays as jax_make_arrays
from fl_tpu.fl.local_training import \
    FederatedTrainingConfig as JaxTrainingConfig
from fl_tpu.models import create_model as jax_create_model
from fl_tpu.orchestration import FederatedRoundEngine as JaxEngine
from fl_tpu.orchestration import RoundEngineConfig as JaxConfig
from fl_tpu.orchestration.features import validate_config
from fl_tpu_torch.core import prng
from fl_tpu_torch.core.types import PrivacyConfig
from fl_tpu_torch.fl import local_training as tlt
from fl_tpu_torch.data import load_dataset, make_federated_arrays
from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
from fl_tpu_torch.fl.scaffold import state_from_reference
from fl_tpu_torch.fl.server_optimizer import state_from_optax
from fl_tpu_torch.models import create_model, params_from_flax, params_to_flax
from fl_tpu_torch.orchestration import FederatedRoundEngine, RoundEngineConfig

C = 4
DP = dict(dp_mode="delta", epsilon_per_round=1e8, delta_per_round=1e-7)
PRIVACY = dict(epsilon=1e9, delta=1e-5, max_grad_norm=1.0)

VARIANTS = {
    "V1": (dict(optimizer_type="sgd", momentum=0.9, learning_rate=0.01,
                local_epochs=3),
           dict(fednova=True, **DP), [1, 2, 3, 3]),
    "V2": (dict(optimizer_type="adamw", weight_decay=1e-4, proximal_mu=0.01,
                param_storage_dtype="bfloat16", learning_rate=1e-3),
           dict(aggregation="median", **DP), None),
    "V3": (dict(optimizer_type="sgd", momentum=0.0, learning_rate=0.05),
           dict(scaffold=True), None),
    "V4": (dict(optimizer_type="adam", learning_rate=1e-3),
           dict(server_optimizer="fedadam", server_lr=0.01,
                secure_aggregation=True, **DP), None),
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


def _arrays():
    kw = dict(num_clients=C, strategy="iid", samples_per_client=16, seed=0)
    return (jax_make_arrays(jax_load_dataset("mnist", n_train_synth=256,
                                             n_test_synth=16), **kw),
            make_federated_arrays(load_dataset("mnist", n_train_synth=256,
                                               n_test_synth=16), **kw))


def _engine_pair(name):
    train, cfg, budgets = VARIANTS[name]
    train = dict(dict(local_epochs=2, batch_size=16), **train)
    jarr, tarr = _arrays()
    priv = "dp_mode" in cfg
    jeng = JaxEngine(
        jax_create_model("simple_cnn", fused_conv_block="residual",
                         dropout_rate=0.0), jarr,
        JaxConfig(training=JaxTrainingConfig(**train), seed=0,
                  privacy=JaxPrivacyConfig(**PRIVACY) if priv else None,
                  **cfg))
    teng = FederatedRoundEngine(
        create_model("simple_cnn", fused_conv_block="residual",
                     dropout_rate=0.0), tarr,
        RoundEngineConfig(training=FederatedTrainingConfig(**train), seed=0,
                          privacy=PrivacyConfig(**PRIVACY) if priv else None,
                          **cfg), device="cpu")
    teng.global_variables = {"params": params_from_flax(
        jax.device_get(jeng.global_variables["params"]))}
    if budgets is not None:
        jeng.epochs_per_client = budgets
        teng.epochs_per_client = budgets
    return jeng, teng


def _snapshot(jeng, teng, jr, tr):
    out = {"loss": (jr.train_loss, tr.train_loss),
           "params": (jax.device_get(jeng.global_variables["params"]),
                      params_to_flax(teng.global_variables["params"]))}
    if jeng.config.scaffold:
        out["scaffold"] = (
            state_from_reference(jax.device_get(jeng.scaffold_c),
                                 jax.device_get(jeng.scaffold_ci)),
            (teng.scaffold_c.clone(), teng.scaffold_ci.clone()))
    if jeng.server_opt_state is not None:
        out["server"] = (state_from_optax(jax.device_get(
            jeng.server_opt_state)), teng.server_opt_state)
    return out


def _reference_rounding_seeds(seed, rounds):
    """The port's per-client rounding seeds replaced by the reference's
    (the two words of each client's ROUNDING key xor-ed), by round seed."""
    by_rseed = {}
    for r in range(rounds):
        keys = jprng.client_round_keys(jprng.root_key(seed), r, C)
        srk = np.asarray(jax.vmap(lambda k: jprng.stream_key(
            k, jprng.Stream.ROUNDING))(keys))
        by_rseed[prng.round_seed(prng.root_seed(seed), r)] = (
            (srk[:, 0] ^ srk[:, 1]).astype(np.int64))

    def seeds(rseed, num_clients, device):
        return torch.as_tensor(by_rseed[rseed]).to(device)

    return seeds


@pytest.fixture(scope="module", params=list(VARIANTS))
def rounds(request):
    """Round 1 by run_round, round 2 by run_rounds_pipelined, in both
    engines; the state after each. Under bf16 storage both packages round
    with the reference's random bits, which takes the draws out of the
    comparison: the rounding itself is the reference's bit for bit."""
    jeng, teng = _engine_pair(request.param)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlt, "rounding_seeds", _reference_rounding_seeds(0, 2))
        one = _snapshot(jeng, teng, jeng.run_round(evaluate=False),
                        teng.run_round(evaluate=False))
        if teng.config.training.param_storage_dtype is not None:
            teng.global_variables = {"params": params_from_flax(
                jax.device_get(jeng.global_variables["params"]))}
        (jr,) = jeng.run_rounds_pipelined(1)
        (tr,) = teng.run_rounds_pipelined(1)
    two = _snapshot(jeng, teng, jr, tr)
    return request.param, one, two


def _assert_round(name, snap):
    jl, tl = snap["loss"]
    jp, tp = snap["params"]
    assert sorted(jp) == sorted(tp)
    pairs = [(tp[l][k], np.asarray(jp[l][k])) for l in jp for k in jp[l]]
    if name == "V2":
        np.testing.assert_allclose(tl, jl, rtol=5e-2)
        for t, j in pairs:
            np.testing.assert_allclose(t, j, rtol=2e-2, atol=1e-3)
        return
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert_within_steps(pairs)


def assert_within_steps(pairs, tol=1e-5, bound=2e-3):
    """At least 99.9% of the elements within ``tol``, all within ``bound``
    (an f32 Adam step turned on the sign of a near-zero gradient)."""
    diff = np.concatenate([np.abs(t - j).ravel() for t, j in pairs])
    assert (diff <= tol).mean() >= 0.999, np.sort(diff)[-10:]
    assert diff.max() <= bound


def test_round_one_matches_jax(rounds):
    name, one, _ = rounds
    _assert_round(name, one)


def test_round_two_pipelined_matches_jax(rounds):
    name, _, two = rounds
    _assert_round(name, two)


def test_scaffold_variates_after_round_one_match_jax(rounds):
    name, one, two = rounds
    if name != "V3":
        assert "scaffold" not in one
        return
    for snap in (one, two):
        (jc, jci), (tc, tci) = snap["scaffold"]
        assert tc.shape == jc.shape and tci.shape == jci.shape
        np.testing.assert_allclose(tc.numpy(), jc.numpy(), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(tci.numpy(), jci.numpy(), rtol=1e-4,
                                   atol=1e-5)
    # mean(c_i) == c with every client in: the Option II invariant
    (_, _), (tc, tci) = one["scaffold"]
    np.testing.assert_allclose(tci.mean(0).numpy(), tc.numpy(), atol=1e-6)
    assert float(tc.abs().max()) > 0


def test_server_state_after_round_one_matches_jax(rounds):
    name, one, _ = rounds
    if name != "V4":
        assert "server" not in one
        return
    want, got = one["server"]
    assert got["count"] == want["count"] == 1
    # after one step μ = (1 − b1)·g and ν = (1 − b2)·g² of the
    # pseudo-gradient g = θ − θ_fedavg, which the params' criterion holds
    for key, to_g in (("mu", lambda m: m / 0.1),
                      ("nu", lambda v: np.sqrt(v / 0.01))):
        assert_within_steps([(to_g(got[key][l][k].numpy()),
                              to_g(want[key][l][k].numpy()))
                             for l in want[key] for k in want[key][l]])


# ---------------------------------------------------------------------------
# the feature rules: the reference's messages, verbatim
# ---------------------------------------------------------------------------

SGD0 = {"optimizer_type": "sgd", "momentum": 0.0}
RULE_CASES = {
    "aggregation-enum": ({"aggregation": "mean"}, {}),
    "robust-x-secure": ({"aggregation": "krum",
                         "secure_aggregation": True}, {}),
    "downlink-x-robust": ({"downlink_compression": "int8",
                           "aggregation": "median"}, {}),
    "downlink-x-secure": ({"downlink_compression": "bfloat16",
                           "secure_aggregation": True}, {}),
    "downlink-x-scaffold": ({"downlink_compression": "int8",
                             "scaffold": True}, SGD0),
    "fednova-x-robust": ({"fednova": True, "aggregation": "trimmed_mean"},
                         SGD0),
    "fednova-x-secure": ({"fednova": True, "secure_aggregation": True},
                         SGD0),
    "fednova-x-client_dp": ({"fednova": True, "dp_mode": "client_dp"},
                            SGD0),
    "fednova-x-adam": ({"fednova": True}, {}),
    "fednova-momentum-1": ({"fednova": True},
                           {"optimizer_type": "sgd", "momentum": 1.0}),
    "fednova-x-fedprox": ({"fednova": True},
                          dict(SGD0, proximal_mu=0.1)),
    "fednova-x-scaffold": ({"fednova": True, "scaffold": True}, SGD0),
    "distributed-x-secure": ({"dp_mode": "distributed",
                              "secure_aggregation": True}, {}),
    "scaffold-x-adam": ({"scaffold": True}, {}),
    "scaffold-x-momentum": ({"scaffold": True},
                            {"optimizer_type": "sgd", "momentum": 0.9}),
    "scaffold-x-delta": ({"scaffold": True, "dp_mode": "delta"}, SGD0),
    "scaffold-x-secure": ({"scaffold": True, "secure_aggregation": True},
                          SGD0),
    "scaffold-x-bf16-storage": ({"scaffold": True},
                                dict(SGD0, param_storage_dtype="bfloat16")),
    # FedDyn, q-FFL and PEFT (fl_tpu/orchestration/features.py:340-435)
    "feddyn-negative": ({"feddyn_alpha": -0.1}, {}),
    "feddyn-x-scaffold": ({"feddyn_alpha": 0.1, "scaffold": True}, SGD0),
    "feddyn-x-fednova": ({"feddyn_alpha": 0.1, "fednova": True}, SGD0),
    "feddyn-x-delta": ({"feddyn_alpha": 0.1, "dp_mode": "delta"}, {}),
    "feddyn-x-client_dp": ({"feddyn_alpha": 0.1, "dp_mode": "client_dp"},
                           {}),
    "feddyn-x-secure": ({"feddyn_alpha": 0.1, "secure_aggregation": True},
                        {}),
    "feddyn-x-robust": ({"feddyn_alpha": 0.1, "aggregation": "median"}, {}),
    "feddyn-x-uplink": ({"feddyn_alpha": 0.1, "uplink_compression": "int8"},
                        {}),
    "feddyn-x-downlink": ({"feddyn_alpha": 0.1,
                           "downlink_compression": "bfloat16"}, {}),
    "feddyn-x-fedprox": ({"feddyn_alpha": 0.1}, {"proximal_mu": 0.1}),
    "feddyn-x-bf16-storage": ({"feddyn_alpha": 0.1},
                              {"param_storage_dtype": "bfloat16"}),
    "feddyn-x-server-optimizer": ({"feddyn_alpha": 0.1,
                                   "server_optimizer": "fedadam"}, {}),
    "qffl-negative": ({"qffl_q": -1.0}, {}),
    "qffl-x-delta": ({"qffl_q": 1.0, "dp_mode": "delta"}, {}),
    "qffl-x-client_dp": ({"qffl_q": 1.0, "dp_mode": "client_dp"}, {}),
    "qffl-x-robust": ({"qffl_q": 1.0, "aggregation": "krum"}, {}),
    "qffl-x-secure": ({"qffl_q": 1.0, "secure_aggregation": True}, {}),
    "qffl-x-server-optimizer": ({"qffl_q": 1.0,
                                 "server_optimizer": "fedyogi"}, {}),
    "qffl-x-fednova": ({"qffl_q": 1.0, "fednova": True}, SGD0),
    "qffl-x-scaffold": ({"qffl_q": 1.0, "scaffold": True}, SGD0),
    "qffl-x-feddyn": ({"qffl_q": 1.0, "feddyn_alpha": 0.1}, {}),
    "qffl-x-uplink": ({"qffl_q": 0.0, "uplink_compression": "topk"}, {}),
    "peft-x-scaffold": ({"trainable_patterns": ("conv",), "scaffold": True},
                        SGD0),
    "peft-x-fednova": ({"trainable_patterns": ("conv",), "fednova": True},
                       SGD0),
    "peft-x-feddyn": ({"trainable_patterns": ("conv",),
                       "feddyn_alpha": 0.1}, {}),
}


def _configs(kwargs, train):
    return (JaxConfig(training=JaxTrainingConfig(**train), **kwargs),
            lambda: RoundEngineConfig(
                training=FederatedTrainingConfig(**train), **kwargs))


@pytest.mark.parametrize("case", list(RULE_CASES), ids=list(RULE_CASES))
def test_feature_rules_raise_the_reference_messages(case):
    jcfg, make = _configs(*RULE_CASES[case])
    with pytest.raises(ValueError) as want:
        validate_config(jcfg, C)
    with pytest.raises(ValueError) as got:
        make()
    assert str(got.value) == str(want.value)


# run_rounds_fused's refusals, in the reference's order
# (fl_tpu/orchestration/round_engine.py:1956-2000)
CLIENT_DP = {"dp_mode": "client_dp", "participation_rate": 0.5}
FUSED_CASES = {
    "scaffold": ({"scaffold": True}, SGD0),
    "feddyn": ({"feddyn_alpha": 0.1}, {}),
    "server-optimizer": ({"server_optimizer": "fedavgm"}, {}),
    "adaptive-clipping": (dict(CLIENT_DP, adaptive_clipping=True,
                               clip_count_stddev=4.0), {}),
    "audit-injection": (dict(CLIENT_DP, audit_injection=True), {}),
    # a budget that does not cover all R rounds, before any dispatch
    "budget-delta": ({"dp_mode": "delta", "epsilon_per_round": 0.6,
                      "delta_per_round": 1e-7}, {}),
    "budget-client_dp": (CLIENT_DP, {}),
}


@pytest.mark.parametrize("case", list(FUSED_CASES), ids=list(FUSED_CASES))
def test_fused_runner_refusals_raise_the_reference_messages(case):
    kwargs, train = FUSED_CASES[case]
    priv = dict(epsilon=1.0, delta=1e-5, noise_multiplier=1.0)
    jarr, tarr = _arrays()
    jeng = JaxEngine(
        jax_create_model("simple_cnn"), jarr,
        JaxConfig(training=JaxTrainingConfig(**train),
                  privacy=JaxPrivacyConfig(**priv), **kwargs))
    teng = FederatedRoundEngine(
        create_model("simple_cnn"), tarr,
        RoundEngineConfig(training=FederatedTrainingConfig(**train),
                          privacy=PrivacyConfig(**priv), **kwargs),
        device="cpu")
    masks = np.ones((3, C), np.float32)
    # ValueError, or PrivacyError for the budget
    with pytest.raises(Exception) as want:
        jeng.run_rounds_fused(3, masks=masks, evaluate=False)
    with pytest.raises(Exception) as got:
        teng.run_rounds_fused(3, masks=masks, evaluate=False)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    assert teng.round_number == 0 and teng.history == []


@pytest.mark.parametrize("name", list(VARIANTS))
def test_the_slice_configurations_are_accepted(name):
    train, cfg, _ = VARIANTS[name]
    jcfg, make = _configs(cfg, train)
    validate_config(jcfg, 512)
    make()


@pytest.mark.parametrize("kwargs", [
    {"aggregation": "trimmed_mean", "trim_k": 2},
    {"aggregation": "trimmed_mean", "trim_k": 1,
     "participation_rate": 0.5},
], ids=["k2", "q0.5"])
def test_trimmed_mean_rule_needs_the_client_count(kwargs):
    with pytest.raises(ValueError) as want:
        validate_config(JaxConfig(**kwargs), C)
    jarr, tarr = _arrays()
    cfg = RoundEngineConfig(**kwargs)   # the rule is the engine's
    with pytest.raises(ValueError) as got:
        FederatedRoundEngine(create_model("simple_cnn"), tarr, cfg,
                             device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kwargs,mask", [
    ({"aggregation": "trimmed_mean", "trim_k": 1}, [1, 1, 0, 0]),
    ({"aggregation": "krum", "krum_f": 1}, [1, 1, 1, 1]),
], ids=["trimmed_mean", "krum"])
def test_realized_participants_are_checked_at_dispatch(kwargs, mask):
    jarr, tarr = _arrays()
    jeng = JaxEngine(jax_create_model("simple_cnn"), jarr,
                     JaxConfig(**kwargs))
    teng = FederatedRoundEngine(create_model("simple_cnn"), tarr,
                                RoundEngineConfig(**kwargs), device="cpu")
    mask = np.asarray(mask, np.float32)
    with pytest.raises(ValueError) as want:
        jeng.run_round(mask=mask, evaluate=False)
    for run in (lambda: teng.run_round(mask=mask, evaluate=False),
                lambda: teng.run_rounds_pipelined(1, masks=[mask])):
        with pytest.raises(ValueError) as got:
            run()
        assert str(got.value) == str(want.value)
    assert teng.round_number == 0 and teng.history == []


def test_epochs_per_client_is_a_checked_read_only_view():
    jarr, tarr = _arrays()
    jeng = JaxEngine(jax_create_model("simple_cnn"), jarr, JaxConfig())
    teng = FederatedRoundEngine(create_model("simple_cnn"), tarr,
                                RoundEngineConfig(), device="cpu")
    assert np.array_equal(teng.epochs_per_client, jeng.epochs_per_client)
    with pytest.raises(ValueError):
        teng.epochs_per_client[0] = 1
    for bad in ([1, 2, 3], [1, 2, 9, 1]):
        with pytest.raises(ValueError) as want:
            jeng.epochs_per_client = bad
        with pytest.raises(ValueError) as got:
            teng.epochs_per_client = bad
        assert str(got.value) == str(want.value)
    teng.epochs_per_client = [1, 5, 0, 3]
    assert teng.epochs_per_client.tolist() == [1, 5, 0, 3]
    assert not teng._is_homogeneous()
    teng.epochs_per_client = [5, 5, 5, 5]
    assert teng._is_homogeneous()


def test_unknown_server_optimizer_is_refused_when_the_engine_is_built():
    jarr, tarr = _arrays()
    with pytest.raises(ValueError) as want:
        JaxEngine(jax_create_model("simple_cnn"), jarr,
                  JaxConfig(server_optimizer="fedsgd"))
    with pytest.raises(ValueError) as got:
        FederatedRoundEngine(create_model("simple_cnn"), tarr,
                             RoundEngineConfig(server_optimizer="fedsgd"),
                             device="cpu")
    assert str(got.value) == str(want.value)
