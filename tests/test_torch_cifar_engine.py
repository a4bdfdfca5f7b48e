"""One CIFAR10CNN (BatchNorm) round of the port's engine against fl_tpu's,
on the CPU, and the engine's treatment of ``batch_stats``.

The random draws are out of the comparison as in
``tests/test_torch_engine.py``: dropout 0, augmentation off,
``samples_per_client == batch_size == 8`` (each epoch one full-batch step,
so the shuffle cannot change it), delta DP at ε = 1e9 (the clip over the
whole variables tree, statistics included, is exercised; the noise is
negligible). The port starts from the JAX engine's initial variables.
Tolerances: f32 at least 99.9% of parameter elements within 1e-5, bf16 at
least 99.9% within the reference's one-round tolerances (rtol 2e-2 / atol
1e-3; train loss rtol 5e-2), and in both every element within 2·steps·lr,
the most two trajectories of ``steps`` local steps can part when an Adam
step (which moves an element by about lr at most) turns the other way: a
conv bias ahead of a BatchNorm has an exactly-zero gradient, so its Adam
steps are rounding noise in either package. The statistics: f32 rtol
1e-5, bf16 within bf16's resolution, and under the int8 uplink within one
quantization step (their largest move / 127) where the two packages'
deltas fall on either side of a rounding boundary. FedAdam (server lr
1e-3) adds its own step, up to the server lr an element, to the bound.

Cases (2 or 3 clients each): f32 with the int8 uplink (error feedback
over the statistics too); bf16; FedAdam on the params with the statistics
not aggregated (``aggregate_batch_stats=False``: they stay the broadcast
ones); FedNova under heterogeneous budgets (the statistics averaged with
the plain sample weights, a spent client's kept by the masked select);
DP-FTRL (the statistics frozen, as the reference warns); and the three
refusals of a BatchNorm model (dp_sgd, FedDyn, q-FFL) with the reference's
messages. Also a checkpoint round trip with ``batch_stats`` (port only).
"""

import functools

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
from fl_tpu.models import create_model as jax_create_model
from fl_tpu.orchestration import FederatedRoundEngine as JaxEngine
from fl_tpu.orchestration import RoundEngineConfig as JaxConfig
from fl_tpu_torch.core.pytree import flatten_dict
from fl_tpu_torch.core.types import PrivacyConfig
from fl_tpu_torch.data import load_dataset, make_federated_arrays
from fl_tpu_torch.fl import dp_ftrl as tftrl
from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
from fl_tpu_torch.models import (
    create_model,
    variables_from_flax,
    variables_to_flax,
)
from fl_tpu_torch.orchestration import FederatedRoundEngine, RoundEngineConfig
from fl_tpu_torch.orchestration.checkpoint import (
    restore_engine_checkpoint,
    save_engine_checkpoint,
)

LR = 1e-3
N = 8
Z_FTRL = 1e-6
DELTA = dict(dp_mode="delta")
PRIV = dict(epsilon=1e9, delta=1e-5, max_grad_norm=1.0)

# case -> (clients, dtype, engine config, training config, epoch budgets)
CASES = {
    "f32-int8-uplink": (3, "f32", dict(DELTA, uplink_compression="int8"),
                        {}, None),
    "bf16": (2, "bf16", DELTA, {"optimizer_state_dtype": "bfloat16"}, None),
    "fedadam-stats-not-aggregated": (
        2, "f32", dict(DELTA, server_optimizer="fedadam", server_lr=1e-3,
                       aggregate_batch_stats=False), {}, None),
    "fednova-budgets": (3, "f32", dict(DELTA, fednova=True),
                        {"optimizer_type": "sgd", "momentum": 0.9,
                         "learning_rate": 0.01}, [1, 2, 2]),
    "dp_ftrl-frozen-stats": (
        2, "f32", dict(dp_mode="dp_ftrl", ftrl_rounds=4,
                       ftrl_max_participations=2, ftrl_tree_nonce=7),
        {}, None),
}
REFUSALS = {
    "dp_sgd": dict(dp_mode="dp_sgd"),
    "feddyn": dict(feddyn_alpha=0.01),
    "qffl": dict(qffl_q=1.0),
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


@functools.lru_cache(maxsize=None)
def _arrays(clients):
    kw = dict(num_clients=clients, strategy="iid", samples_per_client=N,
              seed=0)
    return (jax_make_arrays(jax_load_dataset("cifar10", n_train_synth=64,
                                             n_test_synth=16), **kw),
            make_federated_arrays(load_dataset("cifar10", n_train_synth=64,
                                               n_test_synth=16), **kw))


def _privacy(cfg):
    if cfg.get("dp_mode") == "dp_ftrl":
        return dict(epsilon=tftrl.gaussian_epsilon(Z_FTRL, 1e-5) + 1.0,
                    delta=1e-5, max_grad_norm=0.5, noise_multiplier=Z_FTRL)
    if cfg.get("dp_mode") == "delta":
        return PRIV
    return None


def _engines(clients, dtype, cfg, train):
    jarr, tarr = _arrays(clients)
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[dtype]
    train = dict(dict(local_epochs=2, batch_size=N, learning_rate=LR),
                 **train)
    priv = _privacy(cfg)
    common = dict(min_clients=2, seed=0, **cfg)
    jeng = JaxEngine(
        jax_create_model("cifar10_cnn", dtype=jdt, dropout_rate=0.0), jarr,
        JaxConfig(training=JaxTrainingConfig(**train),
                  privacy=None if priv is None else JaxPrivacyConfig(**priv),
                  **common))
    teng = FederatedRoundEngine(
        create_model("cifar10_cnn", dtype=tdt, dropout_rate=0.0), tarr,
        RoundEngineConfig(training=FederatedTrainingConfig(**train),
                          privacy=None if priv is None
                          else PrivacyConfig(**priv), **common),
        device="cpu")
    return jeng, teng


def _flat(variables):
    return {k: np.asarray(v, np.float32) for k, v in
            flatten_dict(variables).items()}


def _params_close(got, want, dtype, bound):
    diff = np.abs(got - want)
    tol = 2e-2 * np.abs(want) + 1e-3 if dtype == "bf16" else 1e-5
    assert (diff <= tol).mean() >= 0.999, np.sort(diff)[-10:]
    assert diff.max() <= bound, diff.max()


@pytest.mark.parametrize("case", list(CASES) + list(REFUSALS))
def test_cifar_round_matches_jax(case):
    if case in REFUSALS:
        kw = REFUSALS[case]
        priv = (dict(epsilon=10.0, delta=1e-5, max_grad_norm=1.0,
                     noise_multiplier=1.0) if "dp_mode" in kw else None)
        jarr, tarr = _arrays(2)
        with pytest.raises(ValueError) as want:
            JaxEngine(jax_create_model("cifar10_cnn"), jarr, JaxConfig(
                privacy=None if priv is None else JaxPrivacyConfig(**priv),
                **kw))
        with pytest.raises(ValueError) as got:
            FederatedRoundEngine(
                create_model("cifar10_cnn"), tarr, RoundEngineConfig(
                    privacy=None if priv is None else PrivacyConfig(**priv),
                    **kw), device="cpu")
        assert str(got.value) == str(want.value)
        assert "norm='group'" in str(got.value)
        return

    clients, dtype, cfg, train, budgets = CASES[case]
    jeng, teng = _engines(clients, dtype, cfg, train)
    teng.global_variables = variables_from_flax(
        jax.device_get(jeng.global_variables))
    init = _flat(teng.global_variables)
    assert sorted(init) == sorted(_flat(jax.device_get(
        jeng.global_variables))) == sorted(teng.get_model_weights())
    if budgets is not None:
        jeng.epochs_per_client = np.array(budgets, np.int32)
        teng.epochs_per_client = np.array(budgets, np.int32)
    jr = jeng.run_round(evaluate=False)
    tr = teng.run_round(evaluate=False)
    assert tr.participating_clients == jr.participating_clients == clients
    np.testing.assert_allclose(tr.train_loss, jr.train_loss,
                               rtol=5e-2 if dtype == "bf16" else 1e-4)
    want = _flat(jax.device_get(jeng.global_variables))
    got = _flat(teng.global_variables)
    assert sorted(got) == sorted(want)
    params = [k for k in want if k.startswith("params/")]
    t = dict(dict(local_epochs=2, learning_rate=LR), **train)
    # FedAdam's step lr_s·m/(√v + ε) moves an element by up to lr_s
    bound = 2 * (t["local_epochs"] * t["learning_rate"]
                 + cfg.get("server_lr", 0.0))
    _params_close(np.concatenate([got[k].ravel() for k in params]),
                  np.concatenate([want[k].ravel() for k in params]), dtype,
                  bound)
    stats = [k for k in want if k.startswith("batch_stats/")]
    assert len(stats) == 12
    frozen = (case.startswith("dp_ftrl")
              or not cfg.get("aggregate_batch_stats", True))
    int8_step = (max(np.abs(want[k] - init[k]).max() for k in stats) / 127
                 if cfg.get("uplink_compression") == "int8" else 0.0)
    for k in stats:
        if frozen:
            # the statistics never move: bit for bit their initial values
            np.testing.assert_array_equal(got[k], init[k], err_msg=k)
            np.testing.assert_array_equal(want[k], init[k], err_msg=k)
        elif dtype == "bf16":
            np.testing.assert_allclose(got[k], want[k], rtol=2 ** -7,
                                       atol=1e-3, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6 + int8_step, err_msg=k)
            assert not np.array_equal(got[k], init[k]), k
    if cfg.get("uplink_compression") == "int8":
        ef_t = teng.uplink_error.numpy()
        ef_j = np.asarray(jax.device_get(jeng.uplink_error))
        assert ef_t.shape == ef_j.shape
        _params_close(ef_t, ef_j, dtype, bound)


def test_checkpoint_round_trip_keeps_batch_stats(tmp_path):
    """A restored engine holds the statistics bit for bit and its next round
    equals the uninterrupted engine's."""
    _, tarr = _arrays(2)

    def engine():
        return FederatedRoundEngine(
            create_model("cifar10_cnn", dropout_rate=0.0), tarr,
            RoundEngineConfig(training=FederatedTrainingConfig(
                local_epochs=1, batch_size=N), dp_mode="delta",
                privacy=PrivacyConfig(**PRIV), epsilon_per_round=1e8,
                delta_per_round=1e-7,
                min_clients=2, seed=0),
            device="cpu")

    a = engine()
    a.run_round(evaluate=False)
    save_engine_checkpoint(a, str(tmp_path))
    b = engine()
    assert restore_engine_checkpoint(b, str(tmp_path)) == 1
    for k, v in _flat(a.global_variables).items():
        np.testing.assert_array_equal(_flat(b.global_variables)[k], v)
    assert "batch_stats" in b.global_variables
    a.run_round(evaluate=False)
    b.run_round(evaluate=False)
    wa, wb = variables_to_flax(a.global_variables), \
        variables_to_flax(b.global_variables)
    for k, v in flatten_dict(wa).items():
        np.testing.assert_array_equal(flatten_dict(wb)[k], v, err_msg=k)
