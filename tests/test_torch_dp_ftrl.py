"""DP-FTRL (``dp_mode="dp_ftrl"``, ``fl_tpu_torch.fl.dp_ftrl``) of the
port against fl_tpu.

The accounting functions are numpy copies and must give EQUAL values. The
tree noise is the port's own stream (node seeds from ``core.prng``), held
by its structure: the same node gives the same draw bit for bit in every
prefix that reuses it, and the noise of prefix t has popcount(t) nodes'
variance. ``ftrl_server_step`` at zero noise is held to the reference's at
f32 rtol 1e-6. Engine rounds take the draws out as ``tests/
test_torch_central_dp.py`` does (dropout 0, ``samples_per_client ==
batch_size == 16``, the port starts from the JAX engine's parameters) and
the tree noise with them (z = 1e-6, so σ_node ≈ 1.7e-6 an element; the
budget is the ε that z certifies): f32 params at least 99.9% within 1e-5
and all within 2e-3 = 2·lr (as ``tests/test_torch_fl_engines.py``: a
client's f32 Adam step on a near-zero gradient can turn its sign with a
summation order, and the FTRL step passes it on through the momentum),
train loss rtol 1e-5 in round 1 and 1e-4 in round 2
(which starts from models that differ by the two packages' tree noise and
f32 sums), the carried prefix sum held the same way with all within 4e-3
(a turned step in each of a client's two rounds), the ε charged once
and the ledger equal. The refusals raise the reference's messages, and a
resumed engine continues bit for bit, its tree nonce included.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from fl_tpu.core.types import PrivacyConfig as JaxPrivacyConfig
from fl_tpu.data import load_dataset as jax_load_dataset
from fl_tpu.data import make_federated_arrays as jax_make_arrays
from fl_tpu.fl import dp_ftrl as jftrl
from fl_tpu.fl import privacy as jdp
from fl_tpu.fl.local_training import \
    FederatedTrainingConfig as JaxTrainingConfig
from fl_tpu.models import create_model as jax_create_model
from fl_tpu.orchestration import FederatedRoundEngine as JaxEngine
from fl_tpu.orchestration import RoundEngineConfig as JaxConfig
from fl_tpu.orchestration.features import validate_config
from fl_tpu_torch.core import prng
from fl_tpu_torch.core.types import PrivacyConfig
from fl_tpu_torch.data import load_dataset, make_federated_arrays
from fl_tpu_torch.fl import dp_ftrl as tftrl
from fl_tpu_torch.fl import privacy as tdp
from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
from fl_tpu_torch.models import create_model, params_from_flax, params_to_flax
from fl_tpu_torch.orchestration import FederatedRoundEngine, RoundEngineConfig
from fl_tpu_torch.orchestration.checkpoint import (
    restore_engine_checkpoint,
    save_engine_checkpoint,
)

C = 4


# ---------------------------------------------------------------------------
# the numpy functions: equal values
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("z", [0.0, 0.5, 1.0, 2.0, 4.0, 1e-6])
def test_gaussian_epsilon_equals_the_reference(z):
    for delta in (1e-5, 1e-3):
        assert (tftrl.gaussian_epsilon(z, delta)
                == jftrl.gaussian_epsilon(z, delta))


@pytest.mark.parametrize("eps", [0.5, 1.0, 4.0])
def test_calibration_equals_the_reference(eps):
    z = tftrl.calibrate_noise_multiplier(eps, 1e-5)
    assert z == jftrl.calibrate_noise_multiplier(eps, 1e-5)
    assert tftrl.gaussian_epsilon(z, 1e-5) <= eps
    assert tftrl.gaussian_epsilon(z * 0.98, 1e-5) > eps


def test_tree_geometry_equals_the_reference():
    for t in (1, 2, 3, 7, 8, 9, 100, 1000):
        assert tftrl.tree_height(t) == jftrl.tree_height(t)
        assert tftrl.prefix_node_count(t) == jftrl.prefix_node_count(t)
        for k in (1, 3):
            assert (tftrl.ftrl_sensitivity(1.5, t, k)
                    == jftrl.ftrl_sensitivity(1.5, t, k))
    with pytest.raises(ValueError, match="t_max"):
        tftrl.tree_height(0)
    for n, m, r in [(8, 4, 0), (8, 4, 1), (10, 3, 5), (512, 51, 7)]:
        np.testing.assert_array_equal(tftrl.rotation_mask(n, r, m),
                                      jftrl.rotation_mask(n, r, m))
        assert (tftrl.max_rounds_within_participations(n, m, 2)
                == jftrl.max_rounds_within_participations(n, m, 2))
    with pytest.raises(ValueError, match="cohort_size"):
        tftrl.rotation_mask(4, 0, 5)


# ---------------------------------------------------------------------------
# the tree noise and the server step
# ---------------------------------------------------------------------------

def _node(seed, level, index, dim, sigma=1.0):
    g = prng.generator(tftrl.node_seed(seed, level, index), "cpu")
    return sigma * torch.randn((dim,), generator=g)


def test_tree_noise_reuses_nodes_exactly():
    """t=2's cover is node (1, 0); t=3's is (0, 2) and (1, 0): the shared
    node is the same draw bit for bit, regenerated from its seed alone;
    t=4's cover (2, 0) is a fresh node."""
    seed, dim, sigma = 99, 256, 0.7
    n2 = tftrl.tree_noise_prefix(seed, 2, dim, sigma, 4)
    assert torch.equal(n2, tftrl.tree_noise_prefix(seed, 2, dim, sigma, 4))
    assert torch.equal(n2, torch.zeros(dim) + _node(seed, 1, 0, dim, sigma))
    n3 = tftrl.tree_noise_prefix(seed, 3, dim, sigma, 4)
    assert torch.equal(n3, torch.zeros(dim) + _node(seed, 0, 2, dim, sigma)
                       + _node(seed, 1, 0, dim, sigma))
    n4 = tftrl.tree_noise_prefix(seed, 4, dim, sigma, 4)
    assert torch.equal(n4, torch.zeros(dim) + _node(seed, 2, 0, dim, sigma))
    assert not torch.equal(n4, n2)
    # another tree nonce, other nodes
    assert not torch.equal(n2, tftrl.tree_noise_prefix(seed + 1, 2, dim,
                                                       sigma, 4))


@pytest.mark.parametrize("t", [1, 6, 7, 8, 13])
def test_tree_noise_variance_tracks_popcount(t):
    """Var = popcount(t)·σ² (rel 0.15, the reference's check) and the
    noise / its std is N(0, 1) by a Kolmogorov–Smirnov test at 1e-3."""
    n = tftrl.tree_noise_prefix(42, t, 4096, 2.0, 4).double().numpy()
    want = tftrl.prefix_node_count(t) * 4.0
    assert float(n.var()) == pytest.approx(want, rel=0.15)
    assert stats.kstest(n / math.sqrt(want), "norm").pvalue > 1e-3


@pytest.mark.parametrize("momentum,t", [(0.0, 1), (0.9, 3), (0.5, 6)])
def test_server_step_at_zero_noise_equals_the_reference(momentum, t):
    rng = np.random.default_rng(t)
    args = [rng.normal(size=(300,)).astype(np.float32) for _ in range(5)]
    want = jftrl.ftrl_server_step(*map(jnp.asarray, args),
                                  jax.random.PRNGKey(0), jnp.uint32(t), 0.0,
                                  4, 0.5, 3.0, momentum)
    got = tftrl.ftrl_server_step(*map(torch.from_numpy, args), 7, t, 0.0, 4,
                                 0.5, 3.0, momentum)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# engine rounds against the JAX engine
# ---------------------------------------------------------------------------

Z = 1e-6
PRIV = dict(epsilon=tftrl.gaussian_epsilon(Z, 1e-5) + 1.0, delta=1e-5,
            max_grad_norm=0.5, noise_multiplier=Z)
FTRL = dict(dp_mode="dp_ftrl", ftrl_rounds=4, ftrl_max_participations=2,
            ftrl_server_lr=1.0, ftrl_momentum=0.9, ftrl_tree_nonce=7,
            seed=0)


@functools.lru_cache(maxsize=None)
def _arrays():
    kw = dict(num_clients=C, strategy="iid", samples_per_client=16, seed=0)
    return (jax_make_arrays(jax_load_dataset("mnist", n_train_synth=256,
                                             n_test_synth=64), **kw),
            make_federated_arrays(load_dataset("mnist", n_train_synth=256,
                                               n_test_synth=64), **kw))


def _port_engine(tarr=None, privacy=PRIV, **cfg):
    if tarr is None:
        tarr = _arrays()[1]
    train = dict(local_epochs=2, batch_size=16, learning_rate=1e-3)
    return FederatedRoundEngine(
        create_model("simple_cnn", dropout_rate=0.0,
                     fused_conv_block="residual"), tarr,
        RoundEngineConfig(training=FederatedTrainingConfig(**train),
                          privacy=PrivacyConfig(**privacy),
                          **dict(FTRL, **cfg)), device="cpu")


def _jax_engine(jarr, privacy=PRIV, **cfg):
    train = dict(local_epochs=2, batch_size=16, learning_rate=1e-3)
    return JaxEngine(
        jax_create_model("simple_cnn", fused_conv_block="residual",
                         dropout_rate=0.0), jarr,
        JaxConfig(training=JaxTrainingConfig(optimizer_type="adam",
                                             **train),
                  privacy=JaxPrivacyConfig(**privacy),
                  **dict(FTRL, **cfg)))


@pytest.fixture(scope="module")
def ftrl_rounds():
    """Two dp_ftrl rounds of each package, every client in each (cohort
    4 of 4, k = 2)."""
    jarr, tarr = _arrays()
    jeng = _jax_engine(jarr)
    teng = _port_engine(tarr)
    teng.global_variables = {"params": params_from_flax(
        jax.device_get(jeng.global_variables["params"]))}
    jr = [jeng.run_round(evaluate=False) for _ in range(2)]
    tr = [teng.run_round(evaluate=False) for _ in range(2)]
    return dict(jeng=jeng, teng=teng, jr=jr, tr=tr)


def _assert_mostly_equal(got, want, bound):
    gaps = np.abs(got - want)
    assert np.mean(gaps <= 1e-5) >= 0.999, np.sort(gaps)[-20:]
    assert gaps.max() <= bound, gaps.max()


def test_dp_ftrl_rounds_match_jax(ftrl_rounds):
    r = ftrl_rounds
    jeng, teng = r["jeng"], r["teng"]
    for a, b, tol in zip(r["tr"], r["jr"], (1e-5, 1e-4)):
        assert a.participating_clients == b.participating_clients == C
        np.testing.assert_allclose(a.train_loss, b.train_loss, rtol=tol)
    jp = jax.device_get(jeng.global_variables["params"])
    tp = params_to_flax(teng.global_variables["params"])
    _assert_mostly_equal(
        np.concatenate([tp[l][k].ravel() for l in jp for k in jp[l]]),
        np.concatenate([np.asarray(jp[l][k]).ravel()
                        for l in jp for k in jp[l]]), 2e-3)
    _assert_mostly_equal(teng.ftrl_cumsum.numpy(),
                         np.asarray(jeng.ftrl_cumsum), 4e-3)
    np.testing.assert_array_equal(teng.ftrl_participations,
                                  jeng.ftrl_participations)
    assert teng._ftrl_sigma_node == jeng._ftrl_sigma_node
    assert teng._ftrl_height == jeng._ftrl_height == 3


def test_dp_ftrl_charges_epsilon_once_as_the_reference(ftrl_rounds):
    r = ftrl_rounds
    assert [x.epsilon_spent for x in r["tr"]] == [
        x.epsilon_spent for x in r["jr"]]
    assert r["tr"][0].epsilon_spent == r["teng"]._ftrl_eps_total > 0
    assert r["tr"][1].epsilon_spent == 0.0
    assert (r["teng"].budget_tracker.consumed_epsilon
            == r["jeng"].budget_tracker.consumed_epsilon)
    jl = r["jeng"].accountant.get_privacy_ledger()
    tl = r["teng"].accountant.get_privacy_ledger()
    assert len(tl) == len(jl) == 1
    for key in ("mechanism_type", "epsilon", "delta", "sensitivity",
                "noise_scale", "metadata"):
        assert tl[0][key] == jl[0][key], key


def test_dp_ftrl_rotation_equals_the_reference():
    """Cohorts of 2 out of 4 rotate as in the reference: masks by round
    and, once every client has used its k = 1, the participation refusal
    with its message; past T_max the tree refusal."""
    jarr, tarr = _arrays()
    kw = dict(ftrl_cohort_size=2, ftrl_max_participations=1)
    jeng, teng = _jax_engine(jarr, **kw), _port_engine(tarr, **kw)
    for r in range(3):
        jeng.round_number = teng.round_number = r
        np.testing.assert_array_equal(teng.sample_participation(),
                                      jeng.sample_participation())
    for eng in (jeng, teng):
        eng.round_number = 1
        eng.ftrl_participations = np.array([1, 1, 0, 0], np.int64)
    with pytest.raises(jdp.PrivacyError) as want:
        jeng._dispatch_round(np.ones(C, np.float32))
    with pytest.raises(tdp.PrivacyError) as got:
        teng._dispatch_round(np.ones(C, np.float32))
    assert "participation budget" in str(got.value)
    assert str(got.value) == str(want.value)
    for eng in (jeng, teng):
        eng.round_number = 4
    with pytest.raises(jdp.PrivacyError) as want:
        jeng._dispatch_round(np.zeros(C, np.float32))
    with pytest.raises(tdp.PrivacyError) as got:
        teng._dispatch_round(np.zeros(C, np.float32))
    assert "tree exhausted" in str(got.value)
    assert str(got.value) == str(want.value)


RULE_CASES = {
    "no-ftrl_rounds": {"dp_mode": "dp_ftrl"},
    "ftrl_rounds-0": {"dp_mode": "dp_ftrl", "ftrl_rounds": 0},
    "dp_ftrl-x-server-optimizer": {"dp_mode": "dp_ftrl", "ftrl_rounds": 4,
                                   "server_optimizer": "fedadam"},
    "dp_ftrl-x-secure": {"dp_mode": "dp_ftrl", "ftrl_rounds": 4,
                         "secure_aggregation": True},
    "dp_ftrl-x-downlink": {"dp_mode": "dp_ftrl", "ftrl_rounds": 4,
                           "downlink_compression": "int8"},
    "dp_ftrl-x-pld": {"dp_mode": "dp_ftrl", "ftrl_rounds": 4,
                      "accountant": "pld"},
    "dp_ftrl-x-robust": {"dp_mode": "dp_ftrl", "ftrl_rounds": 4,
                         "aggregation": "median"},
    "dp_ftrl-x-uplink": {"dp_mode": "dp_ftrl", "ftrl_rounds": 4,
                         "uplink_compression": "topk"},
}


@pytest.mark.parametrize("kwargs", list(RULE_CASES.values()),
                         ids=list(RULE_CASES))
def test_dp_ftrl_rules_raise_the_reference_messages(kwargs):
    with pytest.raises(ValueError) as want:
        validate_config(JaxConfig(**kwargs), C)
    with pytest.raises(ValueError) as got:
        RoundEngineConfig(**kwargs)
    assert str(got.value) == str(want.value)


def test_dp_ftrl_refusals_at_build_and_in_the_fused_runner():
    """z too small for the budget: PrivacyError at build; the fused
    runner refuses dp_ftrl; both with the reference's messages."""
    jarr, tarr = _arrays()
    weak = dict(PRIV, epsilon=0.1, noise_multiplier=1.0)
    with pytest.raises(jdp.PrivacyError) as want:
        _jax_engine(jarr, privacy=weak)
    with pytest.raises(tdp.PrivacyError) as got:
        _port_engine(tarr, privacy=weak)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        _jax_engine(jarr).run_rounds_fused(2)
    with pytest.raises(ValueError) as got:
        _port_engine(tarr).run_rounds_fused(2)
    assert str(got.value) == str(want.value)


def test_fresh_engines_draw_fresh_trees():
    """ftrl_tree_nonce=None draws OS entropy an engine: two engines, two
    trees (and two node-noise seeds)."""
    a, b = (_port_engine(ftrl_tree_nonce=None) for _ in range(2))
    assert a._ftrl_nonce != b._ftrl_nonce
    assert a._ftrl_tree_seed != b._ftrl_tree_seed


def test_dp_ftrl_resume_is_bit_for_bit(tmp_path):
    """Save after round 1 of a run at z = 0.5 with a drawn nonce; a fresh
    engine (another nonce) restored from it runs rounds 2 and 3 to the same
    bits as the uninterrupted one: params, prefix sums, momentum, ledger,
    nonce and ε."""
    priv = dict(PRIV, noise_multiplier=0.5,
                epsilon=tftrl.gaussian_epsilon(0.5, 1e-5) + 1.0)
    kw = dict(privacy=priv, ftrl_tree_nonce=None, ftrl_cohort_size=2,
              ftrl_max_participations=2)
    a = _port_engine(**kw)
    a.run_round(evaluate=False)
    save_engine_checkpoint(a, str(tmp_path))
    a.run_rounds_pipelined(2)
    b = _port_engine(**kw)
    assert b._ftrl_nonce != a._ftrl_nonce
    assert restore_engine_checkpoint(b, str(tmp_path)) == 1
    assert b._ftrl_nonce == a._ftrl_nonce
    b.run_rounds_pipelined(2)
    for l in a.global_variables["params"]:
        for k in a.global_variables["params"][l]:
            assert torch.equal(a.global_variables["params"][l][k],
                               b.global_variables["params"][l][k]), (l, k)
    for name in ("ftrl_cumsum", "ftrl_prev_noisy", "ftrl_momentum_buf"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    np.testing.assert_array_equal(a.ftrl_participations,
                                  b.ftrl_participations)
    assert a.ftrl_participations.tolist() == [2, 2, 1, 1]
    assert (b.budget_tracker.consumed_epsilon
            == a.budget_tracker.consumed_epsilon
            == a._ftrl_eps_total)
