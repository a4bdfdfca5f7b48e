"""Distributed DP (``dp_mode="distributed"``, ``fl_tpu_torch.fl.
distributed_dp``) of the port against fl_tpu.

- The host side is a numpy copy: the plan, the Skellam RDP bound, the
  exact Rényi divergence, ε and the calibration equal the reference's to
  1e-12 relative (they are the same code), the wire payloads bit for bit
  for the same numpy generator, the wraparound refusal its message.
- The device side by its properties: stochastic rounding unbiased (within
  4 standard errors) with errors below one grid step and exact zeros kept;
  the Skellam draws by mean and variance, also at rates above 2^24 (the
  bench's aggregate rate) and by closure (one aggregate draw against the
  sum of shares); the modular sum equal to the int64 sum mod 2^32 read as
  int32 where the true sum leaves the int32 range; pairwise masks that
  cancel bit for bit and spread the payloads over the ring.
- One engine round of each noise form against the JAX engine's round
  (local SGD, whose f32 deltas agree far below the grid step γ; dropout 0,
  ``samples_per_client == batch_size``): the decoded averages may differ
  by one grid step a client (the two packages' rounding draws) and by the
  two packages' Skellam noise, so every parameter is held within γ·(m +
  8·√(2·μ_local·m))/m̄; the ε charged and the ledger equal.
- The Skellam-RDP gate at the realized count and the fused runner's
  budget refusal raise the reference's messages; ``run_rounds_fused``
  equals a ``run_round`` loop bit for bit; a resumed engine continues bit
  for bit with its accountant.
"""

import functools
import math

import jax
import numpy as np
import pytest
import torch

from fl_tpu.core.types import PrivacyConfig as JaxPrivacyConfig
from fl_tpu.data import load_dataset as jax_load_dataset
from fl_tpu.data import make_federated_arrays as jax_make_arrays
from fl_tpu.fl import distributed_dp as jddp
from fl_tpu.fl import privacy as jdp
from fl_tpu.fl.local_training import \
    FederatedTrainingConfig as JaxTrainingConfig
from fl_tpu.models import create_model as jax_create_model
from fl_tpu.orchestration import FederatedRoundEngine as JaxEngine
from fl_tpu.orchestration import RoundEngineConfig as JaxConfig
from fl_tpu.orchestration.features import validate_config
from fl_tpu_torch.core.types import PrivacyConfig
from fl_tpu_torch.data import load_dataset, make_federated_arrays
from fl_tpu_torch.fl import distributed_dp as tddp
from fl_tpu_torch.fl import privacy as tdp
from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
from fl_tpu_torch.models import create_model, params_from_flax, params_to_flax
from fl_tpu_torch.orchestration import FederatedRoundEngine, RoundEngineConfig
from fl_tpu_torch.orchestration.checkpoint import (
    restore_engine_checkpoint,
    save_engine_checkpoint,
)

C = 4
SIMPLE_CNN_D = 421_642


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_equal(a, b, tol=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.all(np.abs(a - b) <= tol * np.maximum(np.abs(b), 1e-300)), (
        a, b)


# ---------------------------------------------------------------------------
# the host side: equal values
# ---------------------------------------------------------------------------

PLANS = [(1.0, 14, SIMPLE_CNN_D, 51, 1.0), (1.0, 14, SIMPLE_CNN_D, 512, 0.7),
         (0.5, 10, 1000, 8, 2.0), (2.0, 20, 100_000, 4, 1e-4)]


@pytest.mark.parametrize("args", PLANS, ids=str)
def test_plan_values_equal_the_reference(args):
    t, j = tddp.DistributedDPPlan(*args), jddp.DistributedDPPlan(*args)
    for name in ("gamma", "delta2", "delta1", "mu_central", "mu_local"):
        _rel_equal(getattr(t, name), getattr(j, name))
    for m in (0, 1, args[3], 3 * args[3]):
        _rel_equal(t.central_sigma_float(m), j.central_sigma_float(m))
        _rel_equal(t.round_rdp(m), j.round_rdp(m))
    for rounds in (1, 10):
        _rel_equal(tddp.distributed_epsilon(t, rounds, 1e-5),
                   jddp.distributed_epsilon(j, rounds, 1e-5))
    _rel_equal(tddp.distributed_epsilon(t, 3, 1e-5, realized=2),
               jddp.distributed_epsilon(j, 3, 1e-5, realized=2))


def test_skellam_rdp_and_exact_divergence_equal_the_reference():
    for mu, d2, d1 in [(4.0, 1.0, 1.0), (25.0, 3.0, 5.0), (1e8, 100.0,
                                                          1000.0)]:
        _rel_equal(tddp.skellam_rdp(mu, d2, d1),
                   jddp.skellam_rdp(mu, d2, d1))
    assert np.all(np.isinf(tddp.skellam_rdp(0.0, 1.0, 1.0)))
    for mu, shift, alpha in [(4.0, 2, 2), (25.0, 3, 8), (100.0, 10, 64)]:
        exact = tddp.skellam_renyi_divergence_exact(mu, shift, alpha)
        _rel_equal(exact, jddp.skellam_renyi_divergence_exact(
            mu, shift, alpha))
        # the bound the accountant charges dominates it
        assert float(tddp.skellam_rdp(mu, shift, shift,
                                      [alpha])[0]) >= exact - 1e-12
    k = np.arange(-40, 41)
    _rel_equal(tddp._skellam_log_pmf(k, 50.0),
               jddp._skellam_log_pmf(k, 50.0))


def test_calibration_equals_the_reference():
    args = dict(target_epsilon=2.0, delta=1e-5, rounds=5, clip_norm=1.0,
                bits=14, dim=SIMPLE_CNN_D, expected_clients=512)
    z = tddp.calibrate_noise_multiplier(**args)
    assert z == jddp.calibrate_noise_multiplier(**args)
    plan = tddp.DistributedDPPlan(1.0, 14, SIMPLE_CNN_D, 512, z)
    assert tddp.distributed_epsilon(plan, 5, 1e-5) <= 2.0 + 1e-6
    with pytest.raises(ValueError) as want:
        jddp.calibrate_noise_multiplier(**dict(args, target_epsilon=1e-9))
    with pytest.raises(ValueError) as got:
        tddp.calibrate_noise_multiplier(**dict(args, target_epsilon=1e-9))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("args,n", [((1.0, 20, 100_000, 4096, 1.0), 4096),
                                    ((1.0, 14, 1000, 8, 2e4), 8)], ids=str)
def test_wraparound_refusal_raises_the_reference_message(args, n):
    with pytest.raises(ValueError) as want:
        jddp.check_no_wraparound(jddp.DistributedDPPlan(*args), n)
    with pytest.raises(ValueError) as got:
        tddp.check_no_wraparound(tddp.DistributedDPPlan(*args), n)
    assert "overflow" in str(got.value)
    assert str(got.value) == str(want.value)
    tddp.check_no_wraparound(tddp.DistributedDPPlan(1.0, 14, 100_000, 512,
                                                    1.0), 512)


def test_zero_participants_cost_zero_epsilon():
    plan = tddp.DistributedDPPlan(1.0, 14, 1000, 8, 1.0)
    assert np.all(plan.round_rdp(0) == 0.0)
    assert np.all(plan.round_rdp(4) > plan.round_rdp(8))


def test_host_payloads_equal_the_reference():
    """The wire client's payload and the server's decode, bit for bit, for
    the same numpy generator; the decode recovers the clipped mean within
    γ·(2 + 5·√μ_central)/m̄: a grid step a client and 5 σ of the noise."""
    rng = np.random.default_rng(3)
    weights = [{"conv/kernel": rng.normal(0, s, (3, 3, 1, 4)),
                "fc/bias": rng.normal(0, s, (10,))} for s in (0.01, 5.0)]
    plan = tddp.DistributedDPPlan(1.0, 14, 46, 2, 1e-3)
    jplan = jddp.DistributedDPPlan(1.0, 14, 46, 2, 1e-3)
    got = [tddp.host_client_integer_payload(w, plan,
                                            np.random.default_rng(i))
           for i, w in enumerate(weights)]
    want = [jddp.host_client_integer_payload(w, jplan,
                                             np.random.default_rng(i))
            for i, w in enumerate(weights)]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == np.uint32
            np.testing.assert_array_equal(g[k], w[k])
    summed = {k: (got[0][k].astype(np.uint64) + got[1][k]).astype(
        np.uint32) for k in got[0]}
    dec = tddp.host_decode_average(summed, plan)
    ref = jddp.host_decode_average(summed, jplan)
    for k in dec:
        np.testing.assert_array_equal(dec[k], ref[k])
    flat = np.concatenate([weights[1][k].ravel() for k in sorted(weights[1])])
    clipped = flat / max(1.0, np.linalg.norm(flat))
    small = np.concatenate([weights[0][k].ravel()
                            for k in sorted(weights[0])])
    mean = (clipped + small) / 2
    np.testing.assert_allclose(
        np.concatenate([dec[k].ravel() for k in sorted(dec)]), mean,
        atol=plan.gamma * (2 + 5 * math.sqrt(plan.mu_central)) / 2)


# ---------------------------------------------------------------------------
# the device side
# ---------------------------------------------------------------------------

def test_stochastic_round_unbiased_and_bounded():
    gamma = 0.25
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (1, 64)).astype(np.float32))
    out = tddp.stochastic_round(x.repeat(4096, 1), gamma, 5)
    assert out.dtype == torch.int32
    out = out.double()
    err = (out.mean(0) - x[0].double() / gamma).abs()
    assert float(err.max()) < 4.0 / math.sqrt(4096) + 1e-3
    assert float((out - x.double() / gamma).abs().max()) < 1.0
    z = tddp.stochastic_round(torch.zeros((8, 32)), gamma, 6)
    assert z.dtype == torch.int32 and bool((z == 0).all())
    assert not torch.equal(tddp.stochastic_round(x.repeat(64, 1), gamma, 5),
                           tddp.stochastic_round(x.repeat(64, 1), gamma, 7))


@pytest.mark.parametrize("lam", [8.0, 2.85e6, 1.5e8], ids=str)
def test_skellam_noise_moments(lam):
    """Sk(2·lam): mean 0 and variance 2·lam (5 standard errors each; the
    variance's relative error has sd √(2/n)), at a small rate, the bench's
    per-client rate and its aggregate rate (above 2^24: float64 counts)."""
    n = 65536
    noise = tddp.skellam_noise(11, lam, (n,)).double()
    sd = math.sqrt(2 * lam)
    assert abs(float(noise.mean())) < 5 * sd / math.sqrt(n)
    assert abs(float(noise.var()) / (2 * lam) - 1) < 5 * math.sqrt(2 / n)
    agg = tddp.aggregate_skellam_noise(12, torch.tensor(lam), n).double()
    assert abs(float(agg.mean())) < 5 * sd / math.sqrt(n)
    assert abs(float(agg.var()) / (2 * lam) - 1) < 5 * math.sqrt(2 / n)


def test_aggregate_noise_matches_summed_shares():
    """Closure: one Sk(2·m·λ) draw has the moments of m summed shares."""
    lam, m, n = 8.0, 16, 200_000
    fused = tddp.aggregate_skellam_noise(3, m * lam, n).double()
    summed = tddp.skellam_noise(4, lam, (m, n)).double().sum(0)
    for s in (fused, summed):
        assert abs(float(s.mean())) < 0.5
        assert float(s.var()) == pytest.approx(2 * m * lam, rel=0.02)


def test_modular_sum_is_int32_wraparound():
    """torch.sum of int32 gives int64; the modular sum is that reduced mod
    2^32 as two's-complement int32, the int32 sum that wraps."""
    rng = np.random.default_rng(5)
    ints = rng.integers(-2 ** 31, 2 ** 31, (64, 1000), dtype=np.int64)
    ints[:, :10] = 2 ** 31 - 1   # far outside the int32 range summed
    got = tddp.modular_sum(torch.from_numpy(ints.astype(np.int32)))
    assert got.dtype == torch.int32
    want = ((ints.sum(0) + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (ints.astype(np.int32).sum(0, dtype=np.int32) == want).all()


def test_masked_payloads_cancel_and_hide():
    """Pairwise masks cancel bit for bit in the modular sum, also with
    clients out (a pair is masked only when both ends take part), and
    spread the masked payloads over the ring."""
    Cn, D = 8, 4096
    mat = torch.from_numpy(np.random.default_rng(1).normal(
        0, 0.1, (Cn, D)).astype(np.float32))
    gamma, mu_local = 1.0 / 2 ** 10, 64.0
    for alive in (np.ones(Cn), np.array([1, 0, 1, 1, 0, 1, 1, 1])):
        mask = torch.from_numpy(alive.astype(np.float32))
        plain = tddp.client_integer_payloads(mat, mask, 1, 2, gamma,
                                             mu_local)
        masked = tddp.masked_integer_payloads(mat, mask, 1, 2, 99, gamma,
                                              mu_local)
        assert torch.equal(plain[mask == 0], torch.zeros_like(
            plain[mask == 0]))
        assert torch.equal(tddp.modular_sum(masked[mask > 0]),
                           tddp.modular_sum(plain))
    u = masked.long() % 2 ** 32
    assert float(u.double().std()) > 0.2 * 2 ** 32
    assert int(plain.abs().max()) < 2 ** 14


# ---------------------------------------------------------------------------
# engine rounds against the JAX engine
# ---------------------------------------------------------------------------

Z = 1e-4
PRIV = dict(epsilon=1e12, delta=1e-5, max_grad_norm=1.0,
            noise_multiplier=Z)
TRAIN = dict(local_epochs=1, batch_size=16, learning_rate=0.1,
             optimizer_type="sgd", momentum=0.0)


@functools.lru_cache(maxsize=None)
def _arrays():
    kw = dict(num_clients=C, strategy="iid", samples_per_client=16, seed=0)
    return (jax_make_arrays(jax_load_dataset("mnist", n_train_synth=256,
                                             n_test_synth=64), **kw),
            make_federated_arrays(load_dataset("mnist", n_train_synth=256,
                                               n_test_synth=64), **kw))


def _port_engine(privacy=PRIV, **cfg):
    return FederatedRoundEngine(
        create_model("simple_cnn", dropout_rate=0.0), _arrays()[1],
        RoundEngineConfig(training=FederatedTrainingConfig(**TRAIN),
                          privacy=PrivacyConfig(**privacy),
                          **dict(dict(dp_mode="distributed", seed=0), **cfg)),
        device="cpu")


def _jax_engine(privacy=PRIV, **cfg):
    return JaxEngine(
        jax_create_model("simple_cnn", dropout_rate=0.0), _arrays()[0],
        JaxConfig(training=JaxTrainingConfig(**TRAIN),
                  privacy=JaxPrivacyConfig(**privacy),
                  **dict(dict(dp_mode="distributed", seed=0), **cfg)))


@pytest.fixture(scope="module")
def jax_round():
    jeng = _jax_engine()
    init = params_from_flax(jax.device_get(jeng.global_variables["params"]))
    jr = jeng.run_round(mask=np.ones(C, np.float32), evaluate=False)
    return jeng, init, jr


@pytest.mark.parametrize("fuse", [True, False])
def test_distributed_round_matches_jax_within_the_grid(jax_round, fuse):
    jeng, init, jr = jax_round
    teng = _port_engine(dist_fuse_noise=fuse)
    teng.global_variables = {"params": {l: {k: v.clone() for k, v in
                                            d.items()}
                                        for l, d in init.items()}}
    tr = teng.run_round(mask=np.ones(C, np.float32), evaluate=False)
    plan = teng._dist_plan
    assert vars(plan) == vars(jeng._dist_plan)
    m = C
    bound = plan.gamma * (m + 8 * math.sqrt(2 * plan.mu_local * m)) \
        / plan.expected_clients
    jp = jax.device_get(jeng.global_variables["params"])
    tp = params_to_flax(teng.global_variables["params"])
    moved = 0.0
    for l in jp:
        for k in jp[l]:
            gap = np.abs(tp[l][k] - np.asarray(jp[l][k]))
            assert gap.max() <= bound, (l, k, gap.max(), bound)
            moved = max(moved, float(np.abs(
                tp[l][k] - init[l][k].numpy()).max()))
    assert moved > 10 * bound   # the round did move the model
    np.testing.assert_allclose(tr.train_loss, jr.train_loss, rtol=1e-5)
    assert tr.epsilon_spent == jr.epsilon_spent
    jl = jeng.accountant.get_privacy_ledger()[-1]
    tl = teng.accountant.get_privacy_ledger()[-1]
    for key in ("mechanism_type", "epsilon", "delta", "sensitivity",
                "noise_scale", "metadata"):
        assert tl[key] == jl[key], key


def test_distributed_noise_on_the_engine_has_the_plan_scale():
    """Two port engines that differ only in z: their models differ by the
    decoded Skellam noise, whose std is γ·√(μ_local·m)/m̄ (the plan's
    central σ) within 5%."""
    loud_priv = dict(PRIV, noise_multiplier=0.5)
    loud, quiet = _port_engine(loud_priv), _port_engine()
    mask = np.array([1, 1, 0, 1], np.float32)
    loud.run_round(mask, evaluate=False)
    quiet.run_round(mask, evaluate=False)
    diff = np.concatenate([
        (loud.global_variables["params"][l][k]
         - quiet.global_variables["params"][l][k]).numpy().ravel()
        for l in loud.global_variables["params"]
        for k in loud.global_variables["params"][l]])
    sigma = loud._dist_plan.central_sigma_float(3)
    assert abs(diff.std() / sigma - 1) < 0.05
    assert loud.accountant.get_privacy_ledger()[0]["noise_scale"] == sigma


def test_skellam_gate_at_the_realized_count_raises_the_reference_message():
    """ε = 6 at z = 1: four participants fit (ε 5.30 after one round),
    one does not (11.76: less summed noise, a bigger charge); the refusal
    and the fused runner's R-round refusal carry the reference's
    messages."""
    priv = dict(PRIV, epsilon=6.0, noise_multiplier=1.0)
    jeng, teng = _jax_engine(priv), _port_engine(priv)
    one = np.array([0, 1, 0, 0], np.float32)
    with pytest.raises(jdp.PrivacyError) as want:
        jeng._dispatch_round(one)
    with pytest.raises(tdp.PrivacyError) as got:
        teng._dispatch_round(one)
    assert str(got.value) == str(want.value)
    teng._distributed_gate(np.ones(C, np.float32))
    masks = np.ones((40, C), np.float32)
    with pytest.raises(jdp.PrivacyError) as want:
        jeng.run_rounds_fused(40, masks=masks)
    with pytest.raises(tdp.PrivacyError) as got:
        teng.run_rounds_fused(40, masks=masks)
    assert str(got.value) == str(want.value)


def test_fused_rounds_equal_a_run_round_loop():
    masks = np.array([[1, 1, 1, 1], [1, 0, 1, 1]], np.float32)
    priv = dict(PRIV, epsilon=50.0, noise_multiplier=1.0)
    fused, looped = _port_engine(priv), _port_engine(priv)
    rf = fused.run_rounds_fused(2, masks=masks, evaluate=False)
    rl = [looped.run_round(mask=m, evaluate=False) for m in masks]
    assert [r.epsilon_spent for r in rf] == [r.epsilon_spent for r in rl]
    assert (fused.rdp_accountant.get_epsilon(1e-5)
            == looped.rdp_accountant.get_epsilon(1e-5))
    for l in fused.global_variables["params"]:
        for k in fused.global_variables["params"][l]:
            assert torch.equal(fused.global_variables["params"][l][k],
                               looped.global_variables["params"][l][k])


def test_distributed_resume_is_bit_for_bit(tmp_path):
    priv = dict(PRIV, epsilon=50.0, noise_multiplier=1.0)
    a = _port_engine(priv, participation_rate=0.5, dist_fuse_noise=False)
    a.run_round(evaluate=False)
    save_engine_checkpoint(a, str(tmp_path))
    a.run_round(evaluate=False)
    b = _port_engine(priv, participation_rate=0.5, dist_fuse_noise=False)
    assert restore_engine_checkpoint(b, str(tmp_path)) == 1
    b.run_round(evaluate=False)
    assert (b.rdp_accountant.get_epsilon(1e-5)
            == a.rdp_accountant.get_epsilon(1e-5))
    assert b.history[-1].participating_clients == \
        a.history[-1].participating_clients
    for l in a.global_variables["params"]:
        for k in a.global_variables["params"][l]:
            assert torch.equal(a.global_variables["params"][l][k],
                               b.global_variables["params"][l][k])


RULE_CASES = {
    "dist_bits-3": {"dp_mode": "distributed", "dist_bits": 3},
    "dist_bits-21": {"dp_mode": "distributed", "dist_bits": 21},
    "distributed-x-pld": {"dp_mode": "distributed", "accountant": "pld"},
    "distributed-x-robust": {"dp_mode": "distributed",
                             "aggregation": "krum"},
    "distributed-x-uplink": {"dp_mode": "distributed",
                             "uplink_compression": "int8"},
    "distributed-x-fednova": {"dp_mode": "distributed", "fednova": True},
}


@pytest.mark.parametrize("kwargs", list(RULE_CASES.values()),
                         ids=list(RULE_CASES))
def test_distributed_rules_raise_the_reference_messages(kwargs):
    with pytest.raises(ValueError) as want:
        validate_config(JaxConfig(**kwargs), C)
    with pytest.raises(ValueError) as got:
        RoundEngineConfig(**kwargs)
    assert str(got.value) == str(want.value)
