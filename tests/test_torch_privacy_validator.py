"""The port's DP host API (``ops.dp.clip_noise_matrix``, ``fl.privacy``'s
Gaussian-mechanism math, one-client release and facades) and its privacy,
security and performance validators, against the reference's
(``fl_tpu.ops.dp``, ``fl_tpu.fl.privacy``,
``fl_tpu.validation.privacy_validator``), on the CPU.

- ``clip_noise_matrix`` and ``clip_and_noise_tree`` at ε = 1e12 (σ about
  5e-12 of the clipped norm, so the noise is far below f32's resolution
  of the values): the released values within 1e-6 of the reference's
  (its jnp path), the sensitivities to 1e-6, σ to rtol 1e-6; ``d_valid``
  restricts the norm. At a real ε, σ is checked by distribution: each
  row's noise std over its 65,536 elements within 2% of σ (the standard
  error is 0.28%). ``clip_and_noise_tree_at_sigma`` returns the PRE-clip
  norm, ``clip_and_noise_tree`` the clipped one (as K3 takes σ).
  ``use_pallas=True`` on a CPU tensor raises, as ``use_pallas_dp`` does.
- The Gaussian-mechanism math, the parameter checks, the composition
  estimate, the parameter heuristic, the clipper and the privacy
  engine's analysis equal the reference's.
- The validators: the budget and the split-budget guarantee dicts equal
  the reference's; the noise test passes on the port's path at the
  reference's (4, 65,536) shape with the reference's keys; the security
  heuristics equal; ``ComprehensiveValidator.run_all`` passes with the
  reference's structure; the performance validator's baseline and load
  tests measure real rounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl_tpu.fl import privacy as jdp
from fl_tpu.ops.dp import clip_noise_matrix as jax_clip_noise_matrix
from fl_tpu.validation import privacy_validator as jpv
from fl_tpu_torch.fl import privacy as tdp
from fl_tpu_torch.ops import dp as dp_ops
from fl_tpu_torch.validation import (
    ComprehensiveValidator,
    PerformanceRequirements,
    PerformanceValidator,
    PrivacyValidator,
    SecurityValidator,
)

TINY_EPS = 1e12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _matrix(C=4, D=3000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(C, D)).astype(np.float32)
    x *= np.asarray([0.001, 0.05, 1.0, 3.0], np.float32)[:C, None] \
        / np.sqrt(D)
    return x


# ---------------------------------------------------------------------------
# clip_noise_matrix and the one-client release
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d_valid", [None, 2500])
def test_clip_noise_matrix_at_a_tiny_noise_equals_the_reference(d_valid):
    x = _matrix()
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    want, wsens, wsig = jax_clip_noise_matrix(
        jnp.asarray(x), keys, TINY_EPS, 1e-5, 0.5, d_valid=d_valid,
        use_pallas=False)
    got, sens, sig = dp_ops.clip_noise_matrix(
        torch.from_numpy(x), [1, 2, 3, 4], TINY_EPS, 1e-5, 0.5,
        d_valid=d_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(sens.numpy(), np.asarray(wsens), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(sig.numpy(), np.asarray(wsig), rtol=1e-6)
    # rows above the clip norm were clipped to it, the others kept
    assert (sens.numpy() <= 0.5 + 1e-6).all()
    assert np.asarray(wsens)[0] < 0.5 < np.linalg.norm(x[3])


def test_clip_noise_matrix_noise_by_distribution():
    x = torch.from_numpy(_matrix(D=65_536))
    seeds = np.asarray([11, 12, 13, 14], np.uint64)
    noisy, sens, sig = dp_ops.clip_noise_matrix(x, seeds, 2.0, 1e-5, 0.5)
    scale = torch.clamp(0.5 / x.norm(dim=1), max=1.0)
    resid = noisy - x * scale[:, None]
    ratio = resid.std(1) / sig
    assert torch.all((ratio - 1).abs() < 0.02), ratio
    assert torch.all(resid.mean(1).abs() < 5 * sig / 256.0)
    assert sig.numpy() == pytest.approx(
        sens.numpy() * tdp.gaussian_sigma(1.0, 2.0, 1e-5), rel=1e-6)
    # the plain version asked for by name draws the same stream on the CPU
    again, _, _ = dp_ops.clip_noise_matrix(x, seeds, 2.0, 1e-5, 0.5,
                                           use_pallas=False)
    assert torch.equal(again, noisy)


def test_clip_noise_matrix_use_pallas_on_the_cpu_raises():
    x = torch.from_numpy(_matrix())
    with pytest.raises(ValueError, match="CUDA"):
        dp_ops.clip_noise_matrix(x, [1, 2, 3, 4], 1.0, 1e-5, 1.0,
                                 use_pallas=True)


def _tree(seed=1, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"conv": {"kernel": (rng.normal(size=(3, 3, 1, 8)) * scale
                                ).astype(np.float32),
                     "bias": (rng.normal(size=(8,)) * scale
                              ).astype(np.float32)},
            "fc": {"kernel": (rng.normal(size=(40, 10)) * scale
                              ).astype(np.float32)}}


def _torch_tree(tree):
    return {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()})
            for k, v in tree.items()}


@pytest.mark.parametrize("scale", [0.01, 1.0])
def test_clip_and_noise_tree_at_a_tiny_noise_equals_the_reference(scale):
    tree = _tree(scale=scale)
    want, wsens, wsig = jdp.clip_and_noise_tree(
        jax.tree.map(jnp.asarray, tree), jax.random.PRNGKey(3), TINY_EPS,
        1e-5, 1.0)
    got, sens, sig = tdp.clip_and_noise_tree(_torch_tree(tree), 3,
                                             TINY_EPS, 1e-5, 1.0)
    for k in tree:
        for kk in tree[k]:
            np.testing.assert_allclose(got[k][kk].numpy(),
                                       np.asarray(want[k][kk]), rtol=0,
                                       atol=1e-6, err_msg=f"{k}/{kk}")
    assert float(sens) == pytest.approx(float(wsens), rel=1e-6, abs=1e-6)
    assert float(sig) == pytest.approx(float(wsig), rel=1e-6)


def test_clip_and_noise_tree_sigma_from_the_clipped_norm():
    tree = _torch_tree({"w": {"a": np.full((256, 256), 0.01, np.float32)}})
    noisy, sens, sig = tdp.clip_and_noise_tree(tree, 5, 2.0, 1e-5, 1.0)
    assert float(sens) == pytest.approx(1.0)  # ‖·‖ = 2.56, clipped to 1
    assert float(sig) == pytest.approx(tdp.gaussian_sigma(1.0, 2.0, 1e-5),
                                       rel=1e-6)
    resid = noisy["w"]["a"] - tree["w"]["a"] / 2.56
    assert float(resid.std() / sig) == pytest.approx(1.0, abs=0.02)


def test_clip_and_noise_tree_at_sigma_returns_the_pre_clip_norm():
    tree = _tree(scale=1.0)
    want, wnorm = jdp.clip_and_noise_tree_at_sigma(
        jax.tree.map(jnp.asarray, tree), jax.random.PRNGKey(4), 1.0, 0.0)
    got, norm = tdp.clip_and_noise_tree_at_sigma(_torch_tree(tree), 4, 1.0,
                                                 0.0)
    assert float(norm) == pytest.approx(float(wnorm), rel=1e-6)
    assert float(norm) > 1.0
    for k in tree:
        for kk in tree[k]:
            np.testing.assert_allclose(got[k][kk].numpy(),
                                       np.asarray(want[k][kk]), rtol=1e-6,
                                       atol=1e-7)
    noisy, _ = tdp.clip_and_noise_tree_at_sigma(
        {"w": torch.zeros(65_536)}, 4, 1.0, 0.3)
    assert float(noisy["w"].std()) == pytest.approx(0.3, rel=0.02)


# ---------------------------------------------------------------------------
# the host math and facades
# ---------------------------------------------------------------------------

def test_host_math_equals_the_reference():
    for eps, delta in ((0.5, 1e-5), (1.0, 1e-6), (8.0, 1e-3)):
        assert tdp.gaussian_sigma(2.0, eps, delta) == \
            jdp.gaussian_sigma(2.0, eps, delta)
        for steps in (1, 10, 100):
            assert tdp.advanced_composition_epsilon(eps, delta, steps) == \
                jdp.advanced_composition_epsilon(eps, delta, steps)
    for eps, delta in ((1.0, 1e-5), (0.0, 1e-5), (20.0, 1e-5), (1.0, 0.0),
                       (1.0, 1.0), (1.0, 0.01)):
        assert tdp.validate_privacy_parameters(eps, delta) == \
            jdp.validate_privacy_parameters(eps, delta)
    for acc in (0.8, 0.9, 0.96):
        for n in (1000, 10_000):
            assert tdp.estimate_privacy_parameters(acc, n, 25) == \
                jdp.estimate_privacy_parameters(acc, n, 25)


def test_gradient_clipper_equals_the_reference():
    tree = _tree(scale=1.0)
    flat = {"a": tree["conv"]["kernel"], "b": tree["fc"]["kernel"]}
    got, gnorm = tdp.GradientClipper(1.5, "cpu").clip_gradients(flat)
    want, wnorm = jdp.GradientClipper(1.5).clip_gradients(flat)
    assert gnorm == pytest.approx(wnorm, rel=1e-6)
    for k in flat:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
    batch = [flat, {"a": flat["a"] * 3}]
    assert tdp.GradientClipper(1.0, "cpu").estimate_sensitivity(batch) == \
        pytest.approx(jdp.GradientClipper(1.0).estimate_sensitivity(batch),
                      rel=1e-6)


def test_privacy_engine_equals_the_reference():
    port, ref = tdp.create_privacy_engine(2.0, 1e-5, device="cpu"), \
        jdp.create_privacy_engine(2.0, 1e-5)
    grads = {"w": np.full((4096,), 0.05, np.float32)}
    for eng in (port, ref):
        eng.add_noise(grads, 0.5, 1e-6)
    want = ref.get_privacy_analysis()
    got = port.get_privacy_analysis()
    for d in (want, got):
        d["budget_status"].pop("tracking_duration")
    assert got == want
    # the release: clipped to C = 1, noised at the clipped norm's σ
    noisy = port.add_noise(grads, 0.5, 1e-6)
    sigma = tdp.gaussian_sigma(1.0, 0.5, 1e-6)
    resid = noisy["w"] - 0.05 / np.sqrt(4096 * 0.05 ** 2)
    assert float(resid.std()) == pytest.approx(sigma, rel=0.05)
    for _ in range(2):  # ε 1.5 and 2.0 of 2.0 spent
        port.add_noise(grads, 0.5, 1e-6)
    with pytest.raises(tdp.PrivacyError, match="exhausted"):
        port.add_noise(grads, 0.5, 1e-6)
    with pytest.raises(tdp.PrivacyError, match="Invalid"):
        port.add_noise(grads, 0.0, 1e-6)


def test_privacy_facades_put_arrays_on_the_card_by_default():
    """Array gradients go to the card unless the caller names a device;
    tensors are released where they lie."""
    grads = {"w": np.full((64,), 0.05, np.float32)}
    on_cpu = {"w": torch.from_numpy(grads["w"])}
    eng = tdp.create_privacy_engine(2.0, 1e-5)
    noisy = eng.add_noise(on_cpu, 0.5, 1e-6)
    assert noisy["w"].device.type == "cpu"
    clipped, _ = tdp.GradientClipper(1.0).clip_gradients(on_cpu)
    assert clipped["w"].device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    for call in (lambda: eng.add_noise(grads, 0.5, 1e-6),
                 lambda: tdp.GradientClipper(1.0).clip_gradients(grads),
                 lambda: tdp.GaussianNoiseGenerator(0).add_noise_to_gradients(
                     grads, 1.0, 1.0, 1e-5)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


# ---------------------------------------------------------------------------
# the validators
# ---------------------------------------------------------------------------

def test_budget_and_guarantee_dicts_equal_the_reference():
    port, ref = PrivacyValidator(device="cpu"), jpv.PrivacyValidator()
    assert port.validate_privacy_budget_tracking() == \
        ref.validate_privacy_budget_tracking()
    for splits in (3, 5):
        got = port.test_privacy_guarantees(splits=splits)
        assert got == ref.test_privacy_guarantees(splits=splits)
        assert got["passed"] and got["overdraw_refused"]


def test_noise_validation_passes_with_the_reference_keys():
    got = PrivacyValidator(device="cpu").validate_differential_privacy(
        dim=65_536, trials=4)
    want = jpv.PrivacyValidator().validate_differential_privacy(
        dim=8192, trials=2, use_pallas=False)
    assert got["passed"], got
    assert set(got) == set(want)
    assert 0.95 < got["observed_ratio_min"] <= got["observed_ratio_max"] \
        < 1.05
    assert got["expected_sigma_factor"] == want["expected_sigma_factor"]


def test_security_validator_equals_the_reference():
    port, ref = SecurityValidator(), jpv.SecurityValidator()
    rng = np.random.default_rng(0)
    sample = rng.normal(size=(16, 16)).astype(np.float32)
    clean = {"w": rng.normal(size=(1024,)).astype(np.float32)}
    leaky = {"w": np.concatenate([sample.reshape(-1),
                                  np.zeros(768, np.float32)])}
    for weights in (clean, leaky, {"w": torch.from_numpy(leaky["w"])}):
        assert port.check_data_leakage(weights, sample) == \
            ref.check_data_leakage({k: np.asarray(v) for k, v in
                                    weights.items()}, sample)
    assert not port.check_data_leakage(leaky, sample)["passed"]
    for eps in (0.1, 1.0, 5.0):
        assert port.estimate_membership_inference_risk(eps, 1e-5) == \
            ref.estimate_membership_inference_risk(eps, 1e-5)
        assert port.estimate_model_inversion_risk(eps, 421_642, 60_000) == \
            ref.estimate_model_inversion_risk(eps, 421_642, 60_000)


def test_comprehensive_validator_passes_with_the_reference_structure():
    got = ComprehensiveValidator(device="cpu").run_all()
    want = jpv.ComprehensiveValidator().run_all(use_pallas=False)
    assert got["all_passed"] and want["all_passed"]
    assert set(got) == set(want)
    for k in ("budget", "guarantees", "inversion", "membership"):
        assert got[k] == want[k], k
    assert set(got["noise"]) == set(want["noise"])


def test_validators_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PrivacyValidator().validate_differential_privacy(dim=1024)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PrivacyValidator().test_privacy_guarantees()


def test_performance_validator_measures_real_rounds():
    """tests/test_parallel_and_validators.py's baseline claim on the port,
    and the load test on the same engine."""
    v = PerformanceValidator(samples_per_client=16, local_epochs=1,
                             batch_size=8, device="cpu",
                             requirements=PerformanceRequirements(
                                 max_latency_ms=60_000,
                                 min_throughput_rps=0.0))
    base = v.run_baseline_test(num_clients=2)
    assert base["passed"] and base["rounds_per_sec"] > 0
    assert set(base) == {"test", "num_clients", "passed",
                         "round_latency_ms", "rounds_per_sec",
                         "client_updates_per_sec"}
    load = v.run_load_test(num_clients=2, rounds=2)
    assert load["passed"]
    assert 0 < load["latency_p50_ms"] <= load["latency_p95_ms"]
    assert v._engines[2].round_number == 1 + 5 + 1 + 2
