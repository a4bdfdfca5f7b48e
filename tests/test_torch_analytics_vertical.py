"""The port's federated analytics (``fl_tpu_torch.fl.analytics``) and
vertical FL engine (``fl_tpu_torch.fl.vertical``) against the reference's
``fl_tpu.fl.analytics`` and ``fl_tpu.fl.vertical``, on the CPU.

- ``dp_histogram`` at ``noise_scale=1e-4`` (the Skellam draws at μ = 1e-8
  are zeros in both packages): the counts equal the reference's exactly,
  ε and σ within 1e-12; at a calibrated ε the same μ (σ within 1e-12);
  at a real σ the noise by distribution (mean and variance over 16,384
  buckets, five standard errors). The read-outs (heavy hitters,
  quantiles) give the reference's answers on the same result, and
  ``RandomizedResponse`` on the same inputs and numpy generator. The
  reference's own claims (the population estimate, the cap, the
  messages) hold on the port.
- ``VerticalFLEngine``, the reference's weights carried across, no cut
  noise, one batch of the whole set (the draws out of the comparison):
  the towers within rtol 1e-5 / atol 1e-6 after two epochs, the epoch
  losses, accuracies and the evaluation within 1e-6, the byte counters
  exact; and the reference's learning, cut-noise and validation claims on
  the port.
"""

import math

import jax
import numpy as np
import pytest
import torch

from fl_tpu.fl import analytics as jfa
from fl_tpu.fl import vertical as jv
from fl_tpu_torch.fl import analytics as fa
from fl_tpu_torch.fl import vertical as tv


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _population(n_clients=400, domain=64, seed=0):
    """tests/test_analytics.py's Zipf-ish population."""
    rng = np.random.default_rng(seed)
    w = 1.0 / (np.arange(domain) + 1.0)
    p = w / w.sum()
    return [rng.choice(domain, size=rng.integers(1, 6), p=p)
            for _ in range(n_clients)], p


def _hist(mod, *args, **kw):
    if mod is fa:
        kw["device"] = "cpu"
    return mod.dp_histogram(*args, **kw)


# ---------------------------------------------------------------------------
# analytics
# ---------------------------------------------------------------------------

def test_dp_histogram_at_a_tiny_noise_scale_equals_the_reference():
    items, _ = _population()
    want = _hist(jfa, items, 64, noise_scale=1e-4, max_items_per_client=5,
                 seed=1)
    got = _hist(fa, items, 64, noise_scale=1e-4, max_items_per_client=5,
                seed=1)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.counts.dtype == np.float64
    assert got.epsilon == pytest.approx(want.epsilon, rel=1e-12)
    assert got.sigma == pytest.approx(want.sigma, rel=1e-12)
    assert (got.delta, got.participants) == (want.delta, want.participants)
    # the tiny noise drew zeros: the counts are the capped true counts
    assert got.counts.sum() == sum(min(len(x), 5) for x in items)


def test_dp_histogram_calibration_equals_the_reference():
    items, _ = _population(n_clients=100)
    for eps in (1.0, 4.0, 8.0):
        want = _hist(jfa, items, 64, epsilon=eps, max_items_per_client=3,
                     seed=2)
        got = _hist(fa, items, 64, epsilon=eps, max_items_per_client=3,
                    seed=2)
        assert got.sigma == pytest.approx(want.sigma, rel=1e-12)
        assert got.epsilon == pytest.approx(want.epsilon, rel=1e-12)
        assert got.epsilon <= eps + 1e-9


def test_dp_histogram_noise_by_distribution():
    """σ = 50 on 16,384 empty-but-one buckets: the noise's mean and
    variance within five standard errors of 0 and σ²."""
    D, sigma = 16_384, 50.0
    res = _hist(fa, [np.array([0])] * 8, D, noise_scale=sigma,
                max_items_per_client=1, seed=7)
    noise = res.counts.copy()
    noise[0] -= 8
    assert abs(noise.mean()) < 5 * sigma / math.sqrt(D)
    assert abs(noise.var() / sigma ** 2 - 1) < 5 * math.sqrt(2.0 / D)
    assert np.all(noise == np.round(noise))  # integer noise


def test_dp_histogram_estimates_population():
    """tests/test_analytics.py's claim on the port."""
    items, _ = _population()
    res = _hist(fa, items, 64, epsilon=4.0, delta=1e-6,
                max_items_per_client=5, seed=1)
    assert res.participants == 400
    assert res.epsilon <= 4.0 + 1e-9
    total_items = sum(len(x) for x in items)
    top_true = sum((np.asarray(x) == 0).sum() for x in items)
    assert abs(res.counts[0] - top_true) < 5 * res.sigma + 0.1 * top_true
    assert abs(res.counts.sum() - total_items) < 0.2 * total_items \
        + 8 * res.sigma * math.sqrt(64)


def test_contribution_cap_bounds_influence():
    base = [np.array([1])] * 50
    hoard = base + [np.full(10_000, 3)]
    res = _hist(fa, hoard, 8, noise_scale=1e-6, max_items_per_client=5,
                seed=3)
    assert res.counts[3] <= 5 + 1.0


@pytest.mark.parametrize("kw,items,domain,match", [
    ({}, [np.array([0])], 4, "exactly one"),
    ({"epsilon": 1.0, "noise_scale": 5.0}, [np.array([0])], 4,
     "exactly one"),
    ({"epsilon": 1.0}, [np.array([7])], 4, "outside"),
    ({"epsilon": 1.0}, [], 4, "at least one client"),
])
def test_dp_histogram_refusals_match_the_reference(kw, items, domain,
                                                   match):
    for mod in (jfa, fa):
        with pytest.raises(ValueError, match=match):
            _hist(mod, items, domain, **kw)


def test_dp_histogram_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fa.dp_histogram([np.array([0])], 4, epsilon=1.0)


def test_read_outs_equal_the_reference():
    rng = np.random.default_rng(4)
    items = [np.array([2]) if rng.random() < 0.6 else np.array([7])
             for _ in range(600)]
    res = _hist(fa, items, 256, epsilon=4.0, max_items_per_client=1, seed=4)
    ref = jfa.AnalyticsResult(counts=res.counts, epsilon=res.epsilon,
                              delta=res.delta, sigma=res.sigma,
                              participants=res.participants)
    hh = fa.heavy_hitters(res, k=10, tau=4.0)
    assert hh == jfa.heavy_hitters(ref, k=10, tau=4.0)
    assert set(hh) == {2, 7} and hh[2] > hh[7]

    values = rng.normal(50, 10, 2000).clip(0, 100)
    edges = np.linspace(0, 100, 101)
    buckets = np.clip(np.digitize(values, edges) - 1, 0, 99)
    res = _hist(fa, [np.array([b]) for b in buckets], 100, epsilon=8.0,
                max_items_per_client=1, seed=5)
    ref = jfa.AnalyticsResult(counts=res.counts, epsilon=res.epsilon,
                              delta=res.delta, sigma=res.sigma,
                              participants=res.participants)
    qs = [0.1, 0.25, 0.5, 0.75, 0.9]
    q = fa.dp_quantiles(res, edges, qs)
    assert q == jfa.dp_quantiles(ref, edges, qs)
    assert abs(q[0.5] - 50) < 5
    for mod, r in ((fa, res), (jfa, ref)):
        with pytest.raises(ValueError, match="edges"):
            mod.dp_quantiles(r, edges[:-5], [0.5])
        with pytest.raises(ValueError, match="outside"):
            mod.dp_quantiles(r, edges, [1.5])


def test_randomized_response_equals_the_reference():
    rr, jrr = fa.RandomizedResponse(16, 2.0), jfa.RandomizedResponse(16, 2.0)
    assert (rr.p_true, rr.p_other) == (jrr.p_true, jrr.p_other)
    true_items = np.random.default_rng(6).integers(0, 16, size=40_000)
    got = rr.randomize(true_items, np.random.default_rng(9))
    want = jrr.randomize(true_items, np.random.default_rng(9))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rr.estimate_histogram(got),
                                  jrr.estimate_histogram(want))
    assert rr.estimator_std(40_000) == jrr.estimator_std(40_000)
    truth = np.bincount(true_items, minlength=16).astype(np.float64)
    assert np.abs(rr.estimate_histogram(got) - truth).max() \
        < 5 * rr.estimator_std(40_000)
    with pytest.raises(ValueError):
        fa.RandomizedResponse(4, 0.0)


# ---------------------------------------------------------------------------
# vertical FL
# ---------------------------------------------------------------------------

def _toy_task(n=512, d=20, classes=3, seed=0):
    """tests/test_vertical.py's task: the signal spread over both
    parties' columns."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1, (d, classes))
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    y = np.argmax(x @ w + 0.1 * rng.normal(0, 1, (n, classes)), axis=1)
    return x, y.astype(np.int32)


def _engine(mod, parts, y, classes, **cfg):
    kw = {"device": "cpu"} if mod is tv else {}
    return mod.VerticalFLEngine(parts, y, classes, mod.VerticalConfig(**cfg),
                                test_splits=parts, test_labels=y, **kw)


def test_split_features_equals_the_reference():
    x = np.random.default_rng(0).normal(size=(6, 4, 5, 1)).astype(np.float32)
    for parts in (2, 3, 4):
        for a, b in zip(tv.split_features(x, parts),
                        jv.split_features(x, parts)):
            np.testing.assert_array_equal(a, b)


def test_vertical_epochs_equal_the_reference():
    x, y = _toy_task(n=96, d=30, classes=4, seed=5)
    parts = tv.split_features(x, 3)
    cfg = dict(batch_size=96, hidden=16, cut_dim=8, learning_rate=1e-2)
    ref = _engine(jv, parts, y, 4, **cfg)
    eng = _engine(tv, parts, y, 4, **cfg)
    eng.load_reference_params(jax.device_get(ref.bottom_params),
                              jax.device_get(ref.top_params))
    for _ in range(2):
        want, got = ref.run_epoch(), eng.run_epoch()
        assert got["epoch"] == want["epoch"]
        for k in ("train_loss", "train_accuracy"):
            assert got[k] == pytest.approx(want[k], abs=1e-6), k
    bottom, top = eng.reference_params()
    want_leaves = jax.tree.leaves(jax.device_get(
        (ref.bottom_params, ref.top_params)))
    got_leaves = jax.tree.leaves((bottom, top))
    assert len(got_leaves) == len(want_leaves) == 2 * 2 * 3 + 4
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    want, got = ref.evaluate(), eng.evaluate()
    for k in ("loss", "accuracy"):
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    for name in ("exchanged_bytes_per_step", "exchanged_bytes_per_epoch",
                 "raw_feature_bytes"):
        assert getattr(eng, name)() == getattr(ref, name)(), name


def test_vertical_byte_counters_equal_the_reference():
    x, y = _toy_task(n=256)
    parts = tv.split_features(x, 4)
    ref = jv.VerticalFLEngine(parts, y, 3, jv.VerticalConfig(batch_size=32,
                                                             cut_dim=8))
    eng = tv.VerticalFLEngine(parts, y, 3, tv.VerticalConfig(batch_size=32,
                                                             cut_dim=8),
                              device="cpu")
    assert eng.exchanged_bytes_per_step() == 3 * 2 * 32 * 8 * 4
    for name in ("exchanged_bytes_per_step", "exchanged_bytes_per_epoch",
                 "raw_feature_bytes"):
        assert getattr(eng, name)() == getattr(ref, name)(), name


def test_vertical_learns_cross_party_signal():
    """tests/test_vertical.py's claim on the port: chance is 1/3."""
    x, y = _toy_task()
    eng = tv.VerticalFLEngine(
        tv.split_features(x[:384], 2), y[:384], num_classes=3,
        config=tv.VerticalConfig(batch_size=32, hidden=32, cut_dim=8,
                                 learning_rate=3e-3, seed=0),
        test_splits=tv.split_features(x[384:], 2), test_labels=y[384:],
        device="cpu")
    first = eng.run_epoch()
    for _ in range(14):
        last = eng.run_epoch()
    assert last["train_loss"] < first["train_loss"]
    assert eng.evaluate()["accuracy"] > 0.7


def test_vertical_cut_noise_still_trains_and_changes_run():
    x, y = _toy_task(seed=1)
    runs = []
    for std in (0.0, 0.5):
        eng = tv.VerticalFLEngine(
            tv.split_features(x, 2), y, 3,
            tv.VerticalConfig(batch_size=32, hidden=32, cut_dim=8, seed=2,
                              cut_noise_std=std), device="cpu")
        for _ in range(3):
            r = eng.run_epoch()
        runs.append(r["train_loss"])
    assert runs[0] != runs[1] and np.isfinite(runs[1])


@pytest.mark.parametrize("case,match", [
    ("one_party", ">= 2 parties"), ("ragged", "row-aligned"),
    ("labels", "labels")])
def test_vertical_refusals_match_the_reference(case, match):
    x, y = _toy_task(n=64)
    args = {"one_party": ([x], y, 3),
            "ragged": ([x[:32], x[:64]], y[:32], 3),
            "labels": (tv.split_features(x, 2), y[:10], 3)}[case]
    for mod in (jv, tv):
        kw = {"device": "cpu"} if mod is tv else {}
        with pytest.raises(ValueError, match=match):
            mod.VerticalFLEngine(*args, **kw)
