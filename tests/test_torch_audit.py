"""The one-run membership audit (Steinke, Nasr & Jagielski 2023) of the
port against fl_tpu.validation.audit.

The statistics and the canary construction are numpy in both packages and
must be EQUAL. The scoring functions are held to the reference's on the
same parameters and canaries at f32 tolerances (rtol 1e-4: a loss gradient
summed over a batch in another order). The end-to-end audits repeat the
reference's own behaviours (tests/test_privacy_audit.py) on the port's
engine on the CPU: their noise draws differ from the reference's by
construction, so they are held to the same claims, not to its numbers.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl_tpu.data import load_dataset as jax_load_dataset
from fl_tpu.data import make_federated_arrays as jax_make_arrays
from fl_tpu.models import create_model as jax_create_model
from fl_tpu.validation import audit as ja
from fl_tpu_torch.core.types import PrivacyConfig
from fl_tpu_torch.data import load_dataset, make_federated_arrays
from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
from fl_tpu_torch.models import create_model, params_from_flax
from fl_tpu_torch.orchestration import RoundEngineConfig
from fl_tpu_torch.validation import audit as ta

# ---------------------------------------------------------------------------
# statistics: equal values
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


@pytest.mark.parametrize("r", [1, 6, 20, 64])
def test_binomial_sf_and_tail_equal_the_reference(r):
    for v in range(-1, r + 2):
        for p in (0.0, 0.3, 0.5, 0.73, 1.0):
            assert ta.binomial_sf(v, r, p) == ja.binomial_sf(v, r, p)
        for eps in (0.0, 0.5, 2.0, 9.0):
            assert (ta.audit_tail_probability(v, r, eps)
                    == ja.audit_tail_probability(v, r, eps))


@pytest.mark.parametrize("r", [4, 8, 24])
@pytest.mark.parametrize("delta", [0.0, 1e-5, 1e-3])
def test_lower_bound_equals_the_reference(r, delta):
    for c in range(r + 1):
        for conf in (0.9, 0.95, 0.99):
            assert (ta.empirical_epsilon_lower_bound(c, r, 32, delta, conf)
                    == ja.empirical_epsilon_lower_bound(c, r, 32, delta,
                                                       conf))


def test_lower_bound_closed_form_and_refusals():
    """c = r = 20 all-correct guesses at β = 0.05: ε* = logit(β^(1/r))."""
    p_star = 0.05 ** (1 / 20)
    assert ta.empirical_epsilon_lower_bound(20, 20, 20) == pytest.approx(
        math.log(p_star / (1 - p_star)), abs=1e-6)
    assert ta.empirical_epsilon_lower_bound(0, 0, 10) == 0.0
    with pytest.raises(ValueError):
        ta.empirical_epsilon_lower_bound(5, 4, 10)


def test_canary_guesses_equal_the_reference():
    rng = np.random.default_rng(0)
    for m in (4, 16, 33):
        scores = rng.normal(size=m)
        for k in range(0, m // 2 + 1, max(1, m // 5)):
            assert np.array_equal(ta.canary_guesses(scores, k, k),
                                  ja.canary_guesses(scores, k, k))
    with pytest.raises(ValueError):
        ta.canary_guesses(np.zeros(6), 4, 3)


# ---------------------------------------------------------------------------
# canaries: equal bit for bit
# ---------------------------------------------------------------------------

def _arrays(num_clients=4, samples=16):
    kw = dict(num_clients=num_clients, strategy="iid",
              samples_per_client=samples, seed=0)
    return (jax_make_arrays(jax_load_dataset("mnist", n_train_synth=256,
                                             n_test_synth=64), **kw),
            make_federated_arrays(load_dataset("mnist", n_train_synth=256,
                                               n_test_synth=64), **kw))


@pytest.mark.parametrize("m,samples,seed", [(3, 8, 1), (16, 16, 7)],
                         ids=str)
def test_append_canary_clients_equals_the_reference(m, samples, seed):
    jarr, tarr = _arrays()
    want = ja.append_canary_clients(jarr, m, samples, seed=seed)
    got = ta.append_canary_clients(tarr, m, samples, seed=seed)
    assert got.num_clients == 4 + m
    for f in ("images", "labels", "num_samples", "mean", "std"):
        a, b = np.asarray(getattr(want, f)), np.asarray(getattr(got, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert not got.images[4:, samples:].any()
    with pytest.raises(ValueError):
        ta.append_canary_clients(tarr, 2, canary_samples=99)


@pytest.fixture(scope="module")
def models():
    """The reference's SimpleCNN variables and the port's copy of them."""
    jm = jax_create_model("simple_cnn", dropout_rate=0.0)
    jvars = jm.init(jax.random.PRNGKey(3))
    tvars = {"params": params_from_flax(jax.device_get(jvars["params"]))}
    return jm, jvars, tvars


@pytest.mark.parametrize("m,scale,seed", [(1, 1.0, 0), (16, 5.0, 9)],
                         ids=str)
def test_update_canaries_equal_the_reference(models, m, scale, seed):
    _, jvars, tvars = models
    want = ja.make_update_canaries(jax.device_get(jvars), m, scale, seed)
    got = ta.make_update_canaries(tvars, m, scale, seed)
    for l, leaves in want["params"].items():
        for k, v in leaves.items():
            g = got["params"][l][k]
            assert g.dtype == torch.float32
            assert np.array_equal(g.numpy(), np.asarray(v)), (l, k)
    norms = torch.sqrt(sum(v.reshape(m, -1).square().sum(1)
                           for d in got["params"].values()
                           for v in d.values()))
    np.testing.assert_allclose(norms.numpy(), scale, rtol=1e-5)


def _moved(tvars, seed):
    """A second parameter set near the first (one 'round' later)."""
    g = torch.Generator().manual_seed(seed)
    return {"params": {l: {k: v + 1e-2 * torch.randn(v.shape, generator=g)
                           for k, v in d.items()}
                       for l, d in tvars["params"].items()}}


def _to_jax(tvars):
    return {"params": {l: {k: jnp.asarray(v.numpy()) for k, v in d.items()}
                       for l, d in tvars["params"].items()}}


def test_update_dot_equals_the_reference(models):
    _, _, tvars = models
    new = _moved(tvars, 1)
    dirs = ta.make_update_canaries(tvars, 5, 1.0, seed=2)
    got = ta.make_update_dot_fn()(tvars, new, dirs)
    want = ja.make_update_dot_fn()(_to_jax(tvars), _to_jax(new),
                                   _to_jax(dirs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("fused", [False, "residual"], ids=str)
def test_canary_scores_equal_the_reference(models, fused):
    """The data canaries' gradient projection and loss drop, by autograd
    through the port's SimpleCNN (one pass over the model broadcast to the
    canaries) against the reference's vmapped jax.grad."""
    jm = jax_create_model("simple_cnn", dropout_rate=0.0,
                          fused_conv_block=fused)
    tm = create_model("simple_cnn", dropout_rate=0.0, fused_conv_block=fused)
    _, jvars, tvars = models
    new = _moved(tvars, 4)
    _, tarr = _arrays(num_clients=1)
    aud = ta.append_canary_clients(tarr, 4, 12, seed=5)
    batch = (aud.images[1:], aud.labels[1:], aud.num_samples[1:],
             aud.mean, aud.std)
    got = ta.make_canary_dot_fn(tm)(tvars, new, *batch)
    want = ja.make_canary_dot_fn(jm)(_to_jax(tvars), _to_jax(new),
                                     *map(jnp.asarray, batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)
    got = ta.make_canary_score_fn(tm)(tvars, new, *batch)
    want = ja.make_canary_score_fn(jm)(_to_jax(tvars), _to_jax(new),
                                       *map(jnp.asarray, batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the reference's audit behaviours, on the port's engine
# ---------------------------------------------------------------------------

def _config(dp_mode, z=1.0, epsilon=1e6, q=1.0, local_epochs=5):
    """tests/test_privacy_audit.py's configuration."""
    privacy = None
    if dp_mode != "none":
        privacy = PrivacyConfig(epsilon=epsilon, delta=1e-5,
                                max_grad_norm=5.0, noise_multiplier=z)
    return RoundEngineConfig(
        training=FederatedTrainingConfig(local_epochs=local_epochs,
                                         batch_size=8, learning_rate=0.01),
        dp_mode=dp_mode, privacy=privacy, participation_rate=q, seed=0)


def _audit(num_clients, config, **kw):
    _, arr = _arrays(num_clients)
    return ta.run_client_membership_audit(create_model("simple_cnn"), arr,
                                          config, device="cpu", **kw)


@pytest.mark.parametrize("config,kw,match", [
    (_config("none"), {"canary_kind": "update"}, "client_dp"),
    (_config("delta"), {}, "client_dp"),
    (_config("client_dp"), {"canary_kind": "gradient"}, "canary_kind"),
    (_config("none"), {"canary_kind": "data", "score_method": "auc"},
     "score_method"),
    (_config("client_dp"), {"mesh": object()}, "mesh"),
], ids=["update-x-none", "update-x-delta", "kind", "method", "mesh"])
def test_audit_refusals(config, kw, match):
    with pytest.raises(ValueError, match=match):
        _audit(4, config, **kw)


def test_audit_rejects_example_level_mode():
    """dp_sgd is refused by the audit: it certifies example-level DP."""
    class Cfg:
        dp_mode = "dp_sgd"

    with pytest.raises(ValueError, match="example-level"):
        _audit(4, Cfg())


def test_update_audit_weak_dp_finds_signal():
    """At z = 0.1 the update canaries through the production clip→noise
    path separate perfectly and refute small ε."""
    out = _audit(4, _config("client_dp", z=0.1, local_epochs=1),
                 num_canaries=16, num_rounds=4, guess_fraction=0.25, seed=5)
    assert out["canary_kind"] == "update"
    assert out["score_method"] == "update_dot"
    assert out["num_correct"] == out["num_guesses"] == 8
    assert out["empirical_epsilon_lower_bound"] > 0.5
    assert out["consistent"]


def test_update_audit_consistent_with_accountant():
    """At z = 1 the measured lower bound sits at or below the certified ε,
    which is the RDP accountant's after four rounds at q = 1."""
    from fl_tpu_torch.fl.accounting import compute_epsilon

    out = _audit(4, _config("client_dp", z=1.0, local_epochs=1),
                 num_canaries=16, num_rounds=4, seed=7)
    assert out["certified_epsilon"] == compute_epsilon(4, 1.0, 1.0, 1e-5)
    assert out["consistent"], out["empirical_epsilon_lower_bound"]


def test_update_audit_poisson_participation():
    out = _audit(4, _config("client_dp", z=0.1, q=0.5, local_epochs=1),
                 num_canaries=16, num_rounds=6, seed=3)
    assert out["num_correct"] >= out["num_guesses"] - 1
    assert out["consistent"]


def test_data_canary_audit_small_cohort_signal():
    """The loss-drop score ranks included canaries above excluded ones at
    high per-canary weight (2 real + 4 canary clients, 12 rounds)."""
    out = _audit(2, _config("none"), num_canaries=4, num_rounds=12,
                 canary_samples=16, canary_kind="data",
                 score_method="loss_drop", guess_fraction=0.25, seed=3)
    s = np.asarray(out["scores"])
    inc = np.asarray(out["included"], bool)
    assert inc.any() and (~inc).any()
    assert s[inc].min() > s[~inc].max()
    assert out["certified_epsilon"] is None
    assert out["score_method"] == "loss_drop"


@pytest.mark.parametrize("dp_mode", ["none", "delta"])
def test_data_canary_grad_dot_runs(dp_mode):
    """Under "delta" the rounds run the clip+noise op's plain version here;
    the certified ε is the additive ledger's."""
    cfg = _config(dp_mode)
    if dp_mode == "delta":
        cfg = RoundEngineConfig(
            training=cfg.training, dp_mode="delta", epsilon_per_round=2.0,
            delta_per_round=1e-6, privacy=PrivacyConfig(epsilon=10.0,
                                                        delta=1e-5))
    out = _audit(2, cfg, num_canaries=4, num_rounds=1, canary_samples=8,
                 canary_kind="data", score_method="grad_dot", seed=2)
    assert len(out["scores"]) == 4 and np.isfinite(out["scores"]).all()
    assert out["certified_epsilon"] == (2.0 if dp_mode == "delta" else None)
