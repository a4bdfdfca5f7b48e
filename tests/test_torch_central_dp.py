"""Client-level DP-FedAvg (``dp_mode="client_dp"``) of the port against
fl_tpu: the accountants, the central-noise functions, the feature rules
and the engine's client_dp rounds.

The accountants (RDP, PLD), the privacy-config helpers and the adaptive
multiplier are numpy copies and must give EQUAL values. The device
functions are held at f32 tolerances. Engine rounds take the random draws
out of the comparison as ``tests/test_torch_engine.py`` does (dropout 0,
``samples_per_client == batch_size == 16``, the port starts from the JAX
engine's parameters) and the noise with them: z = 1e-5 and ε = 1e11 so
that the gate admits the rounds. Over several rounds that noise (σ = 2.5e-6
an element at m̄ = 4) is still enough to flip the sign of a near-zero
gradient's first Adam step in the next round, a 2·lr move, so the adaptive
rounds take z = σ_b = 1e-9 (feasible: z_Δ ≈ 1.15e-9) and ε = 1e20.
Tolerances: bf16 params rtol 2e-2 / atol 1e-3 and train loss
rtol 5e-2 (the reference's one-round tolerances for two formulations of the
segment, tests/test_conv_block_engine.py); f32 params atol 2e-4 (one f32
Adam step moved by a summation order, ≤ lr = 1e-3, divided by m̄ = 4) and
loss rtol 1e-5. The noise itself is tested by its distribution.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from fl_tpu.core import pytree as jpt
from fl_tpu.core.types import PrivacyConfig as JaxPrivacyConfig
from fl_tpu.data import load_dataset as jax_load_dataset
from fl_tpu.data import make_federated_arrays as jax_make_arrays
from fl_tpu.fl import accounting as jacc
from fl_tpu.fl import pld as jpld
from fl_tpu.fl import privacy as jdp
from fl_tpu.fl import privacy_config as jpc
from fl_tpu.fl.local_training import \
    FederatedTrainingConfig as JaxTrainingConfig
from fl_tpu.models import create_model as jax_create_model
from fl_tpu.orchestration import FederatedRoundEngine as JaxEngine
from fl_tpu.orchestration import RoundEngineConfig as JaxConfig
from fl_tpu.orchestration.features import validate_config
from fl_tpu.validation.audit import make_update_canaries as jax_canaries
from fl_tpu_torch.core import prng
from fl_tpu_torch.core import pytree as tpt
from fl_tpu_torch.core.types import PrivacyConfig
from fl_tpu_torch.data import load_dataset, make_federated_arrays
from fl_tpu_torch.fl import accounting as tacc
from fl_tpu_torch.fl import pld as tpld
from fl_tpu_torch.fl import privacy as tdp
from fl_tpu_torch.fl import privacy_config as tpc
from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
from fl_tpu_torch.models import create_model, params_from_flax, params_to_flax
from fl_tpu_torch.orchestration import FederatedRoundEngine, RoundEngineConfig

LR = 1e-3
QUIET = dict(z=1e-5, epsilon=1e11)  # noise and budget out of the way
SILENT = dict(z=1e-9, epsilon=1e20)  # the same, over several rounds


# ---------------------------------------------------------------------------
# the accountants: equal values
# ---------------------------------------------------------------------------

RDP_GRID = [(q, z) for q in (0.01, 0.1, 0.5, 1.0) for z in (0.6, 1.0, 4.0)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("q,z", RDP_GRID, ids=str)
def test_rdp_values_equal_the_reference(q, z):
    a = jacc.rdp_subsampled_gaussian(q, z)
    b = tacc.rdp_subsampled_gaussian(q, z)
    assert np.array_equal(a, b)
    for steps in (1, 7, 300):
        for delta in (1e-5, 1e-3):
            assert (tacc.compute_epsilon(steps, q, z, delta)
                    == jacc.compute_epsilon(steps, q, z, delta))
            assert (tacc.eps_from_rdp(b * steps, delta)
                    == jacc.eps_from_rdp(a * steps, delta))


@pytest.mark.parametrize("target,q,steps", [(1.0, 0.1, 50), (8.0, 0.1, 4),
                                            (3.0, 0.5, 10)], ids=str)
def test_rdp_calibration_equals_the_reference(target, q, steps):
    assert (tacc.calibrate_noise_multiplier(target, 1e-5, q, steps)
            == jacc.calibrate_noise_multiplier(target, 1e-5, q, steps))


def test_rdp_accountant_equals_the_reference():
    ja, ta = jacc.RDPAccountant(), tacc.RDPAccountant()
    for q, z, n in [(0.1, 1.0, 1), (0.5, 2.0, 3), (1.0, 4.0, 2)]:
        ja.step(q, z, n)
        ta.step(q, z, n)
    extra = jacc.rdp_subsampled_gaussian(0.2, 1.5)
    ja.accumulate(extra)
    ta.accumulate(extra)
    for delta in (1e-5, 1e-7):
        assert ta.get_epsilon(delta) == ja.get_epsilon(delta)
        assert ta.get_epsilon_and_order(delta) == ja.get_epsilon_and_order(
            delta)
    assert ta.state_dict() == ja.state_dict()
    with pytest.raises(ValueError):
        ta.accumulate(extra[:3])
    loaded = tacc.RDPAccountant()
    loaded.load_state_dict(ja.state_dict())
    assert loaded.get_epsilon(1e-5) == ja.get_epsilon(1e-5)


PLD_GRID = [(1, 0.1, 1.0, 1e-5, None), (10, 0.1, 1.0, 1e-5, None),
            (6, 0.5, 1.2, 1e-5, 1e-3), (20, 0.05, 0.8, 1e-6, 5e-4),
            (4, 1.0, 2.0, 1e-5, None), (3, 1.0, 0.7, 1e-3, 1e-3)]


@pytest.mark.parametrize("steps,q,z,delta,dt", PLD_GRID, ids=str)
def test_pld_values_equal_the_reference(steps, q, z, delta, dt):
    assert (tpld.compute_epsilon_pld(steps, q, z, delta, dt)
            == jpld.compute_epsilon_pld(steps, q, z, delta, dt))
    grid = 1e-3 if dt is None else dt
    for a, b in zip(jpld.pld_subsampled_gaussian(q, z, grid),
                    tpld.pld_subsampled_gaussian(q, z, grid)):
        assert (a.offset, a.inf_mass, a.dt) == (b.offset, b.inf_mass, b.dt)
        assert np.array_equal(a.pmf, b.pmf)
    assert (tpld.suggest_pld_dt(3.0, steps)
            == jpld.suggest_pld_dt(3.0, steps))
    assert (tpld.analytic_gaussian_epsilon(z, delta)
            == jpld.analytic_gaussian_epsilon(z, delta))


def test_pld_calibration_and_accountant_equal_the_reference():
    args = (4.0, 1e-5, 0.5, 8)
    dt = 1e-3
    assert (tpld.calibrate_noise_multiplier_pld(*args, tol=1e-2, dt=dt)
            == jpld.calibrate_noise_multiplier_pld(*args, tol=1e-2, dt=dt))
    ja, ta = jpld.PLDAccountant(dt=1e-3), tpld.PLDAccountant(dt=1e-3)
    for q, z, n in [(0.5, 1.5, 2), (1.0, 3.0, 1), (0.5, 1.5, 3)]:
        ja.step(q, z, n)
        ta.step(q, z, n)
    assert ta.get_epsilon(1e-5) == ja.get_epsilon(1e-5)
    assert ta.state_dict() == ja.state_dict()
    auto_j, auto_t = jpld.PLDAccountant(), tpld.PLDAccountant()
    auto_j.step(0.1, 1.0, 2)
    auto_t.step(0.1, 1.0, 2)
    assert auto_t.get_epsilon(1e-5) == auto_j.get_epsilon(1e-5)


def test_privacy_config_helpers_equal_the_reference():
    for level in ("HIGH", "MEDIUM", "LOW"):
        j = jpc.PrivacyConfigManager().create_config(
            jpc.PrivacyLevel[level], epsilon=2.5)
        t = tpc.PrivacyConfigManager().create_config(
            tpc.PrivacyLevel[level], epsilon=2.5)
        assert isinstance(t, PrivacyConfig)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for ds, n in [("mnist", 10), ("cifar10", 200), ("other", 5)]:
        assert (dataclasses.asdict(tpc.create_privacy_config_for_dataset(
            ds, n)) == dataclasses.asdict(
                jpc.create_privacy_config_for_dataset(ds, n)))
    tm, jm = tpc.PrivacyConfigManager(), jpc.PrivacyConfigManager()
    assert (dataclasses.asdict(tm.optimize_for_accuracy(0.92, 3000, "simple",
                                                        16))
            == dataclasses.asdict(jm.optimize_for_accuracy(0.92, 3000,
                                                           "simple", 16)))
    assert (tm.analyze_privacy_utility_tradeoff()
            == jm.analyze_privacy_utility_tradeoff())
    weak = dict(epsilon=20.0, delta=1e-2, max_grad_norm=20.0,
                noise_multiplier=0.1)
    assert (tm.validate_config(PrivacyConfig(**weak))
            == jm.validate_config(JaxPrivacyConfig(**weak)))
    cfgs = {"a": dict(epsilon=0.5, delta=1e-6), "b": dict(epsilon=4.0,
                                                          delta=1e-5)}
    assert (tpc.compare_privacy_configs(
        {k: PrivacyConfig(**v) for k, v in cfgs.items()})
        == jpc.compare_privacy_configs(
            {k: JaxPrivacyConfig(**v) for k, v in cfgs.items()}))


def test_privacy_config_round_trips_through_a_file(tmp_path):
    cfg = tpc.create_privacy_config_for_dataset("mnist")
    for name in ("p.json", "p.yaml"):
        tpc.PrivacyConfigManager().save_config(cfg, str(tmp_path / name))
        back = tpc.PrivacyConfigManager(str(tmp_path / name)).current_config
        assert back == cfg
        ref = jpc.PrivacyConfigManager(str(tmp_path / name)).current_config
        assert dataclasses.asdict(ref) == dataclasses.asdict(cfg)


# ---------------------------------------------------------------------------
# the central-noise functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("z,sb", [(1.0, 2.56), (1.0, 0.6), (1e-5, 1e-5),
                                  (2.0, 4.0)], ids=str)
def test_adaptive_multiplier_equals_the_reference(z, sb):
    assert (tdp.adaptive_clip_delta_multiplier(z, sb)
            == jdp.adaptive_clip_delta_multiplier(z, sb))


@pytest.mark.parametrize("z,sb", [(1.0, 0.5), (1.0, 0.2), (1.0, 0.0)],
                         ids=str)
def test_infeasible_adaptive_multiplier_raises_the_reference_error(z, sb):
    with pytest.raises(jdp.PrivacyError) as want:
        jdp.adaptive_clip_delta_multiplier(z, sb)
    with pytest.raises(tdp.PrivacyError) as got:
        tdp.adaptive_clip_delta_multiplier(z, sb)
    assert str(got.value) == str(want.value)


def _stacked_tree(C=6, seed=0):
    """A client-stacked {layer: {leaf}} tree whose client norms straddle 1
    (some clipped, some not), in f32."""
    rng = np.random.default_rng(seed)
    scales = np.geomspace(0.05, 20.0, C)
    tree = {"conv": {"kernel": rng.normal(size=(C, 3, 3, 1, 4)),
                     "bias": rng.normal(size=(C, 4))},
            "fc": {"kernel": rng.normal(size=(C, 36, 10)),
                   "bias": rng.normal(size=(C, 10))}}
    norms = np.sqrt(sum((v.reshape(C, -1) ** 2).sum(1)
                        for d in tree.values() for v in d.values()))
    return {l: {k: (v * (scales / norms).reshape((C,) + (1,) * (v.ndim - 1))
                    ).astype(np.float32) for k, v in d.items()}
            for l, d in tree.items()}


def test_clip_client_deltas_matches_the_reference():
    """Norms and clipped trees, f32 rtol 1e-6; every clipped client ≤ C."""
    tree = _stacked_tree()
    jc, jn = jdp.clip_client_deltas(
        jax.tree.map(jnp.asarray, tree), 1.0)
    tc, tn = tdp.clip_client_deltas(
        tpt.tree_map(torch.from_numpy, tree), 1.0)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    for l in tree:
        for k in tree[l]:
            np.testing.assert_allclose(tc[l][k].numpy(),
                                       np.asarray(jc[l][k]), rtol=1e-6,
                                       atol=1e-9)
    assert (tdp.client_norms(tc) <= 1.0 + 1e-6).all()


def test_clip_by_global_norm_matches_the_reference():
    tree = {l: {k: v[2] for k, v in d.items()}
            for l, d in _stacked_tree(seed=3).items()}
    for c in (0.01, 1.0, 100.0):
        jc, js = jpt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), c)
        tc, ts = tpt.clip_by_global_norm(
            tpt.tree_map(torch.from_numpy, tree), c)
        np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
        for l in tree:
            for k in tree[l]:
                np.testing.assert_allclose(tc[l][k].numpy(),
                                           np.asarray(jc[l][k]), rtol=1e-6)


@pytest.mark.parametrize("clip", [0.3, 1.0, 50.0], ids=str)
def test_clipped_masked_mean_equals_clip_then_fixed_mean(clip):
    """The engine's fused form: Σ mₖ·clip(Δₖ) / m̄ against the reference's
    clip_client_deltas followed by its tensordot over the mask / m̄."""
    tree = _stacked_tree()
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32)
    m_bar = 2.4
    jc, _ = jdp.clip_client_deltas(jax.tree.map(jnp.asarray, tree), clip)
    got, norms = tdp.clipped_masked_mean(
        tpt.tree_map(torch.from_numpy, tree), clip, torch.from_numpy(mask),
        m_bar)
    for l in tree:
        for k in tree[l]:
            want = np.asarray(jnp.tensordot(jnp.asarray(mask), jc[l][k],
                                            axes=1) / jnp.float32(m_bar))
            np.testing.assert_allclose(got[l][k].numpy(), want, rtol=1e-5,
                                       atol=1e-7 * np.abs(want).max())


def _std_normal_checks(z, what):
    """z is N(0, 1): mean and variance at 5 standard errors, and a
    Kolmogorov–Smirnov test at 1e-3."""
    n = z.size
    assert abs(z.mean()) < 5 / math.sqrt(n), what
    assert abs(z.var() - 1) < 5 * math.sqrt(2 / n), what
    assert stats.kstest(z, "norm").pvalue > 1e-3, what


@pytest.mark.parametrize("sigma", [0.0195, 0.7], ids=str)
def test_central_noise_is_gaussian_in_both_packages(sigma):
    """central_noise_tree on a tree of SimpleCNN's leaf shapes: the
    residual / σ is N(0, 1) in the port and in the reference, leaf by leaf
    and across leaves uncorrelated (each leaf has its own sub-stream)."""
    shapes = {"conv1": {"kernel": (3, 3, 1, 32), "bias": (32,)},
              "conv2": {"kernel": (3, 3, 32, 64), "bias": (64,)},
              "fc2": {"kernel": (128, 10), "bias": (10,)}}
    base = {l: {k: np.random.default_rng(1).normal(size=s).astype(
        np.float32) for k, s in d.items()} for l, d in shapes.items()}
    got = tdp.central_noise_tree(tpt.tree_map(torch.from_numpy, base),
                                 prng.fold(prng.root_seed(0), 7), sigma)
    want = jdp.central_noise_tree(jax.tree.map(jnp.asarray, base),
                                  jax.random.PRNGKey(7), sigma)
    for noisy, pkg in ((got, "port"), (want, "reference")):
        res = {f"{l}/{k}": (np.asarray(noisy[l][k], np.float64)
                            - base[l][k]) / sigma
               for l in base for k in base[l]}
        _std_normal_checks(np.concatenate([r.ravel() for r in res.values()]),
                           pkg)
        _std_normal_checks(res["conv2/kernel"].ravel(), pkg)
        a, b = res["conv2/kernel"].ravel(), res["fc2/kernel"].ravel()
        r = np.corrcoef(a[:b.size], b)[0, 1]
        assert abs(r) < 5 / math.sqrt(b.size), pkg
    t = torch.zeros(1000)
    g = tdp.central_noise_tree({"a": {"x": t}}, 5, 1.0)["a"]["x"]
    assert torch.equal(g, tdp.central_noise_tree({"a": {"x": t}}, 5,
                                                 1.0)["a"]["x"])
    assert not torch.equal(g, tdp.central_noise_tree({"a": {"x": t}}, 6,
                                                     1.0)["a"]["x"])


def test_clip_fraction_and_geometric_update_match_the_reference():
    centered = torch.tensor(1.5)
    frac = tdp.noisy_clipped_fraction(centered, 5.0, 1e-9, 3)
    want = jdp.noisy_clipped_fraction(jnp.float32(1.5), 5.0, 1e-9,
                                      jax.random.PRNGKey(3))
    np.testing.assert_allclose(float(frac), float(want), rtol=1e-6)
    for c, f in [(1.0, 0.8), (0.3, 0.1), (2.0, 0.5)]:
        np.testing.assert_allclose(
            float(tdp.geometric_clip_update(torch.tensor(c), torch.tensor(f),
                                            0.5, 0.2)),
            float(jdp.geometric_clip_update(jnp.float32(c), jnp.float32(f),
                                            0.5, 0.2)), rtol=1e-6)
    draws = np.array([float(tdp.noisy_clipped_fraction(
        torch.tensor(0.0), 1.0, 1.0, s)) - 0.5 for s in range(2000)])
    _std_normal_checks(draws, "count noise")


# ---------------------------------------------------------------------------
# the feature rules: the reference's messages, verbatim
# ---------------------------------------------------------------------------

RULE_CASES = {
    "dp_mode-enum": {"dp_mode": "central"},
    "uplink-x-client_dp": {"dp_mode": "client_dp",
                           "uplink_compression": "int8"},
    "robust-x-client_dp": {"dp_mode": "client_dp", "aggregation": "median"},
    "aggregation-enum-x-client_dp": {"aggregation": "bogus",
                                     "dp_mode": "client_dp"},
    "robust-x-secure-x-client_dp": {"aggregation": "median",
                                    "secure_aggregation": True,
                                    "dp_mode": "client_dp"},
    "accountant-enum": {"accountant": "moments"},
    "pld-x-delta": {"dp_mode": "delta", "accountant": "pld"},
    "pld-x-none": {"accountant": "pld"},
    "adaptive-x-none": {"adaptive_clipping": True},
    "adaptive-x-delta": {"dp_mode": "delta", "adaptive_clipping": True},
    "audit-x-none": {"audit_injection": True},
    "audit-x-delta": {"dp_mode": "delta", "audit_injection": True},
}


@pytest.mark.parametrize("kwargs", list(RULE_CASES.values()),
                         ids=list(RULE_CASES))
def test_feature_rules_raise_the_reference_messages(kwargs):
    with pytest.raises(ValueError) as want:
        validate_config(JaxConfig(**kwargs), 4)
    with pytest.raises(ValueError) as got:
        RoundEngineConfig(**kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kwargs", [
    {"dp_mode": "client_dp"},
    {"dp_mode": "client_dp", "accountant": "pld", "pld_dt": 1e-3},
    {"dp_mode": "client_dp", "adaptive_clipping": True,
     "audit_injection": True, "downlink_compression": "int8"},
], ids=["client_dp", "pld", "adaptive+audit+downlink"])
def test_client_dp_compositions_are_accepted(kwargs):
    validate_config(JaxConfig(**kwargs), 4)
    RoundEngineConfig(**kwargs)


@pytest.mark.parametrize("mode", ["dp_sgd", "dp_ftrl", "distributed"])
def test_other_dp_modes_are_refused_by_name(mode):
    """The other modes are ported: each is taken where the reference takes
    it, and refused by the reference's rules with its messages, here
    adaptive clipping outside client_dp."""
    validate_config(JaxConfig(dp_mode=mode, ftrl_rounds=4), 4)
    RoundEngineConfig(dp_mode=mode, ftrl_rounds=4)
    kwargs = dict(dp_mode=mode, ftrl_rounds=4, adaptive_clipping=True)
    with pytest.raises(ValueError) as want:
        validate_config(JaxConfig(**kwargs), 4)
    with pytest.raises(ValueError) as got:
        RoundEngineConfig(**kwargs)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# engine rounds against the JAX engine
# ---------------------------------------------------------------------------

def _arrays(num_clients):
    kw = dict(num_clients=num_clients, strategy="iid", samples_per_client=16,
              seed=0)
    return (jax_make_arrays(jax_load_dataset("mnist", n_train_synth=256,
                                             n_test_synth=64), **kw),
            make_federated_arrays(load_dataset("mnist", n_train_synth=256,
                                               n_test_synth=64), **kw))


def _engines(dtype_name="f32", num_clients=4, z=1.0, epsilon=8.0,
             clip=1.0, local_epochs=2, fused="residual", port_only=False,
             **cfg):
    """A client_dp JAX engine and the port's, from the same initial
    parameters and the same config (the port's alone if ``port_only``)."""
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[dtype_name]
    state = "bfloat16" if dtype_name == "bf16" else None
    common = dict(dp_mode="client_dp", seed=0, **cfg)
    priv = dict(epsilon=epsilon, delta=1e-5, max_grad_norm=clip,
                noise_multiplier=z)
    train = dict(local_epochs=local_epochs, batch_size=16, learning_rate=LR,
                 optimizer_state_dtype=state)
    jarr, tarr = _arrays(num_clients)
    if port_only:
        return FederatedRoundEngine(
            create_model("simple_cnn", dtype=tdt, dropout_rate=0.0,
                         fused_conv_block=fused), tarr,
            RoundEngineConfig(training=FederatedTrainingConfig(**train),
                              privacy=PrivacyConfig(**priv), **common),
            device="cpu")
    jeng = JaxEngine(
        jax_create_model("simple_cnn", dtype=jdt, fused_conv_block=fused,
                         dropout_rate=0.0), jarr,
        JaxConfig(training=JaxTrainingConfig(optimizer_type="adam", **train),
                  privacy=JaxPrivacyConfig(**priv), **common))
    teng = FederatedRoundEngine(
        create_model("simple_cnn", dtype=tdt, dropout_rate=0.0,
                     fused_conv_block=fused), tarr,
        RoundEngineConfig(training=FederatedTrainingConfig(**train),
                          privacy=PrivacyConfig(**priv), **common),
        device="cpu")
    teng.global_variables = {"params": params_from_flax(
        jax.device_get(jeng.global_variables["params"]))}
    return jeng, teng


def _params(jeng, teng):
    jp = jax.device_get(jeng.global_variables["params"])
    tp = params_to_flax(teng.global_variables["params"])
    keys = sorted(f"{l}/{k}" for l in jp for k in jp[l])
    assert keys == sorted(f"{l}/{k}" for l in tp for k in tp[l])
    pick = lambda t, key: np.asarray(t[key.split("/")[0]][key.split("/")[1]],
                                     np.float32)
    return ({k: pick(jp, k) for k in keys}, {k: pick(tp, k) for k in keys})


def _assert_params_close(jeng, teng, dtype):
    ja, ta = _params(jeng, teng)
    for k in ja:
        if dtype == "bf16":
            np.testing.assert_allclose(ta[k], ja[k], rtol=2e-2, atol=1e-3,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(ta[k], ja[k], rtol=0, atol=2e-4,
                                       err_msg=k)


def test_client_dp_masks_are_pure_poisson_and_equal_the_reference():
    """Six rounds at q = 0.5 over 4 clients: the masks equal the JAX
    engine's, and some round is under-full (below min_clients = 2, which
    client_dp never forces)."""
    jeng, teng = _engines(participation_rate=0.5)
    masks = []
    for r in range(6):
        want = jeng.sample_participation(exclude=[3] if r == 5 else None)
        got = teng.sample_participation(exclude=[3] if r == 5 else None)
        np.testing.assert_array_equal(got, want)
        masks.append(got)
    assert min(m.sum() for m in masks) < 2


@pytest.fixture(scope="module", params=["f32", "bf16"])
def quiet_round(request):
    """One client_dp round of each package with the noise taken out."""
    jeng, teng = _engines(request.param, **QUIET)
    jr = jeng.run_round(evaluate=False)
    tr = teng.run_round(evaluate=False)
    return dict(dtype=request.param, jeng=jeng, teng=teng, jr=jr, tr=tr)


def test_client_dp_round_matches_jax(quiet_round):
    r = quiet_round
    jr, tr = r["jr"], r["tr"]
    assert tr.participating_clients == jr.participating_clients == 4
    np.testing.assert_allclose(
        tr.train_loss, jr.train_loss,
        rtol=5e-2 if r["dtype"] == "bf16" else 1e-5)
    _assert_params_close(r["jeng"], r["teng"], r["dtype"])
    # the same ε charged, by the same numpy accountant
    assert tr.epsilon_spent == jr.epsilon_spent
    assert (r["teng"].certified_epsilon() == r["jeng"].certified_epsilon())


def test_client_dp_round_keeps_the_reference_ledger(quiet_round):
    r = quiet_round
    jl = r["jeng"].accountant.get_privacy_ledger()[-1]
    tl = r["teng"].accountant.get_privacy_ledger()[-1]
    for key in ("mechanism_type", "epsilon", "delta", "sensitivity",
                "metadata"):
        assert tl[key] == jl[key], key
    np.testing.assert_allclose(tl["noise_scale"], jl["noise_scale"],
                               rtol=1e-6)
    assert tl["noise_scale"] == pytest.approx(1e-5 * 1.0 / 4, rel=1e-6)


def test_audit_injection_round_matches_jax():
    """One flagged client submits an update canary in place of its trained
    delta, ahead of the clip, in both packages (f32, noise out)."""
    jeng, teng = _engines("f32", audit_injection=True, **QUIET)
    dirs = jax_canaries(jax.device_get(jeng.global_variables), 4, 0.7,
                        seed=11)
    flags = np.array([0, 1, 0, 0], np.float32)
    jeng.run_round(evaluate=False, inject_flags=flags,
                   inject_deltas=jax.tree.map(jnp.asarray, dirs))
    teng.run_round(evaluate=False, inject_flags=flags,
                   inject_deltas={"params": params_from_flax(
                       dirs["params"])})
    _assert_params_close(jeng, teng, "f32")


def test_injection_needs_audit_injection_and_deltas():
    teng = _engines("f32", port_only=True, **QUIET)
    with pytest.raises(ValueError, match="audit_injection is off"):
        teng.run_round(evaluate=False, inject_flags=np.ones(4, np.float32))
    with pytest.raises(ValueError, match="audit_injection is off"):
        teng.run_round(evaluate=False, inject_deltas={})
    inj = _engines("f32", audit_injection=True, port_only=True, **QUIET)
    with pytest.raises(ValueError, match="without inject_deltas"):
        inj.run_round(evaluate=False, inject_flags=np.ones(4, np.float32))


def test_adaptive_clipping_matches_jax_over_three_rounds(monkeypatch):
    """Three adaptive rounds (f32, σ_b = 1e-9): the clip norm each round
    used, the next one and the noisy clipped fraction to rtol 1e-5, and
    the parameters. η_C = 1 moves C far enough a round that the clipped
    fraction takes both sides of γ. No client's pre-clip norm lies within
    1% of the clip norm its round used, so the two packages' f32 norms
    cannot flip a clipped bit."""
    norms = []
    fused = tdp.clipped_masked_mean

    def spy(deltas, max_norm, mask, m):
        out = fused(deltas, max_norm, mask, m)
        norms.append(out[1].clone())
        return out

    monkeypatch.setattr(tdp, "clipped_masked_mean", spy)
    jeng, teng = _engines("f32", clip=1.0, adaptive_clipping=True,
                          clip_count_stddev=1e-9, clip_lr=1.0, **SILENT)
    jr = [jeng.run_round(evaluate=False) for _ in range(3)]
    tr = [teng.run_round(evaluate=False) for _ in range(3)]
    jc = [r.clip_norm for r in jr] + [jeng.clip_norm]
    tc = [r.clip_norm for r in tr] + [teng.clip_norm]
    np.testing.assert_allclose(tc, jc, rtol=1e-5)
    # b̃ from C' = C·exp(−η(b̃ − γ)): the noisy clipped fraction by round,
    # equal up to the two packages' count noise, N(0, (σ_b / m̄)²) each
    frac = lambda c: 0.5 - np.log(np.asarray(c[1:]) / np.asarray(c[:-1]))
    np.testing.assert_allclose(frac(tc), frac(jc), rtol=1e-5,
                               atol=5 * 1e-9 / 4)
    # the fractions took both sides of the quantile
    assert min(frac(tc)) < 0.5 < max(frac(tc))
    for n, c in zip(norms, tc):
        assert (torch.abs(n / c - 1) > 0.01).all(), (n, c)
    _assert_params_close(jeng, teng, "f32")
    with pytest.raises(ValueError, match="cannot pipeline adaptive"):
        teng.run_rounds_pipelined(1)


def test_adaptive_clipping_refuses_an_infeasible_count_noise():
    """At init, as the reference: 2σ_b = 0.8 < z = 1."""
    with pytest.raises(jdp.PrivacyError) as want:
        _engines("f32", adaptive_clipping=True, clip_count_stddev=0.4)
    with pytest.raises(tdp.PrivacyError) as got:
        _engines("f32", adaptive_clipping=True, clip_count_stddev=0.4,
                 port_only=True)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("accountant", ["rdp", "pld"])
def test_budget_gate_refuses_at_the_same_round(accountant):
    """q = 0.5, z = 1.2, ε = 5: both packages admit the same rounds (two
    under RDP, three under PLD on a 1e-3 grid), with equal ε by round, and
    refuse the same one with the same message."""
    kw = dict(z=1.2, epsilon=5.0, participation_rate=0.5, local_epochs=1,
              accountant=accountant)
    if accountant == "pld":
        kw["pld_dt"] = 1e-3
    jeng, teng = _engines("f32", **kw)
    trail = []
    for pkg in (jeng, teng):
        eps = []
        with pytest.raises(Exception) as err:
            for _ in range(12):
                pkg.run_round(evaluate=False)
                eps.append((pkg.history[-1].epsilon_spent,
                            pkg.certified_epsilon()))
        trail.append((eps, type(err.value).__name__, str(err.value)))
    assert trail[1] == trail[0]
    assert trail[0][1] == "PrivacyError" and 1 < len(trail[0][0]) < 12


def test_client_dp_noise_on_the_engine_is_gaussian():
    """Two port engines that differ only in z: their global models differ
    by the central noise, (Δθ)/σ ~ N(0, 1) with σ = z·C/m̄."""
    loud = _engines("f32", z=2.0, epsilon=1e6, local_epochs=1,
                    participation_rate=0.5, port_only=True)
    quiet = _engines("f32", local_epochs=1, participation_rate=0.5,
                     port_only=True, **SILENT)
    mask = np.array([1, 1, 0, 1], np.float32)
    loud.run_round(mask, evaluate=False)
    quiet.run_round(mask, evaluate=False)
    sigma = 2.0 * 1.0 / 2.0   # m̄ = 0.5·4
    diff = np.concatenate([
        (loud.global_variables["params"][l][k]
         - quiet.global_variables["params"][l][k]).numpy().ravel()
        for l, k in tpt.tree_paths(loud.global_variables["params"])])
    _std_normal_checks(diff.astype(np.float64) / sigma, "engine noise")
    assert loud.accountant.get_privacy_ledger()[0]["noise_scale"] == \
        pytest.approx(sigma, rel=1e-6)
