"""The server-side functions of the port against fl_tpu: the robust
aggregators, secure aggregation, the server optimizers, SCAFFOLD's
variates and FedNova's effective steps, on the same numpy inputs.

Tolerances: f32 results within rtol 1e-6 / atol 1e-6 where both sides sum
in their own order (trimmed mean, Krum's average, the variates), equal
where nothing is summed (the median's middle values); Krum picks the same
clients. Secure aggregation's random bits differ by construction: its
result is held to plain FedAvg within the reference's own tolerance
(rtol 1e-4 / atol 1e-5, tests/test_secure_agg.py:63). The server
optimizers follow optax: rtol 1e-6 over three steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl_tpu.core import prng as jprng
from fl_tpu.fl import fedavg as jfa
from fl_tpu.fl import robust_agg as jra
from fl_tpu.fl import scaffold as jsc
from fl_tpu.fl import secure_agg as jsa
from fl_tpu.fl import server_optimizer as jso
from fl_tpu_torch.core import prng
from fl_tpu_torch.fl import fedavg as tfa
from fl_tpu_torch.fl import robust_agg as tra
from fl_tpu_torch.fl import scaffold as tsc
from fl_tpu_torch.fl import secure_agg as tsa
from fl_tpu_torch.fl import server_optimizer as tso

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _matrix(C, D, seed, outliers=True):
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((C, D)).astype(np.float32)
    if outliers:
        mat[1] *= 100.0   # a poisoned client
        mat[:, :3] = np.round(mat[:, :3])  # ties within a column
    return mat


MASKS = {
    "all-odd": np.ones(7, np.float32),
    "all-even": np.ones(8, np.float32),
    "partial-even": np.array([1, 0, 1, 1, 0, 1, 1, 1, 0, 1], np.float32),
    "partial-odd": np.array([0, 1, 1, 1, 1, 0, 1, 1, 1], np.float32),
}


def _both(mat, mask):
    return ((jnp.asarray(mat), jnp.asarray(mask)),
            (torch.tensor(mat), torch.tensor(mask)))


# ---------------------------------------------------------------------------
# robust aggregation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MASKS))
@pytest.mark.parametrize("trim_k", [1, 2])
def test_trimmed_mean_matches_jax(name, trim_k):
    mask = MASKS[name]
    (jm, jk), (tm, tk) = _both(_matrix(mask.size, 300, trim_k), mask)
    np.testing.assert_allclose(
        tra.trimmed_mean_matrix(tm, tk, trim_k).numpy(),
        np.asarray(jra.trimmed_mean_matrix(jm, jk, trim_k)), **TOL)


@pytest.mark.parametrize("name", list(MASKS))
def test_median_matches_jax_and_averages_the_middle_pair(name):
    mask = MASKS[name]
    mat = _matrix(mask.size, 300, 3)
    (jm, jk), (tm, tk) = _both(mat, mask)
    got = tra.median_matrix(tm, tk).numpy()
    assert np.array_equal(got, np.asarray(jra.median_matrix(jm, jk)))
    # an even count takes the mean of its two middle values
    np.testing.assert_allclose(got, np.median(mat[mask > 0], axis=0),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", list(MASKS))
@pytest.mark.parametrize("f,m", [(1, 1), (1, 3), (2, 2)])
def test_krum_matches_jax_and_picks_the_same_clients(name, f, m):
    mask = MASKS[name]
    mat = _matrix(mask.size, 257, 4)
    (jm, jk), (tm, tk) = _both(mat, mask)
    got = tra.krum_matrix(tm, tk, f, m).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jra.krum_matrix(jm, jk, f, m)), **TOL)
    # the picked set: the m lowest scores, the poisoned row never among them
    d2 = tra.pairwise_sq_distances(tm).numpy()
    alive = np.flatnonzero(mask > 0)
    k = max(alive.size - f - 2, 1)
    scores = {i: np.sort([d2[i, j] for j in alive if j != i])[:k].sum()
              for i in alive}
    picked = sorted(scores, key=lambda i: (scores[i], i))[:min(m, alive.size)]
    np.testing.assert_allclose(got, mat[picked].mean(0), **TOL)
    assert 1 not in picked


def test_krum_breaks_score_ties_in_client_order():
    mat = np.zeros((6, 16), np.float32)
    mat[:3] = 1.0          # three identical updates tie at score 0
    mat[3:] = [[5.0], [-5.0], [9.0]]
    got = tra.krum_matrix(torch.tensor(mat), torch.ones(6), 1, 2)
    want = jra.krum_matrix(jnp.asarray(mat), jnp.ones(6), 1, 2)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), mat[0])


def test_pairwise_distances_are_the_f64_ones():
    mat = _matrix(9, 1000, 8, outliers=False) + 3.0   # cancellation
    want = ((mat[:, None, :].astype(np.float64)
             - mat[None, :, :].astype(np.float64)) ** 2).sum(-1)
    got = tra.pairwise_sq_distances(torch.tensor(mat)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-2)


@pytest.mark.parametrize("method", ["trimmed_mean", "median", "krum"])
def test_robust_combine_deltas_matches_jax(method):
    rng = np.random.default_rng(9)
    g = {"dense": {"kernel": rng.standard_normal((13, 7)).astype(np.float32),
                   "bias": rng.standard_normal(7).astype(np.float32)}}
    stacked = {l: {k: (v[None] + 0.01 * rng.standard_normal(
        (8,) + v.shape)).astype(np.float32) for k, v in d.items()}
        for l, d in g.items()}
    mask = np.array([1, 1, 0, 1, 1, 1, 1, 1], np.float32)
    want = jra.robust_combine_deltas(
        {"params": jax.tree.map(jnp.asarray, g)},
        {"params": jax.tree.map(jnp.asarray, stacked)}, jnp.asarray(mask),
        method)["params"]
    got = tra.robust_combine_deltas(
        {l: {k: torch.tensor(v) for k, v in d.items()} for l, d in g.items()},
        {l: {k: torch.tensor(v) for k, v in d.items()}
         for l, d in stacked.items()}, torch.tensor(mask), method)
    for l in g:
        for k in g[l]:
            np.testing.assert_allclose(got[l][k].numpy(),
                                       np.asarray(want[l][k]), **TOL)


# ---------------------------------------------------------------------------
# secure aggregation
# ---------------------------------------------------------------------------

def test_ring_masks_cancel_and_dead_clients_carry_none():
    alive = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1, 0, 1.0])
    m = tsa.ring_pair_masks(1234, 10, 129, neighbors=3, scale=3.0,
                            alive=alive)
    assert float(m.sum(0).abs().max()) < 1e-3
    assert float(m[alive == 0].abs().max()) == 0.0
    assert float(m.abs().max()) > 1.0
    # each live row carries the masks of its 2k live pairs: ±scale·N(0, 1)
    full = tsa.ring_pair_masks(99, 64, 4096, neighbors=4, scale=2.0)
    assert abs(float(full.std()) / (2.0 * np.sqrt(8)) - 1) < 0.02


def test_neighbors_are_capped_below_the_client_count():
    m = tsa.ring_pair_masks(5, 3, 64, neighbors=8)
    assert float(m.sum(0).abs().max()) < 1e-5
    assert float(m.abs().max()) > 0.1


def _secure_case():
    rng = np.random.default_rng(2)
    g = {"dense": {"kernel": rng.standard_normal((13, 7)).astype(np.float32),
                   "bias": rng.standard_normal(7).astype(np.float32)}}
    stacked = {l: {k: (v[None] + 0.01 * rng.standard_normal(
        (8,) + v.shape)).astype(np.float32) for k, v in d.items()}
        for l, d in g.items()}
    n = np.array([10, 20, 30, 40, 10, 20, 30, 40], np.float32)
    mask = np.array([1, 1, 1, 0, 1, 1, 1, 1], np.float32)
    return g, stacked, n, mask


def _torch_tree(t):
    return {l: {k: torch.tensor(v) for k, v in d.items()}
            for l, d in t.items()}


def test_secure_fedavg_matches_plain_fedavg_and_the_reference():
    g, stacked, n, mask = _secure_case()
    w = tfa.normalized_client_weights(torch.tensor(n), torch.tensor(mask))
    plain = tfa.fedavg_delta(_torch_tree(g), _torch_tree(stacked), w)
    secure = tsa.secure_fedavg_delta(
        _torch_tree(g), _torch_tree(stacked), torch.tensor(n),
        torch.tensor(mask), prng.round_seed(prng.root_seed(3), 2),
        neighbors=3, scale=1.0)
    ref = jsa.secure_fedavg_delta(
        {"params": jax.tree.map(jnp.asarray, g)},
        {"params": jax.tree.map(jnp.asarray, stacked)}, jnp.asarray(n),
        jnp.asarray(mask), jprng.round_key(jprng.root_key(3),
                                           jnp.asarray(2)),
        neighbors=3, scale=1.0)["params"]
    for l in g:
        for k in g[l]:
            np.testing.assert_allclose(secure[l][k].numpy(),
                                       plain[l][k].numpy(),
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(secure[l][k].numpy(),
                                       np.asarray(ref[l][k]),
                                       rtol=1e-4, atol=1e-5)


def test_masked_payloads_hide_each_update_and_sum_to_the_weighted_sum():
    g, stacked, n, mask = _secure_case()
    deltas = {l: {k: torch.tensor(v - g[l][k][None]) for k, v in d.items()}
              for l, d in stacked.items()}
    payloads, spec = tsa.masked_payloads(deltas, torch.tensor(n),
                                         torch.tensor(mask), 77,
                                         neighbors=2, scale=1.0)
    from fl_tpu_torch.ops.flatten import stack_flatten

    raw, _ = stack_flatten(deltas)
    scaled = raw * (torch.tensor(n) * torch.tensor(mask))[:, None]
    assert float((payloads - scaled).abs().mean()) > 0.5
    np.testing.assert_allclose(payloads.sum(0).numpy(),
                               scaled.sum(0).numpy(), rtol=1e-5, atol=1e-5)
    assert float(payloads[3].abs().max()) == 0.0   # dropped: ships nothing


# ---------------------------------------------------------------------------
# server optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["fedavgm", "fedadam", "fedyogi"])
def test_server_optimizer_matches_optax(name):
    rng = np.random.default_rng(4)
    params = {"dense": {"kernel": rng.standard_normal((9, 5)).astype(
        np.float32), "bias": rng.standard_normal(5).astype(np.float32)}}
    kw = dict(learning_rate=0.01, momentum=0.9, b1=0.9, b2=0.99, eps=1e-3)
    jopt = jso.make_server_optimizer(name, **kw)
    jupd = jso.make_server_update_fn(jopt)
    topt = tso.make_server_optimizer(name, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = _torch_tree(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        target = jax.tree.map(lambda p: p + 0.05 * jnp.asarray(
            rng.standard_normal(p.shape), jnp.float32), jp)
        jp, js = jupd(jp, target, js)
        tp, ts = topt.update(tp, {l: {k: torch.tensor(np.asarray(v))
                                      for k, v in d.items()}
                                  for l, d in target.items()}, ts)
        for l in params:
            for k in params[l]:
                np.testing.assert_allclose(tp[l][k].numpy(),
                                           np.asarray(jp[l][k]),
                                           rtol=1e-6, atol=1e-7)
    # the reference's state read into the port's equals the port's own
    loaded = tso.state_from_optax(js)
    assert set(loaded) == set(ts)
    for key in loaded:
        if key == "count":
            assert loaded[key] == ts[key] == 3
            continue
        for l in params:
            for k in params[l]:
                # the pseudo-gradients differ by the params' ulps
                np.testing.assert_allclose(loaded[key][l][k].numpy(),
                                           ts[key][l][k].numpy(), **TOL)


def test_yogi_moments_start_at_1e_6_and_unknown_names_raise():
    topt = tso.make_server_optimizer("fedyogi")
    st = topt.init({"a": {"b": torch.zeros(3)}})
    assert float(st["mu"]["a"]["b"][0]) == np.float32(1e-6)
    assert tso.make_server_optimizer("none") is None
    with pytest.raises(ValueError) as want:
        jso.make_server_optimizer("fedsgd")
    with pytest.raises(ValueError) as got:
        tso.make_server_optimizer("fedsgd")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# SCAFFOLD's variates, FedNova's effective steps
# ---------------------------------------------------------------------------

def test_scaffold_update_matches_jax():
    rng = np.random.default_rng(6)
    C, D = 6, 256
    c = rng.standard_normal(D).astype(np.float32) * 1e-2
    ci = rng.standard_normal((C, D)).astype(np.float32) * 1e-2
    delta = rng.standard_normal((C, D)).astype(np.float32) * 1e-3
    mask = np.array([1, 1, 0, 1, 1, 1], np.float32)
    k = np.array([4, 0, 4, 2, 4, 6], np.float32)  # client 1: no steps
    jc, jci = jsc.scaffold_update(jnp.asarray(c), jnp.asarray(ci),
                                  jnp.asarray(delta), jnp.asarray(mask),
                                  jnp.asarray(k), 0.05, 10)
    tc, tci = tsc.scaffold_update(torch.tensor(c), torch.tensor(ci),
                                  torch.tensor(delta), torch.tensor(mask),
                                  torch.tensor(k), 0.05, 10)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(tci.numpy(), np.asarray(jci), **TOL)
    # non-participants and a participant without steps keep their c_i
    for i in (1, 2):
        assert np.array_equal(tci[i].numpy(), ci[i])


def test_scaffold_correction_is_c_minus_ci_in_the_flat_layout():
    from fl_tpu_torch.ops.flatten import stacked_spec, stack_flatten

    params = {"a": {"kernel": torch.zeros(3, 5), "bias": torch.zeros(5)},
              "b": {"kernel": torch.zeros(2, 2)}}
    spec = stacked_spec(params, 4)
    D_pad = 128
    c = torch.randn(D_pad)
    ci = torch.randn(4, D_pad)
    corr = tsc.scaffold_correction(c, ci, spec)
    mat, spec2 = stack_flatten(corr)
    assert spec2 == spec
    assert torch.equal(mat[:, :24], (c[None] - ci)[:, :24])


@pytest.mark.parametrize("momentum", [0.0, 0.5, 0.9])
def test_fednova_effective_steps_match_jax(momentum):
    tau = np.array([0, 1, 2, 5, 10, 25], np.float32)
    np.testing.assert_allclose(
        tfa.fednova_effective_steps(torch.tensor(tau), momentum).numpy(),
        np.asarray(jfa.fednova_effective_steps(jnp.asarray(tau), momentum)),
        rtol=1e-6, atol=1e-6)
