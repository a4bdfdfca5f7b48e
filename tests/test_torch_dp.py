"""Delta-mode DP of the port vs fl_tpu, and the clip+noise op's noise.

Parity runs the reference's tree path (``use_pallas=False``) and the port
at ε = 1e9, where σ = sens·√(2 ln(1.25/δ))/ε is ~1e-9: the clip is
exercised and the noise (whose bits differ by construction) is negligible.
Clip scale, sensitivity and σ agree to 1e-6, outputs to 1e-5. The noise
itself is tested by its distribution, with tolerances set from the sample
size (about 5 standard errors each). At σ > 0 (ε = 5) the reference's tree
path, whose jnp noise is real, and the port's plain path are both held to
the same oracle: sensitivity and σ agree to 1e-6, and in each package the
residual (noisy − Δ·scale)/σ is N(0, 1) per leaf and per client and does
not correlate across the port's two leaf groups.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl_tpu.core import prng as jprng
from fl_tpu.core import pytree as jpt
from fl_tpu.fl.privacy import dp_noise_client_deltas as jax_dp_noise
from fl_tpu.ops.dp import gaussian_factor as jax_gaussian_factor
from fl_tpu_torch.core import prng
from fl_tpu_torch.fl import privacy
from fl_tpu_torch.ops import dp as dpo
from fl_tpu_torch.ops import launch_counts, reset_launch_counts

SHAPES = {"conv1": {"kernel": (3, 3, 1, 4), "bias": (4,)},
          "fc1": {"kernel": (300, 256), "bias": (256,)}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _deltas(C=4, seed=0):
    """Stacked deltas; client norms spread across the clip bound 1."""
    rng = np.random.default_rng(seed)
    out = {l: {k: rng.standard_normal((C,) + s).astype(np.float32)
               for k, s in leaves.items()} for l, leaves in SHAPES.items()}
    mult = np.array([1e-3, 5e-3, 2e-2, 1.0], np.float32)[:C]
    return {l: {k: v * mult.reshape((C,) + (1,) * (v.ndim - 1))
                for k, v in leaves.items()} for l, leaves in out.items()}


def test_matches_jax_delta_dp():
    d = _deltas()
    C, eps, delta, max_norm = 4, 1e9, 1e-5, 1.0
    keys = jprng.client_round_keys(jprng.root_key(0), 0, C)
    jd = jax.tree.map(jnp.asarray, d)
    j_noisy, j_sens, j_sigma = jax_dp_noise(jd, keys, eps, delta, max_norm,
                                            use_pallas=False)
    j_norm = jax.vmap(jpt.global_norm)(jd)
    j_scale = jnp.minimum(1.0, max_norm / jnp.maximum(j_norm, 1e-12))

    td = {l: {k: torch.tensor(v) for k, v in leaves.items()}
          for l, leaves in d.items()}
    t_noisy, t_sens, t_sigma = privacy.dp_noise_client_deltas(
        td, prng.round_seed(prng.root_seed(0), 0), eps, delta, max_norm)
    t_norm = privacy.client_norms(td)
    t_scale = torch.clamp(max_norm / t_norm, max=1.0)

    assert (np.asarray(j_norm) > max_norm).any()   # the clip is exercised
    assert (np.asarray(j_norm) < max_norm).any()
    for got, want in ((t_scale, j_scale), (t_sens, j_sens),
                      (t_sigma, j_sigma)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-12)
    for l in d:
        for k in d[l]:
            np.testing.assert_allclose(t_noisy[l][k].numpy(),
                                       np.asarray(j_noisy[l][k]),
                                       rtol=1e-5, atol=1e-5, err_msg=l + k)


G3_CLIENTS = 64
G3_EPS, G3_DELTA, G3_CLIP = 5.0, 1e-5, 1.0


@pytest.fixture(scope="module")
def noised_at_eps_5():
    """Both packages' noisy deltas at ε = 5 on the same 64 clients, whose
    norms spread across the clip bound: {package: (noisy, sens, sigma)},
    the deltas and the clip scale, all numpy."""
    C = G3_CLIENTS
    rng = np.random.default_rng(3)
    mult = np.geomspace(1e-4, 1e-2, C).astype(np.float32)
    d = {l: {k: (rng.standard_normal((C,) + s).astype(np.float32)
                 * mult.reshape((C,) + (1,) * len(s)))
             for k, s in leaves.items()} for l, leaves in SHAPES.items()}
    keys = jprng.client_round_keys(jprng.root_key(0), 0, C)
    jd = jax.tree.map(jnp.asarray, d)
    j_noisy, j_sens, j_sigma = jax_dp_noise(jd, keys, G3_EPS, G3_DELTA,
                                            G3_CLIP, use_pallas=False)
    td = {l: {k: torch.tensor(v) for k, v in leaves.items()}
          for l, leaves in d.items()}
    t_noisy, t_sens, t_sigma = privacy.dp_noise_client_deltas(
        td, prng.round_seed(prng.root_seed(0), 0), G3_EPS, G3_DELTA, G3_CLIP)
    norm = privacy.client_norms(td).numpy()
    out = {"jax": (jax.tree.map(np.asarray, j_noisy), np.asarray(j_sens),
                   np.asarray(j_sigma)),
           "torch": ({l: {k: v.numpy() for k, v in leaves.items()}
                      for l, leaves in t_noisy.items()}, t_sens.numpy(),
                     t_sigma.numpy())}
    return out, d, np.minimum(1.0, G3_CLIP / np.maximum(norm, 1e-12))


def _residuals(noisy, d, scale, sigma):
    """(noisy − Δ·scale)/σ of each leaf, (C, leaf size) float64."""
    C = scale.shape[0]
    return {(l, k): ((noisy[l][k].astype(np.float64)
                      - d[l][k] * scale.reshape((C,) + (1,) * (d[l][k].ndim
                                                               - 1)))
                     / sigma.reshape((C,) + (1,) * (d[l][k].ndim - 1))
                     ).reshape(C, -1)
            for l in d for k in d[l]}


def _assert_standard_normal(z, what):
    n = z.size
    assert abs(z.mean()) < 5 / np.sqrt(n), what
    assert abs(z.var() - 1) < 5 * np.sqrt(2 / n), what


def test_sensitivity_and_sigma_match_jax_at_eps_5(noised_at_eps_5):
    out, _, scale = noised_at_eps_5
    _, j_sens, j_sigma = out["jax"]
    _, t_sens, t_sigma = out["torch"]
    assert (scale < 1).any() and (scale == 1).any()  # the clip is exercised
    np.testing.assert_allclose(t_sens, j_sens, rtol=1e-6)
    np.testing.assert_allclose(t_sigma, j_sigma, rtol=1e-6)
    np.testing.assert_allclose(
        t_sigma, t_sens * dpo.gaussian_factor(G3_EPS, G3_DELTA), rtol=1e-6)
    assert t_sigma.min() > 0


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_noise_residuals_are_standard_normal_per_leaf_and_client(
        noised_at_eps_5, package):
    """Per leaf over its clients (n = 256 for conv1's bias up to 4.9M for
    fc1's kernel) and per client over its leaves (n = 77,096)."""
    out, d, scale = noised_at_eps_5
    noisy, _, sigma = out[package]
    res = _residuals(noisy, d, scale, sigma)
    for path, z in res.items():
        _assert_standard_normal(z, f"{package} {path}")
    per_client = np.concatenate(list(res.values()), axis=1)
    for c in range(G3_CLIENTS):
        _assert_standard_normal(per_client[c], f"{package} client {c}")
    assert abs((np.abs(per_client) > 3).mean() - 0.0027) < 5 * np.sqrt(
        0.0027 / per_client.size)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_noise_does_not_correlate_across_leaf_groups(noised_at_eps_5,
                                                     package):
    """fc1's kernel (its own group in the port) against the small leaves
    concatenated (the other group), element by element, per client, and
    across clients on the same leaf."""
    out, d, scale = noised_at_eps_5
    noisy, _, sigma = out[package]
    res = _residuals(noisy, d, scale, sigma)
    small = np.concatenate([z for p, z in res.items()
                            if p != ("fc1", "kernel")], axis=1)
    big = res[("fc1", "kernel")][:, :small.shape[1]]
    tol = 5 / np.sqrt(small.size)
    assert abs(np.corrcoef(big.ravel(), small.ravel())[0, 1]) < tol
    fc1 = res[("fc1", "kernel")]
    assert abs(np.corrcoef(fc1[0], fc1[1])[0, 1]) < 5 / np.sqrt(fc1.shape[1])


def test_gaussian_factor_matches_jax():
    for eps, delta in ((1.0, 1e-5), (1 / 28, 1e-5 / 28), (8.0, 1e-7)):
        assert dpo.gaussian_factor(eps, delta) == jax_gaussian_factor(
            eps, delta)


def test_leaf_groups_of_simple_cnn():
    """fc1's kernel is its own group; the small leaves share one."""
    from fl_tpu_torch.models import create_model

    model = create_model("simple_cnn")
    tree = {l: {k: torch.zeros((2,) + s) for k, s in leaves.items()}
            for l, leaves in model.param_shapes().items()}
    groups = privacy.leaf_groups(tree)
    assert groups[0] == [("fc1", "kernel")]
    assert len(groups) == 2 and ("fc1", "kernel") not in groups[1]
    assert sum(tree[l][k][0].numel() for l, k in groups[1]) == 20234


@pytest.mark.parametrize("sigma", [0.0, 0.5])
def test_plain_clip_noise_scales_rows(sigma):
    """σ=0 gives exactly x·scale; σ>0 noise has std σ per client."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 1 << 14), generator=g)
    scale = torch.tensor([1.0, 0.5, 0.25])
    sig = torch.full((3,), sigma)
    seeds = torch.as_tensor(prng.as_int64(prng.client_stream_seeds(7, 3, 2)))
    out = dpo.clip_noise(x, scale, sig, seeds)
    resid = out - x * scale[:, None]
    if sigma == 0.0:
        assert torch.equal(out, x * scale[:, None])
    else:
        # std of a 16k-sample std estimate ≈ σ/√(2n) ≈ 0.0028: 5 se
        np.testing.assert_allclose(resid.std(1).numpy(), sigma, atol=0.015)


def test_plain_noise_statistics():
    """Box–Muller on 24-bit uniforms: N(0, 1) by its first two moments,
    its 3σ tail, and independence across clients and leaf groups
    (n = 2^18 draws; each tolerance is about 5 standard errors)."""
    C, D = 4, 1 << 16
    rseed = prng.round_seed(prng.root_seed(0), 0)
    zs = []
    for gi in (0, 1):
        seeds = torch.as_tensor(prng.as_int64(prng.client_stream_seeds(
            rseed, C, prng.Stream.DP_NOISE, gi)))
        zs.append(dpo.clip_noise(torch.zeros((C, D)), torch.ones(C),
                                 torch.ones(C), seeds).double())
    z = zs[0].flatten()
    assert abs(float(z.mean())) < 1e-2
    assert abs(float(z.var()) - 1.0) < 0.015
    assert abs(float((z.abs() > 3).double().mean()) - 0.0027) < 6e-4
    assert abs(float(torch.corrcoef(zs[0][:2])[0, 1])) < 2e-2
    assert abs(float(torch.corrcoef(
        torch.stack([zs[0][0], zs[1][0]]))[0, 1])) < 2e-2


def test_seeds_never_collide_within_a_round():
    """Every (client, stream, group) seed of a 512-client round is
    distinct, and so are the rounds' shuffle/dropout roots."""
    rseed = prng.round_seed(prng.root_seed(0), 3)
    seeds = [prng.client_stream_seeds(rseed, 512, s, g)
             for s in prng.Stream for g in range(3)]
    seeds.append(np.array([prng.stream_seed(rseed, s) for s in prng.Stream],
                          np.uint64))
    flat = np.concatenate(seeds)
    assert len(np.unique(flat)) == flat.size
    rounds = [prng.round_seed(prng.root_seed(0), r) for r in range(1000)]
    assert len(set(rounds)) == 1000


def test_seeds_are_reproducible_and_seed_dependent():
    a = prng.client_stream_seeds(prng.round_seed(prng.root_seed(5), 2), 8,
                                 prng.Stream.DP_NOISE, 1)
    b = prng.client_stream_seeds(prng.round_seed(prng.root_seed(5), 2), 8,
                                 prng.Stream.DP_NOISE, 1)
    c = prng.client_stream_seeds(prng.round_seed(prng.root_seed(6), 2), 8,
                                 prng.Stream.DP_NOISE, 1)
    assert (a == b).all() and not (a == c).any()


def test_cpu_tensors_take_the_plain_version():
    reset_launch_counts()
    dpo.clip_noise(torch.zeros((2, 8)), torch.ones(2), torch.ones(2),
                   torch.zeros(2, dtype=torch.int64))
    assert launch_counts()["clip_noise"] == 0


@pytest.mark.parametrize("bad", ["seeds_dtype", "scale_shape", "x_dtype"])
def test_clip_noise_rejects_bad_arguments(bad):
    x, s, sig = torch.zeros((2, 8)), torch.ones(2), torch.ones(2)
    seeds = torch.zeros(2, dtype=torch.int64)
    if bad == "seeds_dtype":
        seeds = seeds.int()
    elif bad == "scale_shape":
        s = torch.ones(3)
    else:
        x = x.double()
    with pytest.raises(ValueError):
        dpo.clip_noise(x, s, sig, seeds)
