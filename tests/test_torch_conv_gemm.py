"""The port's GEMM-shaped convolutions and probe ops against their JAX
counterparts on the CPU, and the copied data loader.

Inputs come from numpy seeds and go through both sides. The JAX side runs
its Pallas kernels in interpret mode, as ``tests/test_ops.py`` does (the
probe script's two kernels through a ``pallas_call`` patched to interpret
for the test's duration); the port runs its plain PyTorch versions, which
a CPU tensor selects. Tolerances are the reference's own
(``tests/test_ops.py``): values and input gradients rtol 1e-4 / atol 1e-4,
weight gradients rtol 1e-4 / atol 2e-4 in f32 (f32 sums in another order);
in bf16 two ulps of the largest output (both sides round an f32 sum once,
and the sums differ in their last bits).
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl_tpu.data import create_data_loader as jax_create_data_loader
from fl_tpu.ops.conv import conv3x3_same as jax_conv3x3_same
from fl_tpu.ops.conv_pallas import conv3x3_pallas
from fl_tpu.ops.conv_pallas import conv_stem_s2d as jax_conv_stem_s2d
from fl_tpu.ops.conv_pallas import s2d_stem_weights as jax_s2d_stem_weights
from fl_tpu.ops.conv_pallas import space_to_depth2 as jax_space_to_depth2
from fl_tpu_torch.data import create_data_loader
from fl_tpu_torch.ops import conv_patch as cp
from fl_tpu_torch.ops import conv_probe as probe
from fl_tpu_torch.ops.conv import conv3x3_same

SHAPES = [
    (2, 14, 14, 32, 64),   # conv2 of SimpleCNN
    (2, 8, 8, 16, 16),
    (1, 28, 28, 4, 8),
]
IDS = ["conv2", "8x8", "28x28_I4"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conv_inputs(shape, seed=0):
    B, H, W, I, O = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, I)).astype(np.float32)
    w = (rng.standard_normal((3, 3, I, O)) * 0.1).astype(np.float32)
    g = rng.standard_normal((B, H, W, O)).astype(np.float32)
    return x, w, g


def _jax_conv(fn, x, w, g):
    y = fn(jnp.asarray(x), jnp.asarray(w))
    dx, dw = jax.grad(lambda a, b: jnp.sum(fn(a, b) * g), (0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    return np.asarray(y), np.asarray(dx), np.asarray(dw)


def _torch_conv(fn, x, w, g):
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    y = fn(xt, wt)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.tensor(g))
    return y.detach().numpy(), dx.numpy(), dw.numpy()


def _assert_conv_close(got, want):
    for (a, b), atol in zip(zip(got, want), (1e-4, 1e-4, 2e-4)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol)


# ---------------------------------------------------------------------------
# K7: conv3x3_patch, and the shift-GEMM conv3x3_same
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_conv3x3_patch_matches_pallas(shape):
    x, w, g = _conv_inputs(shape)
    _assert_conv_close(_torch_conv(cp.conv3x3_patch, x, w, g),
                       _jax_conv(conv3x3_pallas, x, w, g))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_conv3x3_same_matches_jax(shape):
    x, w, g = _conv_inputs(shape, seed=1)
    _assert_conv_close(_torch_conv(conv3x3_same, x, w, g),
                       _jax_conv(jax_conv3x3_same, x, w, g))


def test_conv3x3_patch_bf16_matches_pallas_bf16():
    x, w, g = _conv_inputs(SHAPES[0], seed=2)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    want = np.asarray(conv3x3_pallas(xj, wj).astype(jnp.float32))
    got = cp.conv3x3_patch(torch.tensor(x).bfloat16(),
                           torch.tensor(w).bfloat16())
    assert got.dtype == torch.bfloat16
    two_ulps = 2 * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=two_ulps)


def test_conv3x3_patch_client_axis_is_per_client():
    """Stacked clients equal the single-client op client by client, and the
    weight gradient comes back in the weights' dtype."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((3, 2, 6, 5, 3)).astype(np.float32))
    w = torch.tensor(rng.standard_normal((3, 3, 3, 3, 7)).astype(np.float32),
                     requires_grad=True)
    y = cp.conv3x3_patch(x.bfloat16(), w)
    dw, = torch.autograd.grad(y.float().sum(), w)
    assert y.dtype == torch.bfloat16 and dw.dtype == torch.float32
    for c in range(3):
        wc = w[c].detach().requires_grad_(True)
        yc = cp.conv3x3_patch(x[c].bfloat16(), wc)
        assert torch.equal(yc, y[c])
        assert torch.equal(torch.autograd.grad(yc.float().sum(), wc)[0],
                           dw[c])


def test_conv3x3_patch_skips_the_input_gradient_when_x_needs_none(
        monkeypatch):
    """The backward runs the weight gradient, and the input gradient only
    for an x that requires one."""
    calls = []
    plain = cp.conv3x3_patch_plain
    monkeypatch.setattr(cp, "conv3x3_patch_plain",
                        lambda x, w2: calls.append(tuple(w2.shape)) or
                        plain(x, w2))
    x, w, g = (torch.tensor(t) for t in _conv_inputs((1, 4, 4, 2, 3)))
    w.requires_grad_(True)
    torch.autograd.grad(cp.conv3x3_patch(x, w), w, g)
    assert calls == [(1, 18, 3)]                    # the forward only
    x.requires_grad_(True)
    torch.autograd.grad(cp.conv3x3_patch(x, w), (x, w), g)
    assert calls[1:] == [(1, 18, 3), (1, 27, 2)]    # forward, then dgrad


# ---------------------------------------------------------------------------
# the space-to-depth stem
# ---------------------------------------------------------------------------

def _stem_inputs(seed=4, C=None, constant=False):
    rng = np.random.default_rng(seed)
    lead = () if C is None else (C,)
    x = (np.ones(lead + (2, 28, 28, 1), np.float32) if constant else
         rng.standard_normal(lead + (2, 28, 28, 1)).astype(np.float32))
    w = (rng.standard_normal(lead + (3, 3, 1, 32)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(lead + (32,)) * 0.1).astype(np.float32)
    g = rng.standard_normal(lead + (2, 14, 14, 32)).astype(np.float32)
    return x, w, b, g


def test_space_to_depth_and_lifted_weights_equal_the_reference_exactly():
    x, w, _, _ = _stem_inputs()
    assert np.array_equal(cp.space_to_depth2(torch.tensor(x)).numpy(),
                          np.asarray(jax_space_to_depth2(jnp.asarray(x))))
    assert np.array_equal(cp.s2d_stem_weights(torch.tensor(w)).numpy(),
                          np.asarray(jax_s2d_stem_weights(jnp.asarray(w))))
    # with a client axis: the same rule client by client
    xs, ws, _, _ = _stem_inputs(C=3)
    got_x = cp.space_to_depth2(torch.tensor(xs)).numpy()
    got_w = cp.s2d_stem_weights(torch.tensor(ws)).numpy()
    for c in range(3):
        assert np.array_equal(
            got_x[c], np.asarray(jax_space_to_depth2(jnp.asarray(xs[c]))))
        assert np.array_equal(
            got_w[c], np.asarray(jax_s2d_stem_weights(jnp.asarray(ws[c]))))


def _stem_both(x, w, b, g, vmapped=False):
    jfn = jax.vmap(jax_conv_stem_s2d) if vmapped else jax_conv_stem_s2d
    xj, wj, bj = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    want = (jfn(xj, wj, bj),) + jax.grad(
        lambda w_, b_: jnp.sum(jfn(xj, w_, b_) * g), (0, 1))(wj, bj)
    wt = torch.tensor(w, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    y = cp.conv_stem_s2d(torch.tensor(x), wt, bt)
    got = (y.detach(),) + torch.autograd.grad(y, (wt, bt), torch.tensor(g))
    return [t.numpy() for t in got], [np.asarray(t) for t in want]


@pytest.mark.parametrize("vmapped", [False, True], ids=["one", "clients"])
def test_conv_stem_s2d_matches_jax(vmapped):
    got, want = _stem_both(*_stem_inputs(C=3 if vmapped else None),
                           vmapped=vmapped)
    for a, b, atol in zip(got, want, (1e-4, 2e-4, 2e-4)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol)


def test_conv_stem_s2d_shares_a_tied_maximum_evenly():
    """A constant image makes every interior pool window a four-way tie:
    the max over the parity groups splits the gradient evenly, in the port
    as in the reference (unlike the first-match pools of the fused
    segment)."""
    got, want = _stem_both(*_stem_inputs(seed=5, constant=True))
    assert np.abs(want[1]).max() > 1.0
    for a, b, atol in zip(got, want, (1e-4, 2e-4, 2e-4)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol)
    # the even split itself: four tied members, a quarter each
    t = torch.ones((1, 4), requires_grad=True)
    grad, = torch.autograd.grad(t.amax(dim=1).sum(), t)
    assert torch.equal(grad, torch.full((1, 4), 0.25))


# ---------------------------------------------------------------------------
# K8: the probe script's kernels
# ---------------------------------------------------------------------------

@pytest.fixture
def probe_script(monkeypatch):
    """scripts/probe_pallas_pipelined.py loaded by path at C = 2, with
    ``pallas_call`` in interpret mode while the test runs."""
    from jax.experimental import pallas as pl

    monkeypatch.setenv("BENCH_C", "2")
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))
    monkeypatch.setattr(sys, "path", list(sys.path))
    path = Path(__file__).resolve().parent.parent / "scripts" / (
        "probe_pallas_pipelined.py")
    spec = importlib.util.spec_from_file_location("_probe_script", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_probe_ops_match_the_probe_script(probe_script):
    ps = probe_script
    rng = np.random.default_rng(6)
    a = rng.standard_normal((2, 64, 9 * ps.I)).astype(np.float32)
    b = rng.standard_normal((2, 9 * ps.I, ps.O)).astype(np.float32)
    want = np.asarray(ps.pallas_batched_gemm(jnp.asarray(a), jnp.asarray(b)))
    got = probe.batched_gemm(torch.tensor(a), torch.tensor(b)).numpy()
    # K = 288 f32 sums of unit-variance terms in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)

    x = rng.standard_normal((2, ps.B, ps.H, ps.W, ps.I)).astype(np.float32)
    w = (rng.standard_normal((2, 3, 3, ps.I, ps.O)) * 0.1).astype(np.float32)
    port = probe.taploop_conv(torch.tensor(x), torch.tensor(w)).numpy()
    true = np.asarray(jax.vmap(ps.lax_conv)(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(port, true, rtol=1e-4, atol=1e-4)
    # the reference wrapper reads its kernel's rows one pixel off: its
    # output at (h, w) is the true convolution at (h + 1, w + 1)
    ref = np.asarray(ps.pallas_taploop_conv(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(ref[:, :, :-1, :-1], port[:, :, 1:, 1:],
                               rtol=1e-4, atol=1e-4)
    assert np.abs(ref - true).max() > 1.0


def test_batched_gemm_bf16_ragged_matches_the_probe_script(probe_script):
    """K8a's plain path in bf16 at the smoke run's ragged shape (rows of K
    and N not 16-byte pieces: the staged route on the card) against the
    probe script's kernel in interpret mode. Both sum in f32 over all of K
    and round once to bf16: one bf16 ulp of the larger value plus 1e-4."""
    rng = np.random.default_rng(8)
    a = rng.standard_normal((3, 70, 50)).astype(np.float32)
    b = rng.standard_normal((3, 50, 37)).astype(np.float32)
    want = probe_script.pallas_batched_gemm(jnp.asarray(a, jnp.bfloat16),
                                            jnp.asarray(b, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = probe.batched_gemm(torch.tensor(a).bfloat16(),
                             torch.tensor(b).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == (3, 70, 37)
    got = got.float().numpy()
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert not (np.abs(got - want) > ulp + 1e-4).any()


def test_probe_plain_versions_round_once_in_bf16():
    rng = np.random.default_rng(7)
    a = torch.tensor(rng.standard_normal((2, 8, 40)).astype(np.float32))
    b = torch.tensor(rng.standard_normal((2, 40, 5)).astype(np.float32))
    a16, b16 = a.bfloat16(), b.bfloat16()
    got = probe.batched_gemm(a16, b16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.bmm(a16.double(), b16.double()).bfloat16())
    x = torch.tensor(rng.standard_normal((2, 2, 5, 4, 3)).astype(np.float32))
    w = torch.tensor(rng.standard_normal((2, 3, 3, 3, 6)).astype(np.float32))
    y = probe.taploop_conv(x.bfloat16(), w.bfloat16())
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, cp.conv3x3_patch(x.bfloat16(), w.bfloat16()))


# ---------------------------------------------------------------------------
# the copied data loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["iid", "non_iid"])
def test_data_loader_copy_is_byte_identical(strategy):
    kw = dict(num_clients=6, partition_strategy=strategy, seed=2,
              n_train_synth=512, n_test_synth=64)
    jl, tl = jax_create_data_loader("mnist", **kw), create_data_loader(
        "mnist", **kw)
    ja, ta = jl.get_federated_arrays(), tl.get_federated_arrays()
    for f in ("images", "labels", "num_samples", "mean", "std"):
        a, b = getattr(ja, f), getattr(ta, f)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(jl.get_test_set(), tl.get_test_set()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert all(np.array_equal(a, b)
               for a, b in zip(jl.partitions, tl.partitions))
    assert jl.get_client_statistics() == tl.get_client_statistics()
    assert jl.analyze_distribution() == tl.analyze_distribution()
    assert len(tl.get_client_dataset(0)) == len(jl.get_client_dataset(0))
