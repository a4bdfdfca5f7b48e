"""The port's gradient-inversion and membership-inference harnesses
(``fl_tpu_torch.validation.inversion`` / ``membership``) against the
reference's (``fl_tpu.validation.inversion`` / ``membership``), on the CPU.

Inversion, on SimpleCNN (unfused) with the reference's init
(``PRNGKey(0)``) carried across:

- the attack's objective and its input gradient at the same x (a random
  batch, and a scaled true image whose flat background puts exact ties in
  every pool window, so the second derivative must route them to the
  first maximal member as XLA does), against the reference's matching
  loss: 1e-5 relative / 1e-4 absolute, for L2 and cosine matching;
- float64 ``gradcheck`` of that input gradient (a double backward
  through ``GroupedConv``'s ``aten.convolution_backward`` and
  ``F.max_pool2d``) and ``gradgradcheck`` of the loss's input gradient;
- the reference's own claims (``tests/test_inversion.py``): the label
  inference, the bias path, the permutation MSE (the report's headline
  claim is in ``test_torch_inversion_report.py``, which keeps each file
  under 60 s).

Membership: the per-example losses against the reference's jitted chunked
scan at 1e-5 (chunks that do not divide N), the statistics and the
advantage bound equal to the reference's on the same inputs, and the
reference's claims (``tests/test_membership.py``) on the port's engine
with the q-FFL tests' tiny MLP: an untrained model near chance, an
overfit one leaking (AUC > 0.75), DP-SGD at ε = 2 under its ceiling and
below the non-private attack, pad slots left out of the members.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl_tpu.data.synthetic import synthetic_mnist
from fl_tpu.fl.local_training import cross_entropy_loss as jax_ce
from fl_tpu.models.factory import ModelFactory
from fl_tpu.validation import inversion as jinv
from fl_tpu.validation import membership as jmem
from fl_tpu_torch.core.types import PrivacyConfig
from fl_tpu_torch.data.federated import FederatedArrays
from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
from fl_tpu_torch.models import create_model
from fl_tpu_torch.models.layers import lecun_normal
from fl_tpu_torch.models.simple_cnn import params_from_flax
from fl_tpu_torch.orchestration import FederatedRoundEngine, RoundEngineConfig
from fl_tpu_torch.validation import inversion as inv
from fl_tpu_torch.validation import membership as mem

MEAN, STD = 0.1307, 0.3081


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def simple_cnn():
    """The reference's SimpleCNN at PRNGKey(0) and the port's with the same
    weights."""
    jmodel = ModelFactory.create_model("simple_cnn")
    jvars = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_flax(jax.device_get(jvars["params"]))
    return jmodel, jvars, create_model("simple_cnn"), {"params": params}


def _victim(xtr, ytr):
    x = (np.asarray(xtr, np.float32) / 255.0 - MEAN) / STD
    return x, np.asarray(ytr, np.int32)


# ---------------------------------------------------------------------------
# inversion
# ---------------------------------------------------------------------------

def _jax_matching(jmodel, jvars, target, labels, matching):
    """The reference's matching loss (its ``make_gradient_matching_attack``
    closure, written out: the attack itself is jitted whole)."""
    cfg = jinv.InversionAttackConfig(matching=matching)

    def victim_grad(x):
        def loss_fn(p):
            logits, _ = jmodel.apply({**jvars, "params": p}, x, train=False)
            return jax_ce(logits, labels)
        return jax.grad(loss_fn)(jvars["params"])

    def loss(x):
        g = jax.tree.leaves(victim_grad(x))
        t = jax.tree.leaves(target)
        if matching == "l2":
            m = sum(jnp.sum(jnp.square(a - b)) for a, b in zip(g, t))
        else:
            m = 0.0
            for a, b in zip(g, t):
                den = jnp.linalg.norm(a.ravel()) * jnp.linalg.norm(b.ravel())
                m = m + (1.0 - jnp.vdot(a, b) / jnp.maximum(den, 1e-12))
        return m + cfg.tv_weight * jinv._total_variation(x)

    return jax.jit(jax.value_and_grad(loss)), victim_grad


def _port_matching(model, variables, target_leaves, labels, matching):
    """The port's matching loss and its input gradient at x, one
    restart."""
    matching_losses = inv.matching_loss_fn(
        model, inv.InversionAttackConfig(matching=matching))
    params = {k: {kk: vv[None].clone().requires_grad_(True)
                  for kk, vv in v.items()}
              for k, v in variables["params"].items()}
    tgt = [torch.as_tensor(np.array(t))[None] for t in target_leaves]
    ys = torch.as_tensor(labels).long()[None]

    def value_and_grad(x):
        xt = torch.as_tensor(np.array(x))[None].requires_grad_(True)
        loss = matching_losses(xt, params, tgt, ys).sum()
        gx, = torch.autograd.grad(loss, xt)
        return float(loss.detach()), gx[0].numpy()

    return value_and_grad


@pytest.mark.parametrize("matching", ["l2", "cosine"])
def test_matching_loss_and_input_gradient_equal_the_reference(
        simple_cnn, matching):
    """At a random batch and at 0.9 x the true batch. Cosine matching near
    the truth sums 1 − cos over leaves whose gradients are almost
    parallel, which f32 resolves only to about 1e-5 of the loss (the
    reference's f32 value lies 1.7e-4 from its float64 one there, the
    port's 1.01e-5): that case is held to the reference's float64
    evaluation, at abs 2e-5."""
    jmodel, jvars, model, variables = simple_cnn
    xtr, ytr, _, _ = synthetic_mnist(n_train=8, n_test=1, seed=3)
    x_true, y = _victim(xtr[:2], ytr[:2])
    _, victim_grad = _jax_matching(jmodel, jvars, None, jnp.asarray(y),
                                   matching)
    target = victim_grad(jnp.asarray(x_true))
    jfn, _ = _jax_matching(jmodel, jvars, target, jnp.asarray(y), matching)
    pfn = _port_matching(model, variables, jax.tree.leaves(target), y,
                         matching)
    random_x = np.random.default_rng(1).normal(
        size=(2, 28, 28, 1)).astype(np.float32)
    for x in (random_x, 0.9 * x_true):
        got_l, got_g = pfn(x)
        if matching == "cosine" and x is not random_x:
            with jax.enable_x64(True):
                f64 = jax.tree.map(
                    lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                    (jvars, target))
                jfn64, _ = _jax_matching(
                    ModelFactory.create_model("simple_cnn",
                                              dtype=jnp.float64),
                    f64[0], f64[1], jnp.asarray(y), matching)
                want_l, want_g = jfn64(jnp.asarray(x, jnp.float64))
                want_l, want_g = float(want_l), np.asarray(want_g)
            assert got_l == pytest.approx(want_l, abs=2e-5)
        else:
            want_l, want_g = jfn(jnp.asarray(x))
            assert got_l == pytest.approx(float(want_l), rel=1e-5)
        np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=1e-5,
                                   atol=1e-4)


def test_input_gradient_passes_float64_gradient_checks(simple_cnn):
    """One image, one restart, float64 end to end: ``gradcheck`` of the
    matching loss's input gradient (itself a double backward) and
    ``gradgradcheck`` of the victim loss's input gradient."""
    _, jvars, _, _ = simple_cnn
    model = create_model("simple_cnn", dtype=torch.float64)
    params = {k: {kk: torch.tensor(np.asarray(vv), dtype=torch.float64
                                   )[None].requires_grad_(True)
                  for kk, vv in v.items()}
              for k, v in jax.device_get(jvars["params"]).items()}
    xtr, ytr, _, _ = synthetic_mnist(n_train=4, n_test=1, seed=5)
    x_true, y = _victim(xtr[:1], ytr[:1])
    x_true = torch.as_tensor(x_true, dtype=torch.float64)[None]
    ys = torch.as_tensor(y).long()[None]
    target = [t.detach() for t in
              inv._victim_grads(model, params, x_true, ys, False)]
    matching_losses = inv.matching_loss_fn(model,
                                           inv.InversionAttackConfig())
    x0 = (0.5 * x_true + 0.1 * torch.randn(
        x_true.shape, dtype=torch.float64,
        generator=torch.Generator().manual_seed(0))).requires_grad_(True)

    def matching(x):
        return matching_losses(x, params, target, ys).sum()

    def victim_loss(x):
        from fl_tpu_torch.fl.local_training import cross_entropy_loss
        return cross_entropy_loss(model(params, x, train=False), ys).sum()

    assert torch.autograd.gradcheck(matching, (x0,), eps=1e-6, atol=1e-5,
                                    rtol=1e-4, fast_mode=True)
    assert torch.autograd.gradgradcheck(victim_loss, (x0,), eps=1e-6,
                                        atol=1e-5, rtol=1e-4,
                                        fast_mode=True)


def test_gradient_from_delta_inverts_sgd_step():
    g = {"a": torch.tensor([1.0, -2.0]), "b": torch.tensor([[3.0]])}
    rec = inv.gradient_from_delta({k: -0.25 * v for k, v in g.items()}, 0.25)
    for k in g:
        assert torch.allclose(rec[k], g[k])


def test_label_inference_and_bias_path(simple_cnn):
    _, _, model, variables = simple_cnn
    path = inv.find_classifier_bias_path(variables, model.num_classes)
    assert path == "fc2/bias"
    params = {k: {kk: vv[None].clone().requires_grad_(True)
                  for kk, vv in v.items()}
              for k, v in variables["params"].items()}
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-1, 1, (1, 1, 28, 28, 1)),
                        dtype=torch.float32)
    for label in (0, 4, 9):
        g = inv._victim_grads(model, params, x,
                              torch.tensor([[label]]), False)
        assert int(inv.infer_labels(g[6][0], 1)[0]) == label  # fc2/bias
    x = torch.as_tensor(np.random.default_rng(1).uniform(
        -1, 1, (1, 2, 28, 28, 1)), dtype=torch.float32)
    g = inv._victim_grads(model, params, x, torch.tensor([[2, 7]]), False)
    assert set(inv.infer_labels(g[6][0], 2).tolist()) == {2, 7}
    np.testing.assert_array_equal(
        inv.infer_labels(g[6][0], 3).numpy(),
        np.asarray(jinv.infer_labels(jnp.asarray(g[6][0].numpy()), 3)))


def test_best_match_mse_handles_permutation():
    a, b = np.zeros((2, 4, 4, 1)), np.ones((2, 4, 4, 1))
    recon, truth = np.stack([b[0], a[0]]), np.stack([a[0], b[0]])
    assert inv._best_match_mse(recon, truth) == pytest.approx(0.0)
    assert inv._best_match_mse(recon, truth) == \
        jinv._best_match_mse(recon, truth)


def test_fused_conv_segment_is_refused():
    with pytest.raises(ValueError, match="second derivative"):
        inv.make_gradient_matching_attack(
            create_model("simple_cnn", fused_conv_block="residual"), 1)


def test_evaluate_returns_reconstruction_image(simple_cnn):
    _, _, model, variables = simple_cnn
    xtr, ytr, _, _ = synthetic_mnist(n_train=4, n_test=1, seed=5)
    out = inv.evaluate_inversion_risk(
        model, variables, xtr[:1], ytr[:1], MEAN, STD,
        attack_config=inv.InversionAttackConfig(steps=20, restarts=1),
        seed=1)
    img = out["reconstruction_u8"]
    assert img.shape == (1, 28, 28, 1) and img.dtype == np.uint8
    assert 0.0 <= out["label_accuracy"] <= 1.0
    assert out["noise_sigma"] == 0.0 and out["dp"] is None


# ---------------------------------------------------------------------------
# membership
# ---------------------------------------------------------------------------

def test_example_losses_equal_the_reference(simple_cnn):
    jmodel, jvars, model, variables = simple_cnn
    xtr, ytr, _, _ = synthetic_mnist(n_train=300, n_test=1, seed=2)
    x = xtr.reshape(300, 28, 28, 1)
    y = ytr[:300].astype(np.int32)
    want = np.asarray(jmem.make_example_loss_fn(jmodel, MEAN, STD, 128)(
        jvars, jnp.asarray(x), jnp.asarray(y)))
    got = mem.make_example_loss_fn(model, np.float32([MEAN]),
                                   np.float32([STD]), 128)(variables, x, y)
    assert got.shape == (300,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_statistics_equal_the_reference():
    rng = np.random.default_rng(3)
    for pos, neg in ((rng.normal(size=40), rng.normal(size=55)),
                     (np.round(rng.normal(size=30), 1),
                      np.round(rng.normal(0.5, size=30), 1)),
                     (np.asarray([1.0, 2.0]), np.asarray([1.0, 2.0]))):
        assert mem.rank_auc(pos, neg) == jmem.rank_auc(pos, neg)
        assert mem.best_threshold_advantage(pos, neg) == \
            jmem.best_threshold_advantage(pos, neg)
    for eps in (0.0, 0.1, 1.0, 8.0):
        for delta in (0.0, 1e-5, 0.1):
            assert mem.membership_advantage_bound(eps, delta) == \
                jmem.membership_advantage_bound(eps, delta)
    assert mem.membership_advantage_bound(1.0, 0.1) == pytest.approx(
        0.51591, abs=1e-5)
    with pytest.raises(ValueError):
        mem.membership_advantage_bound(-1.0)


class _TinyMLP(torch.nn.Module):
    """tests/test_qffl.py's tiny MLP (784 → 16 → 10) in the port's model
    interface, with flax's lecun_normal init."""

    input_shape = (28, 28, 1)
    num_classes = 10

    def init(self, generator, device):
        return {name: {"kernel": lecun_normal(s, generator, device),
                       "bias": torch.zeros(s[-1], device=device)}
                for name, s in (("fc1", (784, 16)), ("fc2", (16, 10)))}

    def dropout_keep(self, num_clients, batch, generator, device):
        return None  # no dropout

    def forward(self, params, x, *, train=False, generator=None,
                dropout_mask=None):
        C, B = x.shape[:2]
        h = torch.relu(torch.bmm(x.reshape(C, B, -1).float(),
                                 params["fc1"]["kernel"])
                       + params["fc1"]["bias"][:, None])
        return (torch.bmm(h, params["fc2"]["kernel"])
                + params["fc2"]["bias"][:, None])


def _data(C, n, seed, counts=None):
    xtr, ytr, _, _ = synthetic_mnist(n_train=C * n, n_test=1, seed=seed)
    return FederatedArrays(
        images=xtr.reshape(C, n, 28, 28, 1),
        labels=ytr.reshape(C, n).astype(np.int32),
        num_samples=(np.full(C, n, np.int32) if counts is None
                     else np.asarray(counts, np.int32)),
        mean=np.asarray([MEAN], np.float32),
        std=np.asarray([STD], np.float32), num_classes=10)


def _nonmembers(n=256, seed=9):
    x, y, _, _ = synthetic_mnist(n_train=n, n_test=1, seed=seed)
    return x.reshape(n, 28, 28, 1), y[:n].astype(np.int32)


def _sgd(epochs, lr):
    return FederatedTrainingConfig(local_epochs=epochs, batch_size=16,
                                   learning_rate=lr, optimizer_type="sgd")


def test_untrained_model_near_chance():
    eng = FederatedRoundEngine(_TinyMLP(), _data(4, 64, 0),
                               RoundEngineConfig(training=_sgd(1, 0.05),
                                                 seed=0), device="cpu")
    rep = mem.evaluate_membership_risk(eng, *_nonmembers())
    assert abs(rep.auc - 0.5) < 0.12, rep.auc
    assert (rep.n_members, rep.n_nonmembers) == (4 * 64, 256)


def test_overfit_model_leaks_and_dp_caps_it():
    data = _data(2, 32, 1)
    nx, ny = _nonmembers(seed=11)
    eng = FederatedRoundEngine(_TinyMLP(), data,
                               RoundEngineConfig(training=_sgd(5, 0.2),
                                                 seed=0), device="cpu")
    for _ in range(12):
        eng.run_round(evaluate=False)
    rep_np = mem.evaluate_membership_risk(eng, nx, ny)
    assert rep_np.auc > 0.75, rep_np.auc
    assert rep_np.advantage_bound is None

    eng_dp = FederatedRoundEngine(
        _TinyMLP(), data,
        RoundEngineConfig(training=_sgd(5, 0.2), dp_mode="dp_sgd",
                          dp_microbatch=16,
                          privacy=PrivacyConfig(epsilon=2.0, delta=1e-5,
                                                max_grad_norm=1.0,
                                                noise_multiplier=6.0),
                          seed=0), device="cpu")
    for _ in range(2):
        eng_dp.run_round(evaluate=False)
    rep_dp = mem.evaluate_membership_risk(eng_dp, nx, ny)
    bound = rep_dp.advantage_bound
    assert bound == pytest.approx(mem.membership_advantage_bound(2.0, 1e-5),
                                  rel=1e-9)
    slack = 2.5 * math.sqrt(math.log(rep_dp.n_nonmembers)
                            / rep_dp.n_members)
    assert rep_dp.advantage <= bound + slack, (rep_dp.advantage, bound)
    assert rep_dp.auc < rep_np.auc


def test_engine_adapter_filters_pad_slots():
    eng = FederatedRoundEngine(_TinyMLP(), _data(2, 32, 3, counts=[20, 7]),
                               RoundEngineConfig(training=_sgd(1, 0.05),
                                                 seed=0), device="cpu")
    rep = mem.evaluate_membership_risk(eng, *_nonmembers(n=64))
    assert rep.n_members == 27
    assert set(rep.to_dict()) >= {"auc", "advantage", "n_members",
                                  "advantage_bound"}
    assert set(rep.to_dict()) == set(jmem.MembershipReport(
        0, 0, 0, 0, 0, 0, 0).to_dict())
