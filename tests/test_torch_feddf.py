"""The port's FedDF engine (``fl_tpu_torch.fl.feddf``) against the
reference's ``fl_tpu.fl.feddf``.

Both engines train 4 clients of 16 images (SimpleCNN in f32 with
``fused_conv_block="residual"``: the reference's Pallas kernels in
interpret mode, the port's K1/K2 through their plain versions) from the
reference's init carried across, with the draws out of the comparison
(dropout 0, ``samples_per_client == batch_size``) and plain SGD.

- ``distill_steps = 0``: two rounds equal the reference's (exact FedAvg,
  its anchor) within its mesh bound (rtol 2e-5 / atol 2e-6), both KLs 0.
- ``distill_kl_before`` equals the reference's (the fixed probe batch)
  within rtol 1e-4, the reference's mesh bound for it.
- A proxy set of IDENTICAL images makes the index draws irrelevant (the
  two packages' streams differ by construction): a whole round of 4
  distill steps at the default lr 1e-3 equals the reference's, Adam at
  τ = 1 and SGD at τ = 2, within the reference's FedDF bound (rtol 2e-4 /
  atol 2e-5), the KLs within rtol 1e-4.
- The proxy indices stay in range with a uniform histogram (chi-square);
  ``evaluate`` on normalized images equals the reference's; every refusal
  carries the reference's message; without a card and without
  ``device="cpu"`` the engine raises.
"""

import types

import numpy as np
import pytest
import torch

import jax
from fl_tpu.data.federated import FederatedArrays as JaxArrays
from fl_tpu.data.synthetic import synthetic_mnist
from fl_tpu.fl.feddf import FedDFConfig as JaxConfig
from fl_tpu.fl.feddf import FedDFEngine as JaxEngine
from fl_tpu.fl.local_training import \
    FederatedTrainingConfig as JaxTrainingConfig
from fl_tpu.models import create_model as jax_create_model
from fl_tpu_torch.core.mesh import ClientMesh
from fl_tpu_torch.data.federated import FederatedArrays
from fl_tpu_torch.fl import FedDFConfig, FedDFEngine
from fl_tpu_torch.fl.feddf import proxy_indices
from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
from fl_tpu_torch.models import create_model, params_from_flax, params_to_flax

C, N, B = 4, 16, 8
TRAIN = dict(local_epochs=2, batch_size=N, learning_rate=0.05,
             optimizer_type="sgd", momentum=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pieces(C=C, n=N, seed=11):
    """Two populations (labels y + 5 mod 10 on the second half), so that
    the ensemble and the averaged model disagree; a test set."""
    xtr, ytr, xte, yte = synthetic_mnist(n_train=C * n, n_test=64,
                                         seed=seed)
    labels = ytr.reshape(C, n).astype(np.int32)
    labels[C // 2:] = (labels[C // 2:] + 5) % 10
    return dict(images=xtr.reshape(C, n, 28, 28, 1), labels=labels,
                num_samples=np.full(C, n, np.int32),
                mean=np.asarray([0.1307], np.float32),
                std=np.asarray([0.3081], np.float32),
                num_classes=10), xte, yte


def proxy_images(n=2 * B, seed=7, identical=False):
    x, _, _, _ = synthetic_mnist(n_train=n, n_test=1, seed=seed)
    x = x.reshape(n, 28, 28, 1)
    return np.repeat(x[:1], n, 0) if identical else x


def port_arrays(p):
    return FederatedArrays(**{k: (v.copy() if isinstance(v, np.ndarray)
                                  else v) for k, v in p.items()})


def engines(proxy, **cfg):
    """Both engines on the same data and proxy set, the port's from the
    reference's init."""
    p, _, _ = pieces()
    jeng = JaxEngine(jax_create_model("simple_cnn", dropout_rate=0.0,
                                      fused_conv_block="residual"),
                     JaxArrays(**p), proxy,
                     JaxConfig(training=JaxTrainingConfig(**TRAIN), **cfg))
    teng = FedDFEngine(create_model("simple_cnn", dropout_rate=0.0,
                                    fused_conv_block="residual"),
                       port_arrays(p), proxy,
                       FedDFConfig(training=FederatedTrainingConfig(**TRAIN),
                                   **cfg), device="cpu")
    teng.global_variables = {"params": params_from_flax(
        jax.device_get(jeng.global_variables["params"]))}
    return jeng, teng


def close(jeng, teng, rtol, atol):
    want = jax.device_get(jeng.global_variables["params"])
    got = params_to_flax(teng.global_variables["params"])
    for layer in want:
        for k in want[layer]:
            np.testing.assert_allclose(got[layer][k], want[layer][k],
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{layer}/{k}")


def test_zero_distill_steps_is_the_reference_fedavg():
    jeng, teng = engines(proxy_images(), distill_steps=0, seed=0)
    for _ in range(2):
        jr, tr = jeng.run_round(), teng.run_round()
        assert tr.distill_kl_before == tr.distill_kl_after == 0.0
        assert jr.distill_kl_before == 0.0
        for name in ("train_loss", "train_accuracy"):
            assert getattr(tr, name) == pytest.approx(getattr(jr, name),
                                                      rel=1e-5)
        close(jeng, teng, 2e-5, 2e-6)


def test_kl_before_equals_the_reference():
    """The probe batch is the proxy set's first images, whatever the
    index draws: the KL at the FedAvg init is the reference's."""
    jeng, teng = engines(proxy_images(), distill_steps=1, distill_batch=B,
                         seed=0)
    jr, tr = jeng.run_round(), teng.run_round()
    assert jr.distill_kl_before > 1e-4
    assert tr.distill_kl_before == pytest.approx(jr.distill_kl_before,
                                                 rel=1e-4)


@pytest.mark.parametrize("optimizer,tau", [("adam", 1.0), ("sgd", 2.0)])
def test_distilled_round_equals_the_reference(optimizer, tau):
    jeng, teng = engines(proxy_images(identical=True), distill_steps=4,
                         distill_batch=B, distill_optimizer=optimizer,
                         temperature=tau, seed=0)
    jr, tr = jeng.run_round(), teng.run_round()
    for name in ("distill_kl_before", "distill_kl_after"):
        assert getattr(tr, name) == pytest.approx(getattr(jr, name),
                                                  rel=1e-4)
    # the loop moved the student
    assert tr.distill_kl_after != tr.distill_kl_before
    close(jeng, teng, 2e-4, 2e-5)


def test_proxy_indices_are_uniform_and_in_range():
    size, steps, batch = 10, 64, 256
    idx = proxy_indices(12345, steps, batch, size, "cpu")
    assert idx.shape == (steps, batch)
    assert int(idx.min()) >= 0 and int(idx.max()) < size
    counts = np.bincount(idx.numpy().ravel(), minlength=size)
    expect = steps * batch / size
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 27.88          # chi-square, 9 dof, p = 0.001
    # the same seed draws the same batches; another round's seed others
    assert torch.equal(idx, proxy_indices(12345, steps, batch, size, "cpu"))
    assert not torch.equal(idx, proxy_indices(54321, steps, batch, size,
                                              "cpu"))


def test_evaluate_on_normalized_images_equals_the_reference():
    jeng, teng = engines(proxy_images(), distill_steps=0, seed=0)
    _, xte, yte = pieces()
    x = (xte.astype(np.float32) / 255.0 - 0.1307) / 0.3081
    want = jeng.evaluate(x, yte.astype(np.int32))
    got = teng.evaluate(x, yte)
    assert set(got) == set(want)
    assert float(got["loss"]) == pytest.approx(float(want["loss"]),
                                               rel=1e-5)
    assert float(got["accuracy"]) == pytest.approx(float(want["accuracy"]),
                                                   abs=1e-6)
    np.testing.assert_allclose(got["per_class_accuracy"],
                               np.asarray(want["per_class_accuracy"]),
                               atol=1e-6)


REFUSALS = {
    "not_uint8": (dict(), lambda x: x.astype(np.float32)),
    "shape": (dict(), lambda x: np.zeros((8, 32, 32, 3), np.uint8)),
    "too_small": (dict(distill_steps=4, distill_batch=64), lambda x: x),
    "steps": (dict(distill_steps=-1), lambda x: x),
    "temperature": (dict(temperature=0.0), lambda x: x),
    "optimizer": (dict(distill_optimizer="rmsprop"), lambda x: x),
    "mesh_divides": (dict(distill_steps=0), lambda x: x),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_carry_the_reference_messages(case):
    p, _, _ = pieces()
    kw, proxy = REFUSALS[case]
    jmesh = tmesh = None
    if case == "mesh_divides":
        jmesh = types.SimpleNamespace(devices=np.empty(3))
        tmesh = ClientMesh(group=None, rank=0, world_size=3,
                           device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError) as want:
        JaxEngine(jax_create_model("simple_cnn"), JaxArrays(**p),
                  proxy(proxy_images()), JaxConfig(**kw), mesh=jmesh)
    with pytest.raises(ValueError) as got:
        FedDFEngine(create_model("simple_cnn"), port_arrays(p),
                    proxy(proxy_images()), FedDFConfig(**kw), mesh=tmesh,
                    device=None if tmesh else "cpu")
    assert str(got.value) == str(want.value)


def test_without_a_card_the_engine_raises():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    p, _, _ = pieces()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FedDFEngine(create_model("simple_cnn"), port_arrays(p),
                    proxy_images(), FedDFConfig(distill_batch=B))
