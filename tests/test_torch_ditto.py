"""The port's Ditto personalizer (``fl_tpu_torch.fl.ditto``) and its
checkpoint, against the reference's ``fl_tpu.fl.ditto``.

- Two Ditto steps on both sides with SimpleCNN in f32 (``"residual"`` on
  both: the reference's Pallas kernels in interpret mode, the port's K1/K2
  through their plain versions), each after a JAX engine round whose
  global model is carried into the port's engine, so that both steps pull
  toward the same θ_g: the personal models within rtol 1e-5 / atol 1e-6,
  the step metrics and ``evaluate_personal`` within rtol 1e-5. The draws
  are out of the comparison (dropout 0, ``samples_per_client ==
  batch_size``), plain SGD.
- Once with CIFAR10CNN's BatchNorm: the personal ``batch_stats`` travel
  through the trainer's ``extra=`` and equal the reference's after one
  step (rtol 1e-5 / atol 1e-6); its params at the CIFAR engine test's f32
  rule, at least 99.9% of the elements within that tolerance, since the
  reference's own f32 BatchNorm gradient lies ~1e-3 relative from float64
  at 16 images (``tests/test_torch_cifar.py``), and every element within
  lr·1e-2.
- The port's copy of the reference's oracle: with one full-batch SGD step
  the update is v − η(∇L(v) + λ(v − θ_g)); the λ limits; the gain on a
  label-permuted population; a FedProx global objective composing.
- The step's stream differs from ``evaluate_personalized``'s; the
  refusals carry the reference's messages; the personal models live on the
  engine's device; the checkpoint pair resumes bit for bit and refuses a
  foreign kind before any array loads.
"""

import numpy as np
import pytest
import torch

import jax
from fl_tpu.data.federated import FederatedArrays as JaxArrays
from fl_tpu.data.synthetic import synthetic_mnist
from fl_tpu.fl.ditto import DittoPersonalizer as JaxDitto
from fl_tpu.fl.local_training import \
    FederatedTrainingConfig as JaxTrainingConfig
from fl_tpu.models import create_model as jax_create_model
from fl_tpu.orchestration import FederatedRoundEngine as JaxEngine
from fl_tpu.orchestration import RoundEngineConfig as JaxConfig
from fl_tpu_torch.core import prng
from fl_tpu_torch.core.pytree import flatten_dict, tree_map
from fl_tpu_torch.data.federated import FederatedArrays
from fl_tpu_torch.fl import DittoPersonalizer
from fl_tpu_torch.fl.ditto import step_seed
from fl_tpu_torch.fl.local_training import (
    FederatedTrainingConfig,
    cross_entropy_loss,
)
from fl_tpu_torch.models import create_model, variables_from_flax
from fl_tpu_torch.orchestration import FederatedRoundEngine, RoundEngineConfig
from fl_tpu_torch.orchestration.checkpoint import (
    CheckpointManager,
    restore_ditto_checkpoint,
    save_clustered_checkpoint,
    save_ditto_checkpoint,
)

TRAIN = dict(local_epochs=2, batch_size=16, learning_rate=0.05,
             optimizer_type="sgd", momentum=0.0)
LAM = 0.2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def data_pieces(C=4, n=16, seed=0, permute_half=False):
    xtr, ytr, _, _ = synthetic_mnist(n_train=C * n, n_test=1, seed=seed)
    labels = ytr.reshape(C, n).astype(np.int32)
    if permute_half:
        labels[C // 2:] = (labels[C // 2:] + 5) % 10
    return dict(images=xtr.reshape(C, n, 28, 28, 1), labels=labels,
                num_samples=np.full(C, n, np.int32),
                mean=np.asarray([0.1307], np.float32),
                std=np.asarray([0.3081], np.float32), num_classes=10)


def port_engine(pieces, model=None, **train):
    return FederatedRoundEngine(
        model or create_model("simple_cnn", dropout_rate=0.0,
                              fused_conv_block="residual"),
        FederatedArrays(**{k: (v.copy() if isinstance(v, np.ndarray) else v)
                           for k, v in pieces.items()}),
        RoundEngineConfig(training=FederatedTrainingConfig(
            **dict(TRAIN, **train)), seed=0), device="cpu")


def carry(jeng, teng):
    """The JAX engine's global variables into the port's engine."""
    teng.global_variables = variables_from_flax(
        jax.device_get(jeng.global_variables))


def flat(tree):
    return {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v,
                          np.float32)
            for k, v in flatten_dict(tree).items()}


@pytest.fixture(scope="module")
def parity():
    pieces = data_pieces()
    jeng = JaxEngine(jax_create_model("simple_cnn", dropout_rate=0.0,
                                      fused_conv_block="residual"),
                     JaxArrays(**pieces),
                     JaxConfig(training=JaxTrainingConfig(**TRAIN), seed=0))
    teng = port_engine(pieces)
    carry(jeng, teng)
    jd, td = JaxDitto(jeng, lam=LAM), DittoPersonalizer(teng, lam=LAM)
    steps = []
    for _ in range(2):
        jeng.run_round(evaluate=False)
        carry(jeng, teng)
        steps.append((jd.step(), td.step()))
    return jd, td, steps, (jd.evaluate_personal(), td.evaluate_personal())


def test_personal_models_equal_the_reference(parity):
    jd, td, _, _ = parity
    want = flat(jax.device_get(jd.personal_variables))
    got = flat(td.personal_variables)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["personal_loss", "personal_accuracy"])
def test_step_metrics_equal_the_reference(parity, name):
    _, _, steps, _ = parity
    for jm, tm in steps:
        assert tm[name] == pytest.approx(jm[name], rel=1e-5)


@pytest.mark.parametrize("name", ["personal_accuracy", "global_accuracy",
                                  "personalization_gain"])
def test_evaluate_personal_equals_the_reference(parity, name):
    _, _, _, (want, got) = parity
    assert got[name] == pytest.approx(want[name], rel=1e-5, abs=1e-6)
    for k in ("loss", "accuracy", "n"):
        np.testing.assert_allclose(got["per_client"][k],
                                   np.asarray(want["per_client"][k]),
                                   rtol=1e-5, err_msg=k)


def test_batch_stats_travel_through_the_personal_step():
    """CIFAR10CNN (BatchNorm): one Ditto step's personal params and
    running statistics against the reference's."""
    from fl_tpu.data import load_dataset as jax_load_dataset
    from fl_tpu.data import make_federated_arrays as jax_make_arrays
    from fl_tpu_torch.data import load_dataset, make_federated_arrays

    kw = dict(num_clients=2, strategy="iid", samples_per_client=16, seed=0)
    train = dict(TRAIN, local_epochs=1, learning_rate=0.01)
    jeng = JaxEngine(
        jax_create_model("cifar10_cnn", dropout_rate=0.0),
        jax_make_arrays(jax_load_dataset("cifar10", n_train_synth=32,
                                         n_test_synth=8), **kw),
        JaxConfig(training=JaxTrainingConfig(**train), seed=0))
    teng = FederatedRoundEngine(
        create_model("cifar10_cnn", dropout_rate=0.0),
        make_federated_arrays(load_dataset("cifar10", n_train_synth=32,
                                           n_test_synth=8), **kw),
        RoundEngineConfig(training=FederatedTrainingConfig(**train), seed=0),
        device="cpu")
    carry(jeng, teng)
    jd, td = JaxDitto(jeng, lam=LAM), DittoPersonalizer(teng, lam=LAM)
    jd.step()
    td.step()
    want = flat(jax.device_get(jd.personal_variables))
    got = flat(td.personal_variables)
    assert any(k.startswith("batch_stats/") for k in got)
    assert got.keys() == want.keys()
    within = total = 0
    for k in want:
        if k.startswith("batch_stats/"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
            continue
        gap = np.abs(got[k] - want[k])
        within += int((gap <= 1e-6 + 1e-5 * np.abs(want[k])).sum())
        total += gap.size
        assert gap.max() <= train["learning_rate"] * 1e-2, (k, gap.max())
    assert within >= 0.999 * total, within / total


def test_one_full_batch_step_is_the_oracle():
    """batch = the whole shard, one epoch, plain SGD: the update is v −
    η(∇L(v; shard) + λ(v − θ_g)) (the decomposition into FedProx at the
    start plus a constant correction is an identity)."""
    lam, lr, n = 0.3, 0.05, 32
    pieces = data_pieces(C=2, n=n)
    eng = port_engine(pieces, local_epochs=1, batch_size=n, learning_rate=lr)
    eng.run_round(evaluate=False)          # θ_g ≠ the init
    ditto = DittoPersonalizer(eng, lam=lam)
    with torch.no_grad():                  # v_0 ≠ θ_g
        for leaf in ditto.personal_variables["params"].values():
            for t in leaf.values():
                t[0] += 0.05
    v_before = [tree_map(torch.clone, ditto.personal_model(c))
                for c in range(2)]
    ditto.step()
    g_params = eng.global_variables["params"]
    for c in range(2):
        x = ((torch.as_tensor(pieces["images"][c:c + 1]).float() / 255.0
              - 0.1307) / 0.3081)
        y = torch.as_tensor(pieces["labels"][c:c + 1], dtype=torch.int64)
        params = tree_map(lambda t: t[None].clone().requires_grad_(True),
                          v_before[c]["params"])
        leaves = [t for d in params.values() for t in d.values()]
        loss = cross_entropy_loss(eng.model(params, x, train=False), y)
        grads = dict(zip(map(id, leaves),
                         torch.autograd.grad(loss.sum(), leaves)))
        got = ditto.personal_model(c)["params"]
        for layer, d in params.items():
            for k, p in d.items():
                want = (p[0] - lr * (grads[id(p)][0] + lam * (
                    p[0] - g_params[layer][k]))).detach()
                np.testing.assert_allclose(got[layer][k].numpy(),
                                           want.numpy(), rtol=2e-5,
                                           atol=1e-6)


def test_lambda_pins_the_personal_models():
    """Large λ keeps the personal models near the global one, λ = 0 lets
    them wander (η·λ < 2 keeps the pull a contraction)."""
    pieces = data_pieces(C=4, n=32)
    eng = port_engine(pieces)
    eng.run_round(evaluate=False)

    def drift(lam):
        d = DittoPersonalizer(eng, lam=lam)
        for _ in range(3):
            d.step()
        personal, glob = flat(d.personal_variables), flat(
            eng.global_variables)
        sq = sum(float(((personal[k].astype(np.float64) - glob[k][None])
                        ** 2).sum()) for k in glob)
        return sq ** 0.5

    assert drift(10.0) < 0.5 * drift(0.0)


class TinyDense(torch.nn.Module):
    """The reference's one-layer model, in the port's model interface."""

    def init(self, generator, device):
        return {"fc": {"kernel": torch.randn((784, 10), generator=generator,
                                             device=device) / 28.0,
                       "bias": torch.zeros(10, device=device)}}

    def forward(self, params, x, *, train=False, generator=None):
        Cx, B = x.shape[:2]
        return (torch.bmm(x.reshape(Cx, B, -1).float(),
                          params["fc"]["kernel"])
                + params["fc"]["bias"][:, None])


def test_personalization_gain_on_a_permuted_population():
    """Label-permuted halves: the global model cannot serve both cohorts,
    the personal models can."""
    eng = port_engine(data_pieces(C=4, n=64, permute_half=True),
                      model=TinyDense())
    ditto = DittoPersonalizer(eng, lam=0.05)
    for _ in range(4):
        eng.run_round(evaluate=False)
        ditto.step()
    out = ditto.evaluate_personal()
    assert out["personal_accuracy"] > out["global_accuracy"] + 0.1
    assert out["personalization_gain"] == pytest.approx(
        out["personal_accuracy"] - out["global_accuracy"])
    assert out["per_client"]["accuracy"].shape == (4,)


def test_a_fedprox_global_objective_composes():
    eng = port_engine(data_pieces(), proximal_mu=0.5, local_epochs=1)
    ditto = DittoPersonalizer(eng, lam=0.1)
    eng.run_round(evaluate=False)
    assert np.isfinite(ditto.step()["personal_loss"])


def test_step_stream_differs_from_personalized_evaluation():
    """``step`` at counter r and ``evaluate_personalized`` at round r must
    not share streams (the reference's regression)."""
    root = prng.root_seed(0)
    for r in range(4):
        eval_seed = prng.stream_seed(prng.round_seed(root, r),
                                     prng.Stream.PERSONALIZE)
        assert step_seed(root, r) != eval_seed
        assert step_seed(root, r) == prng.fold(eval_seed, 0xD1770)


def test_refusals_carry_the_reference_messages(parity):
    jd, td, _, _ = parity
    with pytest.raises(ValueError) as want:
        JaxDitto(jd.engine, lam=-1.0)
    with pytest.raises(ValueError) as got:
        DittoPersonalizer(td.engine, lam=-1.0)
    assert str(got.value) == str(want.value)
    with pytest.raises(IndexError) as want:
        jd.personal_model(4)
    with pytest.raises(IndexError) as got:
        td.personal_model(4)
    assert str(got.value) == str(want.value)


def test_personal_models_live_on_the_engines_device(parity):
    _, td, _, _ = parity
    assert all(t.device == td.engine.device
               for t in flat_tensors(td.personal_variables))


def flat_tensors(tree):
    return [v for _, v in sorted(flatten_dict(tree).items())]


def test_checkpoint_resumes_bit_for_bit(tmp_path):
    pieces = data_pieces()
    ref = DittoPersonalizer(port_engine(pieces), lam=LAM)
    for _ in range(4):
        ref.step()
    d = DittoPersonalizer(port_engine(pieces), lam=LAM)
    d.step()
    d.step()
    save_ditto_checkpoint(d, str(tmp_path))
    resumed = DittoPersonalizer(port_engine(pieces), lam=LAM)
    assert restore_ditto_checkpoint(resumed, str(tmp_path)) == 2
    resumed.step()
    resumed.step()
    for a, b in zip(flat_tensors(ref.personal_variables),
                    flat_tensors(resumed.personal_variables)):
        assert torch.equal(a, b)


def test_checkpoint_refuses_a_foreign_kind_before_loading(tmp_path,
                                                          monkeypatch):
    from fl_tpu_torch.fl import ClusteredConfig, ClusteredFederatedEngine

    pieces = data_pieces()
    cl = ClusteredFederatedEngine(
        create_model("simple_cnn"),
        FederatedArrays(**pieces),
        ClusteredConfig(training=FederatedTrainingConfig(**dict(
            TRAIN, local_epochs=1)), num_clusters=2), device="cpu")
    cl.run_round()
    save_clustered_checkpoint(cl, str(tmp_path))
    d = DittoPersonalizer(port_engine(pieces), lam=LAM)

    def no_load(*args, **kwargs):
        raise AssertionError("an array loaded before the kind check")

    monkeypatch.setattr(CheckpointManager, "load_arrays", no_load)
    with pytest.raises(ValueError, match="does not hold a ditto checkpoint"):
        restore_ditto_checkpoint(d, str(tmp_path))


def test_personal_epochs_override_the_engines():
    """personal_epochs=1 over a 3-epoch engine trains as a 1-epoch
    engine's Ditto does, bit for bit."""
    pieces = data_pieces()
    short = DittoPersonalizer(port_engine(pieces, local_epochs=3), lam=LAM,
                              personal_epochs=1)
    plain = DittoPersonalizer(port_engine(pieces, local_epochs=1), lam=LAM)
    short.step()
    plain.step()
    for a, b in zip(flat_tensors(short.personal_variables),
                    flat_tensors(plain.personal_variables)):
        assert torch.equal(a, b)
