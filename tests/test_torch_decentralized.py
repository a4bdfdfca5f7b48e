"""The port's decentralized engine (D-PSGD, ``fl_tpu_torch.fl.
decentralized``) against the reference's ``fl_tpu.fl.decentralized``.

- Two ring-gossip rounds of both engines (8 clients, 16 images each,
  SimpleCNN in f32 with ``fused_conv_block="residual"``: the reference's
  Pallas kernels in interpret mode, the port's K1/K2 through their plain
  versions), the reference's init carried across, the draws out of the
  comparison (dropout 0, ``samples_per_client == batch_size``), plain
  SGD: every client's model within the reference's own mesh bound (rtol
  2e-5 / atol 2e-6), the metrics and the consensus distance within rtol
  1e-5 (the reference's mesh test holds the distance to 1e-4), the
  evaluations of the mean model and of one client too.
- The complete uniform graph W = 11ᵀ/C equals the port's
  ``FederatedRoundEngine`` within the reference's own bound (rtol 1e-5 /
  atol 1e-7), every client every round; at lr 0 gossip keeps the mean
  model and contracts the consensus distance.
- The mixing-matrix constructors and their validation equal the
  reference's, messages included; a model with ``batch_stats`` and every
  other refusal carry the reference's messages; without a card and
  without ``device="cpu"`` the engine raises.
"""

import types

import numpy as np
import pytest
import torch

import jax
from fl_tpu.data.federated import FederatedArrays as JaxArrays
from fl_tpu.data.synthetic import synthetic_mnist
from fl_tpu.fl import decentralized as jdec
from fl_tpu.fl.local_training import \
    FederatedTrainingConfig as JaxTrainingConfig
from fl_tpu.models import create_model as jax_create_model
from fl_tpu_torch.core.mesh import ClientMesh
from fl_tpu_torch.data.federated import FederatedArrays
from fl_tpu_torch.fl import (
    DecentralizedConfig,
    DecentralizedFederatedEngine,
    metropolis_mixing_matrix,
    ring_mixing_matrix,
    validate_mixing_matrix,
)
from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
from fl_tpu_torch.models import create_model, params_from_flax, params_to_flax
from fl_tpu_torch.orchestration import FederatedRoundEngine, RoundEngineConfig

C, N = 8, 16
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


def pieces(C=C, n=N, seed=11, shape=(28, 28, 1)):
    """The reference's two populations (``tests/test_clustered.py``: the
    second half's labels y + 5 mod 10, so that the ring's neighbours
    disagree), and a test set."""
    xtr, ytr, xte, yte = synthetic_mnist(n_train=C * n, n_test=128,
                                         seed=seed)
    labels = ytr.reshape(C, n).astype(np.int32)
    labels[C // 2:] = (labels[C // 2:] + 5) % 10
    if shape != (28, 28, 1):
        xtr = np.zeros((C * n,) + shape, np.uint8)
    return dict(images=xtr.reshape((C, n) + shape), labels=labels,
                num_samples=np.full(C, n, np.int32),
                mean=np.zeros(shape[-1], np.float32) + 0.1307,
                std=np.zeros(shape[-1], np.float32) + 0.3081,
                num_classes=10), xte, yte


def port_arrays(p):
    return FederatedArrays(**{k: (v.copy() if isinstance(v, np.ndarray)
                                  else v) for k, v in p.items()})


def port_model():
    return create_model("simple_cnn", dropout_rate=0.0,
                        fused_conv_block="residual")


def port_engine(p, **kw):
    kw.setdefault("training", FederatedTrainingConfig(**TRAIN))
    return DecentralizedFederatedEngine(port_model(), port_arrays(p),
                                        DecentralizedConfig(**kw),
                                        device="cpu")


@pytest.fixture(scope="module")
def parity():
    p, _, _ = pieces()
    jeng = jdec.DecentralizedFederatedEngine(
        jax_create_model("simple_cnn", dropout_rate=0.0,
                         fused_conv_block="residual"),
        JaxArrays(**p),
        jdec.DecentralizedConfig(training=JaxTrainingConfig(**TRAIN),
                                 seed=0))
    teng = port_engine(p, seed=0)
    teng.client_variables = {"params": params_from_flax(
        jax.device_get(jeng.client_variables["params"]))}
    rounds = []
    for _ in range(2):
        jr, tr = jeng.run_round(), teng.run_round()
        rounds.append((jr, tr, params_to_flax(teng.client_variables["params"]),
                       jax.device_get(jeng.client_variables["params"])))
    return jeng, teng, rounds


def test_client_models_equal_the_reference_every_round(parity):
    _, _, rounds = parity
    for _, _, got, want in rounds:
        for layer in want:
            for k in want[layer]:
                np.testing.assert_allclose(got[layer][k], want[layer][k],
                                           rtol=2e-5, atol=2e-6,
                                           err_msg=f"{layer}/{k}")


@pytest.mark.parametrize("name", ["train_loss", "train_accuracy",
                                  "consensus_distance"])
def test_round_metrics_equal_the_reference(parity, name):
    _, _, rounds = parity
    for jr, tr, _, _ in rounds:
        assert getattr(tr, name) == pytest.approx(getattr(jr, name),
                                                  rel=1e-5)
    # the ring's neighbours disagree: the models do not reach consensus
    assert rounds[0][1].consensus_distance > 1e-3


@pytest.mark.parametrize("client", [None, 5])
def test_evaluate_equals_the_reference(parity, client):
    jeng, teng, _ = parity
    _, xte, yte = pieces()
    want = jeng.evaluate(xte, yte, client=client)
    got = teng.evaluate(xte, yte, client=client)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-6)


def test_mean_model_equals_the_reference(parity):
    jeng, teng, _ = parity
    want = jax.device_get(jeng.mean_model()["params"])
    got = params_to_flax(teng.mean_model()["params"])
    for layer in want:
        for k in want[layer]:
            np.testing.assert_allclose(got[layer][k], want[layer][k],
                                       rtol=2e-5, atol=2e-6)


def test_client_model_out_of_range_carries_the_reference_message(parity):
    jeng, teng, _ = parity
    with pytest.raises(IndexError) as want:
        jeng.client_model(C)
    with pytest.raises(IndexError) as got:
        teng.client_model(C)
    assert str(got.value) == str(want.value)


def test_complete_uniform_graph_tracks_the_flat_round():
    p, _, _ = pieces()
    flat = FederatedRoundEngine(
        port_model(), port_arrays(p),
        RoundEngineConfig(training=FederatedTrainingConfig(**TRAIN),
                          max_clients=C, seed=0), device="cpu")
    dec = port_engine(p, seed=0, mixing_matrix=np.full((C, C), 1.0 / C))
    for _ in range(2):
        flat.run_round(mask=np.ones(C, np.float32), evaluate=False)
        res = dec.run_round()
        assert res.consensus_distance < 1e-5
        want = flat.global_variables["params"]
        for i in range(C):
            got = dec.client_model(i)["params"]
            for layer in want:
                for k in want[layer]:
                    np.testing.assert_allclose(
                        got[layer][k].numpy(), want[layer][k].numpy(),
                        rtol=1e-5, atol=1e-7, err_msg=f"{i} {layer}/{k}")


def test_gossip_keeps_the_mean_and_contracts():
    """lr 0 isolates the mixing: the mean model is invariant (double
    stochasticity) and the consensus distance shrinks every round."""
    p, _, _ = pieces(C=6)
    eng = port_engine(p, training=FederatedTrainingConfig(
        local_epochs=1, batch_size=N, learning_rate=0.0,
        optimizer_type="sgd"), seed=0)
    g = torch.Generator().manual_seed(7)
    eng.client_variables = {"params": {
        layer: {k: v + 0.1 * torch.randn(v.shape, generator=g)
                for k, v in d.items()}
        for layer, d in eng.client_variables["params"].items()}}
    before = eng.mean_model()["params"]
    dists = [eng.run_round().consensus_distance for _ in range(3)]
    after = eng.mean_model()["params"]
    for layer in before:
        for k in before[layer]:
            np.testing.assert_allclose(after[layer][k].numpy(),
                                       before[layer][k].numpy(),
                                       rtol=1e-4, atol=1e-6)
    assert dists[0] > dists[1] > dists[2]


@pytest.mark.parametrize("C_,w", [(3, 1 / 3), (6, 0.5), (9, 0.2)])
def test_ring_equals_the_reference(C_, w):
    np.testing.assert_array_equal(ring_mixing_matrix(C_, w),
                                  jdec.ring_mixing_matrix(C_, w))


@pytest.mark.parametrize("seed", [0, 1])
def test_metropolis_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    A = rng.random((7, 7)) < 0.4
    A = A | A.T
    np.testing.assert_array_equal(metropolis_mixing_matrix(A),
                                  jdec.metropolis_mixing_matrix(A))
    M = metropolis_mixing_matrix(A)
    np.testing.assert_allclose(M.sum(0), 1.0)
    np.testing.assert_allclose(M.sum(1), 1.0)


MATRIX_REFUSALS = {
    "self_weight": (lambda m: m.ring_mixing_matrix(4, 1.0)),
    "square": (lambda m: m.metropolis_mixing_matrix(np.ones((2, 3)))),
    "symmetric": (lambda m: m.metropolis_mixing_matrix(
        np.asarray([[0, 1], [0, 0]], bool))),
    "shape": (lambda m: m.validate_mixing_matrix(np.eye(3), 4)),
    "negative": (lambda m: m.validate_mixing_matrix(
        np.asarray([[1.5, -0.5], [-0.5, 1.5]]), 2)),
    "rows": (lambda m: m.validate_mixing_matrix(np.eye(3) * 0.5, 3)),
    "columns": (lambda m: m.validate_mixing_matrix(
        np.asarray([[0.5, 0.5], [1.0, 0.0]]), 2)),
}


@pytest.mark.parametrize("case", sorted(MATRIX_REFUSALS))
def test_mixing_refusals_carry_the_reference_messages(case):
    from fl_tpu_torch.fl import decentralized as tdec

    with pytest.raises(ValueError) as want:
        MATRIX_REFUSALS[case](jdec)
    with pytest.raises(ValueError) as got:
        MATRIX_REFUSALS[case](tdec)
    assert str(got.value) == str(want.value)
    assert validate_mixing_matrix(np.full((3, 3), 1 / 3), 3).dtype == \
        np.float64


def test_engine_refusals_carry_the_reference_messages():
    """A mixing matrix of the wrong size, a model with batch statistics,
    and a client count the mesh does not divide."""
    p, _, _ = pieces(C=4, n=4)
    cases = [(dict(mixing_matrix=np.eye(3)), "simple_cnn", p, None)]
    pc, _, _ = pieces(C=4, n=4, shape=(32, 32, 3))
    cases.append(({}, "cifar10_cnn", pc, None))
    cases.append(({}, "simple_cnn", p, 3))
    for kw, name, data, world in cases:
        jmesh = tmesh = None
        if world:
            jmesh = types.SimpleNamespace(devices=np.empty(world))
            tmesh = ClientMesh(group=None, rank=0, world_size=world,
                               device=torch.device("cpu"), backend="gloo")
        with pytest.raises(ValueError) as want:
            jdec.DecentralizedFederatedEngine(
                jax_create_model(name), JaxArrays(**data),
                jdec.DecentralizedConfig(**kw), mesh=jmesh)
        with pytest.raises(ValueError) as got:
            DecentralizedFederatedEngine(
                create_model(name), port_arrays(data),
                DecentralizedConfig(**kw), mesh=tmesh,
                device=None if tmesh else "cpu")
        assert str(got.value) == str(want.value), name


def test_without_a_card_the_engine_raises():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    p, _, _ = pieces(C=4, n=4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        DecentralizedFederatedEngine(create_model("simple_cnn"),
                                     port_arrays(p), DecentralizedConfig())
