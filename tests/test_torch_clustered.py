"""The port's clustered engine (IFCA, ``fl_tpu_torch.fl.clustered``) and
its checkpoint, against the reference's ``fl_tpu.fl.clustered``.

- Two rounds of both engines on the reference's label-permuted halves
  (``tests/test_clustered.py``) with SimpleCNN in f32: the reference's k
  warm-started inits carried across (``params_from_flax``; the init streams
  differ by construction), the draws out of the comparison (dropout 0,
  ``samples_per_client == batch_size``), plain SGD. The assignments and
  cluster sizes equal, the cluster models within the reference's own mesh
  bound (rtol 2e-5 / atol 2e-6), the metrics within rtol 1e-5. Both train
  ``fused_conv_block="residual"`` (the reference's Pallas kernels in
  interpret mode, the port's K1/K2 through their plain versions); against
  the reference's unfused model the port's weights stray up to 3e-4
  relative after two rounds at lr 0.1.
- The port's invariants: k = 1 gives every client cluster 0; a cluster
  nobody adopts passes the round bit for bit; the populations separate
  with ``warmstart_clients`` (the reference's purity test, on a tiny MLP
  in the port's model interface); every refusal carries the reference's
  message; without a card and without ``device="cpu"`` the engine raises.
- The checkpoint pair resumes bit for bit, and a k mismatch is refused
  before any array loads.
"""

import types

import numpy as np
import pytest
import torch

import jax
from fl_tpu.data.federated import FederatedArrays as JaxArrays
from fl_tpu.data.synthetic import synthetic_mnist
from fl_tpu.fl.clustered import ClusteredConfig as JaxConfig
from fl_tpu.fl.clustered import ClusteredFederatedEngine as JaxEngine
from fl_tpu.fl.local_training import \
    FederatedTrainingConfig as JaxTrainingConfig
from fl_tpu.models import create_model as jax_create_model
from fl_tpu_torch.core.mesh import ClientMesh
from fl_tpu_torch.data.federated import FederatedArrays
from fl_tpu_torch.fl import ClusteredConfig, ClusteredFederatedEngine
from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
from fl_tpu_torch.models import create_model, params_from_flax, params_to_flax
from fl_tpu_torch.orchestration.checkpoint import (
    CheckpointManager,
    restore_clustered_checkpoint,
    save_clustered_checkpoint,
)

C, N = 8, 16
TRAIN = dict(local_epochs=2, batch_size=N, learning_rate=0.05,
             optimizer_type="sgd")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def two_population(C=C, n=N, seed=11):
    """The reference's two populations: clients C/2.. carry the label
    permutation y + 5 mod 10. Returns the numpy pieces and the test set."""
    xtr, ytr, xte, yte = synthetic_mnist(n_train=C * n, n_test=128,
                                         seed=seed)
    labels = ytr.reshape(C, n).astype(np.int32)
    labels[C // 2:] = (labels[C // 2:] + 5) % 10
    pieces = dict(images=xtr.reshape(C, n, 28, 28, 1), labels=labels,
                  num_samples=np.full(C, n, np.int32),
                  mean=np.asarray([0.1307], np.float32),
                  std=np.asarray([0.3081], np.float32), num_classes=10)
    return pieces, xte, yte


def port_arrays(pieces):
    return FederatedArrays(**{k: (v.copy() if isinstance(v, np.ndarray)
                                  else v) for k, v in pieces.items()})


class TinyMLP(torch.nn.Module):
    """The reference tests' MLP (784 → 32 → 10), in the port's model
    interface, with a seeded normal init."""

    def init(self, generator, device):
        def dense(i, o):
            return {"kernel": torch.randn((i, o), generator=generator,
                                          device=device) / i ** 0.5,
                    "bias": torch.zeros(o, device=device)}
        return {"fc1": dense(784, 32), "fc2": dense(32, 10)}

    def forward(self, params, x, *, train=False, generator=None):
        Cx, B = x.shape[:2]
        h = torch.relu(torch.bmm(x.reshape(Cx, B, -1).float(),
                                 params["fc1"]["kernel"])
                       + params["fc1"]["bias"][:, None])
        return (torch.bmm(h, params["fc2"]["kernel"])
                + params["fc2"]["bias"][:, None])


def port_config(**kw):
    kw.setdefault("training", FederatedTrainingConfig(**TRAIN))
    return ClusteredConfig(**kw)


def port_engine(pieces, model=None, **kw):
    return ClusteredFederatedEngine(
        model or create_model("simple_cnn", dropout_rate=0.0,
                              fused_conv_block="residual"),
        port_arrays(pieces), port_config(**kw), device="cpu")


@pytest.fixture(scope="module")
def parity():
    """Two rounds of both engines from the reference's warm-started
    inits."""
    pieces, _, _ = two_population()
    cfg = dict(num_clusters=2, seed=0, warmstart_clients=(0, 7))
    jeng = JaxEngine(jax_create_model("simple_cnn", dropout_rate=0.0,
                                      fused_conv_block="residual"),
                     JaxArrays(**pieces),
                     JaxConfig(training=JaxTrainingConfig(**TRAIN), **cfg))
    teng = port_engine(pieces, **cfg)
    teng.cluster_variables = {"params": params_from_flax(
        jax.device_get(jeng.cluster_variables["params"]))}
    rounds = []
    for _ in range(2):
        jr, tr = jeng.run_round(), teng.run_round()
        rounds.append((jr, tr, np.asarray(jeng.assignments),
                       teng.assignments.copy()))
    return jeng, teng, rounds


def test_assignments_and_sizes_equal_the_reference(parity):
    _, _, rounds = parity
    for jr, tr, ja, ta in rounds:
        np.testing.assert_array_equal(ta, ja)
        assert tr.cluster_sizes == jr.cluster_sizes
    # the halves are told apart, so the argmin is no near-tie
    assert len(set(rounds[-1][3].tolist())) == 2


@pytest.mark.parametrize("name", ["train_loss", "train_accuracy",
                                  "assignment_loss"])
def test_round_metrics_equal_the_reference(parity, name):
    _, _, rounds = parity
    for jr, tr, _, _ in rounds:
        assert getattr(tr, name) == pytest.approx(getattr(jr, name),
                                                  rel=1e-5)


def test_cluster_models_equal_the_reference(parity):
    jeng, teng, _ = parity
    want = jax.device_get(jeng.cluster_variables["params"])
    got = params_to_flax(teng.cluster_variables["params"])
    for layer in want:
        for k in want[layer]:
            np.testing.assert_allclose(got[layer][k], want[layer][k],
                                       rtol=2e-5, atol=2e-6)


def test_evaluate_clusters_equals_the_reference(parity):
    jeng, teng, _ = parity
    _, xte, yte = two_population()
    for j, t in zip(jeng.evaluate_clusters(xte, yte),
                    teng.evaluate_clusters(xte, yte)):
        assert t["cluster"] == j["cluster"]
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-5)
        assert t["accuracy"] == pytest.approx(j["accuracy"], abs=1e-6)


def test_single_cluster_takes_every_client():
    pieces, _, _ = two_population(C=4)
    eng = port_engine(pieces, num_clusters=1)
    res = eng.run_round()
    assert res.cluster_sizes == [4]
    assert np.all(eng.assignments == 0)


def test_empty_cluster_passes_the_round_bit_for_bit():
    """Two clients with the same shard adopt the same cluster (the
    reference's construction); the other cluster's model must come through
    the round bit for bit."""
    pieces, _, _ = two_population()
    pieces["images"][1] = pieces["images"][0]
    pieces["labels"][1] = pieces["labels"][0]
    two = {k: (v[:2] if k in ("images", "labels", "num_samples") else v)
           for k, v in pieces.items()}
    eng = port_engine(two, num_clusters=2, seed=3)
    before = [{k: v.clone() for k, v in
               eng.cluster_model(j)["params"]["fc2"].items()}
              for j in range(2)]
    res = eng.run_round()
    (empty,) = [j for j, s in enumerate(res.cluster_sizes) if s == 0]
    for j in range(2):
        after = eng.cluster_model(j)["params"]["fc2"]["kernel"]
        assert torch.equal(after, before[j]["kernel"]) == (j == empty)


def test_a_duplicated_model_is_never_adopted():
    """Ties go to the first index: a copy of cluster 0 placed at cluster 1
    is adopted by nobody and stays bit for bit."""
    pieces, _, _ = two_population()
    eng = port_engine(pieces, num_clusters=2)
    eng.cluster_variables = {"params": {
        layer: {k: torch.stack([v[0], v[0]]) for k, v in d.items()}
        for layer, d in eng.cluster_variables["params"].items()}}
    copy = {layer: {k: v[1].clone() for k, v in d.items()}
            for layer, d in eng.cluster_variables["params"].items()}
    res = eng.run_round()
    assert res.cluster_sizes == [C, 0]
    for layer, d in copy.items():
        for k, v in d.items():
            assert torch.equal(eng.cluster_variables["params"][layer][k][1],
                               v)


def test_warmstarted_ifca_separates_the_populations():
    """The reference's purity test on the tiny MLP: with one seed client
    a population, every client joins its population's cluster and each
    cluster serves its own labelling best."""
    pieces, xte, yte = two_population(n=64)
    eng = port_engine(pieces, model=TinyMLP(), num_clusters=2, seed=0,
                      warmstart_clients=(0, 7),
                      training=FederatedTrainingConfig(
                          local_epochs=3, batch_size=16, learning_rate=0.05,
                          optimizer_type="sgd"))
    results = eng.run(4)
    a = eng.assignments
    assert len(set(a[:4])) == 1 and len(set(a[4:])) == 1 and a[0] != a[7]
    assert results[-1].cluster_sizes == [4, 4]
    assert results[-1].assignment_loss < results[0].assignment_loss
    ca, cb = int(a[0]), int(a[7])
    ev_a = eng.evaluate_clusters(xte, yte)
    ev_b = eng.evaluate_clusters(xte, (yte + 5) % 10)
    assert ev_a[ca]["accuracy"] > ev_a[cb]["accuracy"]
    assert ev_b[cb]["accuracy"] > ev_b[ca]["accuracy"]


REFUSALS = {
    "k0": dict(num_clusters=0),
    "k_over_c": dict(num_clusters=5),
    "warmstart_count": dict(num_clusters=2, warmstart_clients=(0,)),
    "warmstart_range": dict(num_clusters=2, warmstart_clients=(0, 9)),
    "mesh_divides": dict(num_clusters=2),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_carry_the_reference_messages(case):
    pieces, _, _ = two_population(C=4)
    kw = REFUSALS[case]
    jmesh = tmesh = None
    if case == "mesh_divides":
        jmesh = types.SimpleNamespace(devices=np.empty(3))
        tmesh = ClientMesh(group=None, rank=0, world_size=3,
                           device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError) as want:
        JaxEngine(jax_create_model("simple_cnn"), JaxArrays(**pieces),
                  JaxConfig(**kw), mesh=jmesh)
    with pytest.raises(ValueError) as got:
        ClusteredFederatedEngine(create_model("simple_cnn"),
                                 port_arrays(pieces), ClusteredConfig(**kw),
                                 mesh=tmesh, device=None if tmesh else "cpu")
    assert str(got.value) == str(want.value)


def test_cluster_model_out_of_range_carries_the_reference_message(parity):
    jeng, teng, _ = parity
    with pytest.raises(IndexError) as want:
        jeng.cluster_model(2)
    with pytest.raises(IndexError) as got:
        teng.cluster_model(2)
    assert str(got.value) == str(want.value)


def test_without_a_card_the_engine_raises():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    pieces, _, _ = two_population(C=4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ClusteredFederatedEngine(create_model("simple_cnn"),
                                 port_arrays(pieces), port_config())


def test_checkpoint_resumes_bit_for_bit(tmp_path):
    pieces, _, _ = two_population(C=4)
    cfg = dict(num_clusters=2, seed=0, warmstart_clients=(0, 3))
    ref = port_engine(pieces, **cfg)
    ref.run(4)
    eng = port_engine(pieces, **cfg)
    eng.run(2)
    save_clustered_checkpoint(eng, str(tmp_path))
    resumed = port_engine(pieces, **cfg)
    assert restore_clustered_checkpoint(resumed, str(tmp_path)) == 2
    np.testing.assert_array_equal(resumed.assignments, eng.assignments)
    resumed.run(2)
    assert resumed.round_number == ref.round_number
    np.testing.assert_array_equal(resumed.assignments, ref.assignments)
    for layer, d in ref.cluster_variables["params"].items():
        for k, v in d.items():
            assert torch.equal(resumed.cluster_variables["params"][layer][k],
                               v)


def test_checkpoint_refuses_another_k_before_loading(tmp_path, monkeypatch):
    pieces, _, _ = two_population(C=4)
    eng = port_engine(pieces, num_clusters=2)
    eng.run_round()
    save_clustered_checkpoint(eng, str(tmp_path))
    other = port_engine(pieces, num_clusters=3)

    def no_load(*args, **kwargs):
        raise AssertionError("an array loaded before the k check")

    monkeypatch.setattr(CheckpointManager, "load_arrays", no_load)
    with pytest.raises(ValueError, match="checkpoint holds 2 clusters; "
                                         "engine configured for 3"):
        restore_clustered_checkpoint(other, str(tmp_path))
