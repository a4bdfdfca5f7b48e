"""The port's FedBuff engine (``fl_tpu_torch.fl.async_fl``), the trainer's
per-row streams it rests on, and its checkpoint, against the reference's
``fl_tpu.fl.async_fl``.

- Four server steps of both engines with lognormal durations and a small
  ring (cancellations happen): the client ids, staleness, simulated clock
  and cancelled attempts equal the reference's exactly; the newest model,
  the reference's init carried into every ring slot, within rtol 2e-5 /
  atol 2e-6 (SimpleCNN in f32, ``"residual"`` on both sides, SGD, dropout
  0 and ``samples_per_client == batch_size``: the reference's streams are
  its own).
- The port's invariant: with a full buffer and unit durations every
  server step is one round of the port's own ``FederatedRoundEngine``,
  with the shuffle and dropout live (batch < shard), within rtol 1e-5 /
  atol 1e-7: attempt a of client c draws what round a draws.
- The trainer's rows from several rounds (``rows=(ids, total)`` with a
  round seed a row) draw each round's streams bit for bit: the rows of two
  rounds in a shuffled order equal those rows of the two rounds' own
  calls, with dropout and bf16 parameter storage (the rounding seeds).
- The reference's buffer, staleness and eviction behaviours on a tiny MLP;
  the refusals with the reference's messages; without a card the engine
  raises; the checkpoint pair resumes bit for bit and refuses a foreign
  kind before any array loads.
"""

import types

import numpy as np
import pytest
import torch

import jax
from fl_tpu.data.federated import FederatedArrays as JaxArrays
from fl_tpu.data.synthetic import synthetic_mnist
from fl_tpu.fl.async_fl import AsyncConfig as JaxConfig
from fl_tpu.fl.async_fl import AsyncFederatedEngine as JaxEngine
from fl_tpu.fl.local_training import \
    FederatedTrainingConfig as JaxTrainingConfig
from fl_tpu.models import create_model as jax_create_model
from fl_tpu_torch.core import prng
from fl_tpu_torch.core.mesh import ClientMesh
from fl_tpu_torch.core.pytree import flatten_dict, tree_map
from fl_tpu_torch.data.federated import FederatedArrays
from fl_tpu_torch.fl import (
    AsyncConfig,
    AsyncFederatedEngine,
    ClusteredConfig,
    ClusteredFederatedEngine,
)
from fl_tpu_torch.fl.local_training import (
    FederatedTrainingConfig,
    make_local_train_fn,
)
from fl_tpu_torch.models import create_model, params_from_flax, params_to_flax
from fl_tpu_torch.orchestration import FederatedRoundEngine, RoundEngineConfig
from fl_tpu_torch.orchestration.checkpoint import (
    CheckpointManager,
    restore_async_checkpoint,
    save_async_checkpoint,
    save_clustered_checkpoint,
)

N = 16
TRAIN = dict(local_epochs=2, batch_size=N, learning_rate=0.05,
             optimizer_type="sgd")
TIMELINE = dict(buffer_size=2, max_staleness=1, seed=1,
                staleness_exponent=0.5, duration_sigma=0.5,
                heterogeneity_sigma=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def data_pieces(C=6, n=N, seed=0):
    xtr, ytr, xte, yte = synthetic_mnist(n_train=C * n, n_test=128,
                                         seed=seed)
    pieces = dict(images=xtr.reshape(C, n, 28, 28, 1),
                  labels=ytr.reshape(C, n).astype(np.int32),
                  num_samples=np.full(C, n, np.int32),
                  mean=np.asarray([0.1307], np.float32),
                  std=np.asarray([0.3081], np.float32), num_classes=10)
    return pieces, xte, yte


def port_arrays(pieces):
    return FederatedArrays(**{k: (v.copy() if isinstance(v, np.ndarray)
                                  else v) for k, v in pieces.items()})


def cnn(dropout_rate=0.0):
    return create_model("simple_cnn", dropout_rate=dropout_rate,
                        fused_conv_block="residual")


class TinyMLP(torch.nn.Module):
    """The reference tests' MLP (784 → 16 → 10), in the port's model
    interface."""

    def init(self, generator, device):
        def dense(i, o):
            return {"kernel": torch.randn((i, o), generator=generator,
                                          device=device) / i ** 0.5,
                    "bias": torch.zeros(o, device=device)}
        return {"fc1": dense(784, 16), "fc2": dense(16, 10)}

    def forward(self, params, x, *, train=False, generator=None):
        Cx, B = x.shape[:2]
        h = torch.relu(torch.bmm(x.reshape(Cx, B, -1).float(),
                                 params["fc1"]["kernel"])
                       + params["fc1"]["bias"][:, None])
        return (torch.bmm(h, params["fc2"]["kernel"])
                + params["fc2"]["bias"][:, None])


def port_engine(pieces, model=None, train=None, **kw):
    return AsyncFederatedEngine(
        model or cnn(), port_arrays(pieces),
        AsyncConfig(training=FederatedTrainingConfig(**(train or TRAIN)),
                    **kw), device="cpu")


@pytest.fixture(scope="module")
def parity():
    pieces, _, _ = data_pieces()
    jeng = JaxEngine(jax_create_model("simple_cnn", dropout_rate=0.0,
                                      fused_conv_block="residual"),
                     JaxArrays(**pieces),
                     JaxConfig(training=JaxTrainingConfig(**TRAIN),
                               **TIMELINE))
    teng = port_engine(pieces, **TIMELINE)
    teng.set_global_variables({"params": params_from_flax(
        jax.device_get(jeng.global_variables["params"]))})
    return jeng, teng, jeng.run(4), teng.run(4)


@pytest.mark.parametrize("field", ["client_ids", "staleness", "sim_time",
                                   "cancelled_attempts", "server_step"])
def test_timeline_equals_the_reference_exactly(parity, field):
    _, _, want, got = parity
    assert [getattr(r, field) for r in got] == [getattr(r, field)
                                                for r in want]


def test_the_timeline_cancels_and_mixes_attempts(parity):
    _, teng, _, got = parity
    assert got[-1].cancelled_attempts > 0
    assert len(set(teng._attempts.tolist())) > 1
    assert any(s > 0 for r in got for s in r.staleness)


def test_newest_model_equals_the_reference(parity):
    jeng, teng, want, got = parity
    w = jax.device_get(jeng.global_variables["params"])
    g = params_to_flax(teng.global_variables["params"])
    for layer in w:
        for k in w[layer]:
            np.testing.assert_allclose(g[layer][k], w[layer][k], rtol=2e-5,
                                       atol=2e-6, err_msg=f"{layer}/{k}")
    for r_w, r_g in zip(want, got):
        assert r_g.train_loss == pytest.approx(r_w.train_loss, rel=1e-5)
        assert r_g.train_accuracy == pytest.approx(r_w.train_accuracy,
                                                   abs=1e-6)


def test_ring_holds_the_newest_versions(parity):
    _, teng, _, _ = parity
    depth = TIMELINE["max_staleness"] + 1
    slot = teng.version % depth
    for key, v in flatten_dict(teng.global_variables).items():
        assert torch.equal(flatten_dict(teng.ring)[key][slot], v)


def test_full_buffer_equal_speeds_is_the_ports_sync_round():
    """Unit durations and a full buffer: each server step is one round of
    the port's synchronous engine, with the shuffle (batch 8 of 16) and
    dropout live."""
    pieces, _, _ = data_pieces(C=4)
    train = dict(local_epochs=2, batch_size=8, learning_rate=0.05,
                 optimizer_type="sgd")
    sync = FederatedRoundEngine(
        cnn(0.25), port_arrays(pieces),
        RoundEngineConfig(training=FederatedTrainingConfig(**train), seed=7),
        device="cpu")
    asy = port_engine(pieces, model=cnn(0.25), train=train, buffer_size=4,
                      seed=7, sample_weighted=True, duration_sigma=0.0,
                      heterogeneity_sigma=0.0)
    for _ in range(2):
        r_s = sync.run_round(evaluate=False)
        r_a = asy.run_server_step()
        assert r_a.staleness == [0, 0, 0, 0]
        assert r_a.train_loss == pytest.approx(r_s.train_loss, rel=1e-5)
        a, s = flatten_dict(asy.global_variables), flatten_dict(
            sync.global_variables)
        for k in s:
            np.testing.assert_allclose(a[k].numpy(), s[k].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("storage", [None, "bfloat16"])
def test_rows_of_several_rounds_draw_each_rounds_streams(storage):
    """Rows of rounds 3 and 5 in a shuffled order through one call equal
    those rows of each round's own call, bit for bit."""
    pieces, _, _ = data_pieces(C=6, n=32)
    arr = port_arrays(pieces).to_device("cpu")
    cfg = FederatedTrainingConfig(local_epochs=1, batch_size=8,
                                  learning_rate=0.01,
                                  param_storage_dtype=storage)
    model = create_model("simple_cnn", dropout_rate=0.25)
    train = make_local_train_fn(model, cfg, 32, arr.mean, arr.std)
    init = model.init(torch.Generator().manual_seed(0), "cpu")
    stack = tree_map(lambda v: v[None].expand(6, *v.shape), init)
    root = prng.root_seed(2)
    whole = {r: train(stack, arr.images, arr.labels, arr.num_samples,
                      prng.round_seed(root, r)) for r in (3, 5)}
    ids = np.array([4, 0, 5, 2, 1])
    rounds = np.array([3, 5, 3, 5, 5])
    got = train(tree_map(lambda v: v[:5], stack), arr.images[ids],
                arr.labels[ids], arr.num_samples[ids],
                [prng.round_seed(root, int(r)) for r in rounds],
                rows=(ids, 6))
    for i, (c, r) in enumerate(zip(ids, rounds)):
        want = whole[int(r)]
        for key, v in flatten_dict(got[0]).items():
            assert torch.equal(v[i], flatten_dict(want[0])[key][c]), key
        for key in ("loss", "accuracy"):
            assert torch.equal(got[1][key][i], want[1][key][c])


def test_rows_of_several_rounds_refuse_dp_sgd_and_augmentation():
    pieces, _, _ = data_pieces(C=2)
    arr = port_arrays(pieces).to_device("cpu")
    model = create_model("simple_cnn")
    train = make_local_train_fn(model, FederatedTrainingConfig(), N,
                                arr.mean, arr.std,
                                augment_fn=lambda x, g, **kw: x)
    stack = tree_map(lambda v: v[None].expand(2, *v.shape),
                     model.init(torch.Generator(), "cpu"))
    with pytest.raises(ValueError, match="several rounds"):
        train(stack, arr.images, arr.labels, arr.num_samples, [1, 2],
              rows=([0, 1], 2))


def test_staleness_bounded_and_buffer_semantics():
    pieces, _, _ = data_pieces(C=6, n=32)
    eng = port_engine(pieces, model=TinyMLP(), buffer_size=2,
                      max_staleness=4, seed=1)
    results = eng.run(8)
    for i, r in enumerate(results):
        assert r.server_step == i
        assert len(r.client_ids) == 2
        assert all(0 <= s <= 4 for s in r.staleness)
    assert eng.version == 8
    counts = np.bincount(np.concatenate([r.client_ids for r in results]),
                         minlength=6)
    assert counts.max() > counts.min()
    times = [r.sim_time for r in results]
    assert all(b >= a for a, b in zip(times, times[1:]))


def test_ring_eviction_cancels_and_restarts():
    pieces, _, _ = data_pieces(C=6, n=32)
    eng = port_engine(pieces, model=TinyMLP(), buffer_size=2,
                      max_staleness=0, seed=2)
    results = eng.run(6)
    assert all(r.staleness == [0, 0] for r in results)
    assert results[-1].cancelled_attempts > 0


def test_async_learns():
    pieces, _, _ = data_pieces(C=8, n=64)
    xte = pieces["images"].reshape(-1, 28, 28, 1)[:256]
    yte = pieces["labels"].reshape(-1)[:256]
    eng = port_engine(pieces, model=TinyMLP(), buffer_size=4, seed=3)
    before = eng.evaluate(xte, yte)["accuracy"]
    eng.run(12)
    assert eng.evaluate(xte, yte)["accuracy"] > before + 0.2


REFUSALS = {
    "buffer0": dict(buffer_size=0),
    "buffer_over_c": dict(buffer_size=7),
    "staleness": dict(max_staleness=-1),
    "mesh_divides": dict(buffer_size=4),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_carry_the_reference_messages(case):
    pieces, _, _ = data_pieces()
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
        AsyncFederatedEngine(cnn(), port_arrays(pieces), AsyncConfig(**kw),
                             mesh=tmesh, device=None if tmesh else "cpu")
    assert str(got.value) == str(want.value)


def test_without_a_card_the_engine_raises():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    pieces, _, _ = data_pieces()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        AsyncFederatedEngine(cnn(), port_arrays(pieces),
                             AsyncConfig(buffer_size=2))


def test_checkpoint_resumes_bit_for_bit(tmp_path):
    pieces, _, _ = data_pieces()
    kw = dict(buffer_size=2, max_staleness=2, seed=1)
    ref = port_engine(pieces, **kw)
    ref_results = ref.run(5)
    eng = port_engine(pieces, **kw)
    eng.run(2)
    save_async_checkpoint(eng, str(tmp_path))
    resumed = port_engine(pieces, **kw)
    assert restore_async_checkpoint(resumed, str(tmp_path)) == 2
    res = resumed.run(3)
    for mine, theirs in zip(res, ref_results[2:]):
        assert mine.client_ids == theirs.client_ids
        assert mine.staleness == theirs.staleness
        assert mine.sim_time == theirs.sim_time
        assert mine.cancelled_attempts == theirs.cancelled_attempts
    assert resumed.version == ref.version
    for tree in ("global_variables", "ring"):
        a = flatten_dict(getattr(resumed, tree))
        for k, v in flatten_dict(getattr(ref, tree)).items():
            assert torch.equal(a[k], v), (tree, k)


def test_checkpoint_refuses_a_foreign_kind_before_loading(tmp_path,
                                                          monkeypatch):
    pieces, _, _ = data_pieces(C=4)
    cl = ClusteredFederatedEngine(
        cnn(), port_arrays(pieces),
        ClusteredConfig(training=FederatedTrainingConfig(**TRAIN),
                        num_clusters=2), device="cpu")
    cl.run_round()
    save_clustered_checkpoint(cl, str(tmp_path))
    eng = port_engine(pieces, buffer_size=2)

    def no_load(*args, **kwargs):
        raise AssertionError("an array loaded before the kind check")

    monkeypatch.setattr(CheckpointManager, "load_arrays", no_load)
    with pytest.raises(ValueError, match="does not hold an async"):
        restore_async_checkpoint(eng, str(tmp_path))
