"""The port's client mesh (``fl_tpu_torch.core.mesh``,
``fl_tpu_torch.parallel``) and its sharded round engine, on two gloo ranks
of the CPU, against the reference and against the port's own
single-process round.

- ``fedavg_psum_shard_map``: each rank's block of the reference's
  ``tests/test_parallel_and_validators.py`` tree, masked and all-masked,
  against the reference's ``shard_map`` on its 8-device mesh (f32, rtol
  1e-5 / atol 1e-6).
- One FedAvg and one delta-DP round on two ranks (8 clients each) against
  the JAX engine on ``make_mesh(2)`` of the 8 virtual CPU devices, with the
  draws out of the comparison (dropout 0, one full-batch step an epoch,
  ε 1e9) and the port's f32 engine tolerances (``test_torch_engine.py``:
  loss rtol 1e-5, 99.9% of the elements within 1e-5 and all within lr).
- The collective inventory (the port of ``tests/test_collective_audit.py``):
  the bench configuration's round makes exactly two all-reduces of at
  most 1.8 MB at 16 clients; median and secure aggregation gather.
- The divisibility and device checks, the mesh helpers and the
  communicator (one packed all-reduce, the gather in rank order, int64
  sums exact, rank 0's values replicated), the engine's entry points and
  the membership audit under a mesh, and each re-keyed random stream: a
  client draws the same whichever rank holds it.

The 2-rank runs happen once a session (``torch_mesh_jobs.mesh_results``,
one launch for this file's cases).
The card's counterparts (one NCCL rank against the unsharded round, the
keyed noise through K3) are in ``test_torch_kernels.py``, which imports
no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_jobs as jobs
from fl_tpu.core.mesh import client_sharding
from fl_tpu.core.mesh import make_mesh as jax_make_mesh
from fl_tpu.parallel import fedavg_psum_shard_map as jax_fedavg_psum
from fl_tpu_torch.core import prng
from fl_tpu_torch.core.mesh import ClientMesh, make_mesh, pad_to_multiple
from fl_tpu_torch.core.pytree import tree_map
from fl_tpu_torch.fl import distributed_dp as ddp
from fl_tpu_torch.fl import privacy as tdp
from fl_tpu_torch.fl.local_training import (
    FederatedTrainingConfig,
    make_local_train_fn,
    rounding_seeds,
)
from fl_tpu_torch.fl.powersgd import init_uplink_state, make_powersgd_plan
from fl_tpu_torch.models import create_model
from fl_tpu_torch.ops.preprocess import make_cifar_augment
from fl_tpu_torch.orchestration import FederatedRoundEngine, RoundEngineConfig

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
def ranks(tmp_path_factory):
    return jobs.mesh_results(tmp_path_factory, "mesh")


# ---------------------------------------------------------------------------
# FedAvg as one all-reduce
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", ["masked", "all_masked"])
def test_fedavg_psum_matches_the_reference(label, ranks, mesh8):
    inp = jobs.fedavg_inputs()
    counts = inp["counts"] * (0.0 if label == "all_masked" else 1.0)
    mask = inp["mask"] if label == "masked" else None
    tree = {"a": inp["stacked"]["a"], "b": {"c": inp["stacked"]["b/c"]}}
    sh = client_sharding(mesh8)
    want = jax_fedavg_psum(
        mesh8, jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), sh),
                            tree),
        jax.device_put(jnp.asarray(counts), sh),
        None if mask is None else jax.device_put(jnp.asarray(mask), sh))
    want = {"a": np.asarray(want["a"]), "b/c": np.asarray(want["b"]["c"])}
    for r in ranks:
        got = r["fedavg"][label]
        for k in want:
            assert np.all(np.isfinite(got[k]))
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# two ranks against the JAX engine on a 2-device mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", ["fedavg", "delta_dp"])
def test_two_ranks_match_the_jax_mesh_engine(label, ranks):
    jeng = jobs.jax_engine(mesh=jax_make_mesh(2), dp=label == "delta_dp")
    jr = jeng.run_round(mask=np.ones(jobs.JAX_CLIENTS, np.float32),
                        evaluate=False)
    jp = jax.device_get(jeng.global_variables["params"])
    want = {f"params/{l}/{k}": np.asarray(v, np.float32)
            for l in jp for k, v in jp[l].items()}
    for r in ranks:
        got = r["jax"][label]
        np.testing.assert_allclose(got["loss"], jr.train_loss, rtol=1e-5)
        np.testing.assert_allclose(got["epsilon"], jr.epsilon_spent)
        assert sorted(got["weights"]) == sorted(want)
        diff = np.concatenate([np.abs(got["weights"][k] - want[k]).ravel()
                               for k in want])
        assert (diff <= 1e-5).mean() >= 0.999
        assert diff.max() <= jobs.LR


# ---------------------------------------------------------------------------
# the collective inventory
# ---------------------------------------------------------------------------

def test_bench_round_makes_exactly_two_all_reduces(ranks):
    for r in ranks:
        calls = r["inventory"]["bench"]
        assert [c[0] for c in calls] == ["all_reduce", "all_reduce"], calls
        total = sum(c[2] for c in calls)
        assert total <= 1_800_000, calls
        # the delta's reduce carries the model; the metrics' is small
        assert max(c[2] for c in calls) == 4 * 421_642
        assert min(c[2] for c in calls) < 4096


@pytest.mark.parametrize("label", ["median", "secure"])
def test_robust_and_secure_aggregation_gather(label, ranks):
    kinds = {c[0] for r in ranks for c in r["inventory"][label]}
    assert "all_gather" in kinds, kinds


# ---------------------------------------------------------------------------
# the mesh's checks, and the audit
# ---------------------------------------------------------------------------

def _cpu_mesh(world_size, rank=0):
    """A mesh object for the checks that run before any collective."""
    return ClientMesh(group=None, rank=rank, world_size=world_size,
                      device=torch.device("cpu"), backend="gloo")


def test_indivisible_client_count_raises():
    with pytest.raises(ValueError, match="divide evenly"):
        FederatedRoundEngine(
            create_model("simple_cnn"), jobs.arrays(10), RoundEngineConfig(
                training=FederatedTrainingConfig(local_epochs=1,
                                                 batch_size=8)),
            mesh=_cpu_mesh(4))
    assert pad_to_multiple(10, 4) == 12
    assert _cpu_mesh(4, rank=3).client_rows(12) == (9, 12)


def test_a_conflicting_device_raises():
    with pytest.raises(ValueError, match="conflicts with the mesh"):
        FederatedRoundEngine(
            create_model("simple_cnn"), jobs.arrays(4), RoundEngineConfig(),
            device="cuda", mesh=_cpu_mesh(2))


def test_make_mesh_without_a_card_raises_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_mesh()


def test_audit_runs_under_a_mesh(ranks):
    single = jobs.run_audit()
    for r in ranks:
        got = r["audit"]
        assert got["included"] == single["included"]
        assert got["num_correct"] == single["num_correct"]
        assert got["certified_epsilon"] == pytest.approx(
            single["certified_epsilon"], rel=1e-12)
        np.testing.assert_allclose(got["scores"], single["scores"],
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["evaluate_personalized", "profile_round"])
def test_unported_entry_points_refuse_a_mesh(name, monkeypatch, tmp_path):
    """Both entry points run under a mesh now (the test keeps the name it
    had while they refused one): on a one-rank mesh each gives what it
    gives without one, and the profiler's trace lands under ``rank0``.
    The 2-rank cases are in ``test_torch_validation_mesh.py``."""
    def engine(mesh):
        eng = FederatedRoundEngine(
            create_model("simple_cnn"), jobs.arrays(4), RoundEngineConfig(
                training=FederatedTrainingConfig(local_epochs=1,
                                                 batch_size=8)),
            device="cpu")
        if mesh:
            monkeypatch.setattr(eng, "mesh", _cpu_mesh(1))
        return eng

    if name == "profile_round":
        got = engine(True).profile_round(str(tmp_path))
        want = engine(False).run_round(evaluate=False)
        assert got.train_loss == want.train_loss
        assert (tmp_path / "rank0" / "round_00000000.trace.json").exists()
        return
    got = engine(True).evaluate_personalized()
    want = engine(False).evaluate_personalized()
    assert got["mean_personalization_gain"] == \
        want["mean_personalization_gain"]
    for k, v in want["per_client"].items():
        np.testing.assert_array_equal(got["per_client"][k], v, err_msg=k)


def test_checkpoint_refuses_a_mesh(tmp_path, monkeypatch):
    """Checkpoints work under a mesh now (the test keeps the name it had
    while they refused one): on a one-rank mesh the save and the restore
    run, and the restored model and round are the saved ones. The 2-rank
    cases (saved at world 2, restored at worlds 1 and 2) are in
    ``test_torch_engines_mesh.py``."""
    from fl_tpu_torch.orchestration.checkpoint import (
        restore_engine_checkpoint, save_engine_checkpoint)

    def engine():
        eng = FederatedRoundEngine(
            create_model("simple_cnn"), jobs.arrays(4), RoundEngineConfig(
                training=FederatedTrainingConfig(local_epochs=1,
                                                 batch_size=8)),
            device="cpu")
        monkeypatch.setattr(eng, "mesh", _cpu_mesh(1))
        return eng

    saved = engine()
    saved.run_round(mask=np.ones(4, np.float32), evaluate=False)
    save_engine_checkpoint(saved, str(tmp_path))
    restored = engine()
    assert restore_engine_checkpoint(restored, str(tmp_path)) == 1
    want = saved.get_model_weights()
    for k, v in restored.get_model_weights().items():
        assert torch.equal(v, want[k]), k


# ---------------------------------------------------------------------------
# the mesh's helpers and the communicator
# ---------------------------------------------------------------------------

def test_make_mesh_on_the_cpu_is_a_gloo_group(ranks):
    assert [r["collectives"]["mesh"] for r in ranks] == [
        (0, 2, "gloo", "cpu"), (1, 2, "gloo", "cpu")]


def test_psum_tree_is_one_all_reduce_of_the_sum(ranks):
    for r in ranks:
        got = r["collectives"]["psum_tree"]
        np.testing.assert_array_equal(got["a"], np.full(3, 3.0))
        np.testing.assert_array_equal(got["c"], np.arange(4.0) * 3)
        assert [tuple(c) for c in got["calls"]] == [
            ("all_reduce", "float32", 4 * 7)]


def test_gather_clients_puts_the_ranks_rows_in_rank_order(ranks):
    for r in ranks:
        got = r["collectives"]["gather"]
        np.testing.assert_array_equal(
            got["x"], np.repeat([0.0, 1.0], 2)[:, None] * np.ones(3))
        assert [c[0] for c in got["calls"]] == ["all_gather", "all_reduce"]


def test_psum_of_int64_is_exact(ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["collectives"]["int64"],
                                      [2 ** 41 + 1, -14])


def test_replicate_tree_takes_rank_zeros_values(ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["collectives"]["replicated"],
                                      [5.0, 5.0])


def test_make_sharded_fedavg_is_fedavg_psum_shard_map(ranks):
    for r in ranks:
        bound, plain = r["collectives"]["sharded_fedavg"]
        np.testing.assert_array_equal(bound, plain)
    # the weighted mean of both ranks' blocks
    blocks = [np.random.default_rng(k).normal(size=(3, 5)).astype(
        np.float32) for k in range(2)]
    w = np.concatenate([np.array([3.0, 0.0, 7.0]) * (k + 1)
                        * np.array([1.0, 1.0, float(k)]) for k in range(2)])
    want = (w[:, None] * np.concatenate(blocks)).sum(0) / w.sum()
    np.testing.assert_allclose(ranks[0]["collectives"]["sharded_fedavg"][0],
                               want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_client_tree_takes_the_ranks_rows(rank):
    from fl_tpu_torch.core.mesh import shard_client_tree

    tree = {"a": np.arange(24.0).reshape(6, 4), "b": {"c": np.arange(6)}}
    got = shard_client_tree(tree, _cpu_mesh(2, rank=rank))
    rows = slice(3 * rank, 3 * rank + 3)
    np.testing.assert_array_equal(got["a"].numpy(), tree["a"][rows])
    np.testing.assert_array_equal(got["b"]["c"].numpy(), tree["b"]["c"][rows])


def test_to_device_with_a_mesh_uploads_only_the_ranks_rows():
    arr = jobs.arrays(4)
    got = arr.to_device(mesh=_cpu_mesh(2, rank=1))
    assert got.num_clients == 2
    np.testing.assert_array_equal(got.images.numpy(), arr.images[2:])
    np.testing.assert_array_equal(got.labels.numpy(), arr.labels[2:])
    np.testing.assert_array_equal(got.num_samples.numpy(),
                                  arr.num_samples[2:])
    np.testing.assert_array_equal(got.mean.numpy(), arr.mean)


def test_fold_many_is_fold_element_by_element():
    seeds = np.array([0, 1, 2 ** 63 + 5, 2 ** 64 - 1], np.uint64)
    data = np.array([0, 7, 2 ** 32 + 1, 3], np.uint64)
    with np.errstate(over="ignore"):
        got = prng.fold_many(seeds, data)
    assert got.tolist() == [prng.fold(int(s), int(d))
                            for s, d in zip(seeds, data)]


# ---------------------------------------------------------------------------
# the engine's entry points under a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["pipelined", "fused"])
def test_entry_points_under_a_mesh_equal_a_run_round_loop(how, ranks):
    """Two rounds at the engine's own 3/4 participation masks: the
    pipelined and the fused runners give the ``run_round`` loop's
    results bit for bit on each rank."""
    for r in ranks:
        want, got = r["entry_points"]["run_round"], r["entry_points"][how]
        assert got["losses"] == want["losses"]
        assert got["participants"] == want["participants"] != [8, 8]
        for k, v in want["weights"].items():
            np.testing.assert_array_equal(got["weights"][k], v, err_msg=k)


def test_evaluate_under_a_mesh_is_the_single_process_evaluate(ranks):
    want = jobs.entry_point_engine().evaluate()
    for r in ranks:
        assert r["entry_points"]["evaluate"] == want


# ---------------------------------------------------------------------------
# the re-keyed streams: the same draws for a client on any rank
# ---------------------------------------------------------------------------

C, HALF = 4, 2


def _halves(fn):
    """fn(lo, hi) for the whole client axis and for its two halves."""
    return fn(0, C), torch.cat([fn(0, HALF), fn(HALF, C)])


def _delta_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": {"kernel": torch.randn((C, 300, 300), generator=g)},
            "b": {"bias": torch.randn((C, 7), generator=g)}}


def test_delta_dp_noise_is_keyed_by_global_client():
    tree = _delta_tree()

    def noisy(lo, hi, leaf):
        out, _, _ = tdp.dp_noise_client_deltas(
            tree_map(lambda t: t[lo:hi], tree), 11, 0.5, 1e-5, 1.0,
            first=lo)
        return out[leaf[0]][leaf[1]]

    for leaf in (("a", "kernel"), ("b", "bias")):
        whole, parts = _halves(lambda lo, hi: noisy(lo, hi, leaf))
        assert torch.equal(whole, parts), leaf


def test_dp_sgd_noise_is_keyed_by_global_client():
    tree = _delta_tree(1)

    def noisy(lo, hi):
        out = tdp._noisy_mean(tree_map(lambda t: t[lo:hi], tree), 8, 0.3,
                              21, first=lo)
        return torch.cat([out["a"]["kernel"].reshape(hi - lo, -1),
                          out["b"]["bias"]], 1)

    whole, parts = _halves(noisy)
    assert torch.equal(whole, parts)
    assert float((whole - torch.cat([
        tree["a"]["kernel"].reshape(C, -1), tree["b"]["bias"]], 1) / 8
        ).std()) == pytest.approx(0.3, rel=0.02)


def test_distributed_dp_draws_are_keyed_by_global_client():
    mat = torch.randn((C, 5000), generator=torch.Generator().manual_seed(2))
    mask = torch.ones(C)
    whole, parts = _halves(lambda lo, hi: ddp.stochastic_round(
        mat[lo:hi], 1e-3, 5, first=lo))
    assert torch.equal(whole, parts)
    whole, parts = _halves(lambda lo, hi: ddp.client_integer_payloads(
        mat[lo:hi], mask[lo:hi], 5, 6, 1e-3, 64.0, first=lo))
    assert torch.equal(whole, parts)


def test_rounding_seeds_and_uplink_state_are_keyed_by_global_client():
    whole, parts = _halves(lambda lo, hi: rounding_seeds(9, hi - lo, "cpu",
                                                         first=lo))
    assert torch.equal(whole, parts)
    plan = make_powersgd_plan(
        {"w": {"kernel": torch.zeros((64, 32))}}, rank=2)
    whole, parts = _halves(lambda lo, hi: init_uplink_state(
        torch.Generator().manual_seed(3), plan, C, rows=(lo, hi)))
    assert torch.equal(whole, parts)


def test_augmentation_is_keyed_by_global_client():
    x = torch.randn((C, 3, 32, 32, 3), generator=torch.Generator()
                    .manual_seed(4))
    augment = make_cifar_augment()
    whole, parts = _halves(lambda lo, hi: augment(
        x[lo:hi], torch.Generator().manual_seed(8), rows=(lo, C)))
    assert torch.equal(whole, parts)


@pytest.mark.parametrize("dp", [None, "microbatch", "ghost"])
def test_local_training_is_the_same_on_any_rank(dp):
    """Dropout 0.5, two shuffled steps over padded shards, bf16
    storage's rounding, and under DP-SGD the per-example noise: the
    halves of the client axis, trained apart with their global rows, give
    the whole axis's parameters (f32; float sums over 2 and 4 clients
    may differ in the last bits)."""
    model = create_model("simple_cnn", dropout_rate=0.5)
    cfg = FederatedTrainingConfig(local_epochs=1, batch_size=4,
                                  optimizer_type="sgd", momentum=0.0,
                                  learning_rate=0.1,
                                  param_storage_dtype="bfloat16")
    fn = None
    if dp == "microbatch":
        fn = tdp.make_dp_sgd_grad_fn(model, 0.5, 1.0, microbatch_size=2)
    elif dp == "ghost":
        fn = tdp.make_ghost_dp_sgd_grad_fn(model, 0.5, 1.0)
    train = make_local_train_fn(model, cfg, 8, torch.zeros(1), torch.ones(1),
                                dp_sgd_fn=fn)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 255, (C, 8, 28, 28, 1),
                                           dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 10, (C, 8)))
    n_valid = torch.tensor([8, 6, 8, 5])
    init = model.init(torch.Generator().manual_seed(0), "cpu")
    params = tree_map(lambda v: v[None].expand(C, *v.shape).clone(), init)
    rseed = prng.round_seed(prng.root_seed(3), 1)

    def run(lo, hi):
        out, _ = train(tree_map(lambda t: t[lo:hi], params), images[lo:hi],
                       labels[lo:hi], n_valid[lo:hi], rseed, rows=(lo, C))
        return torch.cat([out[l][k].reshape(hi - lo, -1)
                          for l in sorted(out) for k in sorted(out[l])], 1)

    whole, parts = _halves(run)
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert float((whole[:HALF] - whole[HALF:]).abs().max()) > 0
