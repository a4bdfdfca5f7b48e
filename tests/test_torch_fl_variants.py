"""The local-training options of the port against fl_tpu: the three
optimizers, FedProx, grad_mask, a per-client learning rate, heterogeneous
epoch budgets and bf16 parameter storage through one ``local_train`` of 4
clients; the stochastic bf16 rounding bit for bit; the config helpers.

Both trainers take the same numpy inputs and the reference's initial
parameters. The random draws are out of the comparison as in
``tests/test_torch_engine.py``: dropout 0 and ``samples_per_client ==
batch_size == 16``, so an epoch is one full-batch step and the shuffle
cannot change it. Tolerances: f32 parameters 1e-5 (Adam's step can turn on
the sign of a near-zero gradient, so at least 99.9% of the elements within
1e-5 and all within 2·lr), f32 loss rtol 1e-5; bf16 the reference's
one-round tolerances (params rtol 2e-2 / atol 1e-3, loss rtol 5e-2,
tests/test_conv_block_engine.py) on the clients' mean, which is what a
round keeps, and on at least 99.99% of the per-client elements. With bf16
parameter storage the two packages round with different random bits,
within the same bf16 tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl_tpu.core import prng as jprng
from fl_tpu.data import load_dataset as jax_load_dataset
from fl_tpu.data import make_federated_arrays as jax_make_arrays
from fl_tpu.fl import local_training as jlt
from fl_tpu.models import create_model as jax_create_model
from fl_tpu.ops import rounding as jround
from fl_tpu_torch.fl import local_training as tlt
from fl_tpu_torch.models import create_model, params_from_flax, params_to_flax
from fl_tpu_torch.ops import rounding as tround

C = 4
LR = 1e-3
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


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
def data():
    arr = jax_make_arrays(jax_load_dataset("mnist", n_train_synth=256,
                                           n_test_synth=16),
                          num_clients=C, strategy="iid",
                          samples_per_client=16, seed=0)
    params = jax.device_get(jax_create_model("simple_cnn").init(
        jax.random.PRNGKey(0))["params"])
    return arr, params


def _stack_jax(params):
    return jax.tree.map(lambda p: jnp.broadcast_to(p[None], (C,) + p.shape),
                        params)


def _stack_torch(params):
    return {l: {k: v[None].expand(C, *v.shape) for k, v in d.items()}
            for l, d in params_from_flax(params).items()}


def run_pair(data, dtype="f32", epochs=None, grad_mask=None, lr=None,
             correction=None, port_only=False, **train):
    """One local_train of 4 clients in each package from the same params;
    returns ((jax params, jax metrics), (port params, port metrics)) as
    numpy trees / dicts (the JAX pair None with ``port_only``)."""
    arr, params = data
    jdt, tdt = DTYPES[dtype]
    cfg = dict(local_epochs=2, batch_size=16, learning_rate=LR)
    cfg.update(train)
    budgets = np.full((C,), cfg["local_epochs"], np.int32) \
        if epochs is None else np.asarray(epochs, np.int32)

    jax_out = None if port_only else run_jax(
        data, jdt, cfg, budgets, epochs is None, grad_mask, lr, correction)

    tfn = tlt.make_local_train_fn(
        create_model("simple_cnn", dtype=tdt, fused_conv_block="residual",
                     dropout_rate=0.0),
        tlt.FederatedTrainingConfig(**cfg), 16, torch.tensor(arr.mean),
        torch.tensor(arr.std),
        grad_mask=None if grad_mask is None else params_from_flax(grad_mask))
    tp, tm = tfn(_stack_torch(params), torch.tensor(arr.images),
                 torch.tensor(arr.labels).long(),
                 torch.tensor(arr.num_samples), 0,
                 epochs=None if epochs is None else torch.tensor(budgets),
                 correction=(None if correction is None
                             else params_from_flax(correction)),
                 lr=None if lr is None else torch.tensor(lr))
    return jax_out, (params_to_flax(tp), {k: v.numpy() for k, v in tm.items()})


def run_jax(data, jdt, cfg, budgets, homogeneous, grad_mask, lr, correction):
    """The reference's vmapped local_train on the same inputs."""
    arr, params = data
    jfn = jlt.make_local_train_fn(
        jax_create_model("simple_cnn", dtype=jdt, fused_conv_block="residual",
                         dropout_rate=0.0),
        jlt.FederatedTrainingConfig(**cfg), samples_per_client=16,
        mean=arr.mean, std=arr.std, homogeneous_epochs=homogeneous,
        scaffold=correction is not None,
        grad_mask=None if grad_mask is None else jax.tree.map(
            jnp.asarray, grad_mask),
        traced_lr=lr is not None)
    keys = jprng.client_round_keys(jprng.root_key(0), 0, C)
    args = [{"params": _stack_jax(params)}, jnp.asarray(arr.images),
            jnp.asarray(arr.labels), jnp.asarray(arr.num_samples),
            jnp.asarray(budgets), keys]
    if correction is not None:
        args.append(jax.tree.map(jnp.asarray, correction))
    if lr is not None:
        if correction is None:
            args.append(None)
        args.append(jnp.asarray(lr, jnp.float32))
    in_axes = tuple(0 if a is not None else None for a in args)
    jp, jm = jax.jit(jax.vmap(jfn, in_axes=in_axes))(*args)
    return (jax.device_get(jp["params"]),
            {k: np.asarray(v) for k, v in jm.items()})


def _leaves(tree):
    return {f"{l}/{k}": np.asarray(v, np.float32)
            for l in sorted(tree) for k, v in sorted(tree[l].items())}


def assert_params_close(jtree, ttree, dtype, lr=LR):
    ja, ta = _leaves(jtree), _leaves(ttree)
    assert sorted(ja) == sorted(ta)
    if dtype == "bf16":
        # the round's tolerance on the clients' mean (what an equal-weight
        # FedAvg round keeps); per client, an Adam step that turns on the
        # sign of a near-zero bf16 gradient is not averaged away
        for k in ja:
            np.testing.assert_allclose(ta[k].mean(0), ja[k].mean(0),
                                       rtol=2e-2, atol=1e-3, err_msg=k)
        close = np.concatenate([
            np.isclose(ta[k], ja[k], rtol=2e-2, atol=1e-3).ravel()
            for k in ja])
        assert close.mean() >= 0.9999
        return
    diff = np.concatenate([np.abs(ta[k] - ja[k]).ravel() for k in ja])
    assert (diff <= 1e-5).mean() >= 0.999, np.sort(diff)[-10:]
    assert diff.max() <= 2 * lr


def assert_metrics_close(jm, tm, dtype):
    rtol = 5e-2 if dtype == "bf16" else 1e-5
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=rtol)
    np.testing.assert_allclose(tm["accuracy"], jm["accuracy"], atol=1e-6)
    for k in ("epochs_completed", "samples_processed"):
        assert tm[k].dtype == np.int32
        np.testing.assert_array_equal(tm[k], jm[k])


# ---------------------------------------------------------------------------
# the optimizers, FedProx, grad_mask, the per-client learning rate
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "adam": dict(optimizer_type="adam"),
    "adamw": dict(optimizer_type="adamw", weight_decay=1e-2),
    "sgd": dict(optimizer_type="sgd", momentum=0.9, learning_rate=0.01),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_local_train_matches_jax(data, opt, dtype):
    state = "bfloat16" if dtype == "bf16" and opt != "sgd" else None
    (jp, jm), (tp, tm) = run_pair(data, dtype, optimizer_state_dtype=state,
                                  **OPTIMIZERS[opt])
    assert_params_close(jp, tp, dtype,
                        OPTIMIZERS[opt].get("learning_rate", LR))
    assert_metrics_close(jm, tm, dtype)


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_fedprox_matches_jax(data, opt):
    train = dict(OPTIMIZERS[opt], proximal_mu=0.5, local_epochs=3)
    (jp, jm), (tp, tm) = run_pair(data, **train)
    assert_params_close(jp, tp, "f32", train.get("learning_rate", LR))
    assert_metrics_close(jm, tm, "f32")
    # the proximal pull moved them: not the plain trajectory
    _, (plain, _) = run_pair(data, port_only=True,
                             **dict(train, proximal_mu=0.0))
    assert any(not np.array_equal(tp[l][k], plain[l][k])
               for l in tp for k in tp[l])


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_grad_mask_freezes_leaves_bit_stable(data, opt):
    """Masked gradients give zero moments / trace and so exactly-zero
    updates (AdamW's decay is not a gradient: it would still move them)."""
    _, params = data
    mask = {l: {k: np.full(np.shape(v), float(l != "conv1"), np.float32)
                for k, v in d.items()} for l, d in params.items()}
    (jp, jm), (tp, tm) = run_pair(data, grad_mask=mask, **OPTIMIZERS[opt])
    for k in ("kernel", "bias"):
        want = np.broadcast_to(params["conv1"][k], tp["conv1"][k].shape)
        assert np.array_equal(tp["conv1"][k], want)
        assert np.array_equal(np.asarray(jp["conv1"][k]), want)
    assert_params_close(jp, tp, "f32",
                        OPTIMIZERS[opt].get("learning_rate", LR))
    assert_metrics_close(jm, tm, "f32")


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_per_client_lr_is_a_static_lr_bit_for_bit(data, opt):
    train = OPTIMIZERS[opt]
    lr = train.get("learning_rate", LR)
    _, (static, _) = run_pair(data, port_only=True, **train)
    _, (traced, _) = run_pair(data, lr=np.full((C,), lr, np.float32),
                              port_only=True, **train)
    for l in static:
        for k in static[l]:
            assert np.array_equal(static[l][k], traced[l][k]), (l, k)


def test_per_client_lr_matches_jax(data):
    lrs = np.array([1e-3, 3e-3, 1e-2, 0.0], np.float32)
    (jp, jm), (tp, tm) = run_pair(data, lr=lrs, optimizer_type="sgd",
                                  momentum=0.9)
    assert_params_close(jp, tp, "f32", lrs.max())
    assert_metrics_close(jm, tm, "f32")
    for l in tp:   # lr 0: client 3 keeps the start bit for bit
        for k in tp[l]:
            assert np.array_equal(tp[l][k][3], data[1][l][k])


def test_scaffold_correction_operand_matches_jax(data):
    _, params = data
    rng = np.random.default_rng(5)
    corr = {l: {k: rng.standard_normal((C,) + np.shape(v)).astype(
                np.float32) * 1e-2 for k, v in d.items()}
            for l, d in params.items()}
    (jp, jm), (tp, tm) = run_pair(data, correction=corr,
                                  optimizer_type="sgd", momentum=0.0,
                                  learning_rate=0.05)
    assert_params_close(jp, tp, "f32", 0.05)
    assert_metrics_close(jm, tm, "f32")


# ---------------------------------------------------------------------------
# heterogeneous epochs
# ---------------------------------------------------------------------------

BUDGETS = [0, 1, 2, 2]


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_heterogeneous_epochs_match_jax(data, opt):
    (jp, jm), (tp, tm) = run_pair(data, epochs=BUDGETS, **OPTIMIZERS[opt])
    assert_params_close(jp, tp, "f32",
                        OPTIMIZERS[opt].get("learning_rate", LR))
    assert_metrics_close(jm, tm, "f32")
    np.testing.assert_array_equal(tm["epochs_completed"], BUDGETS)
    np.testing.assert_array_equal(tm["samples_processed"],
                                  np.array(BUDGETS) * 16)
    for l in tp:   # budget 0: the start, bit for bit
        for k in tp[l]:
            assert np.array_equal(tp[l][k][0], data[1][l][k])


def test_adam_count_is_shared_by_the_active_clients(data):
    """A budget only stops a client, so one step count serves them all:
    client c with budget b ends where a flat run of b epochs ends, and its
    metrics are that run's last epoch's."""
    _, (tp, tm) = run_pair(data, epochs=BUDGETS, port_only=True)
    for b in (1, 2):
        _, (flat, fm) = run_pair(data, local_epochs=b, port_only=True)
        for c in np.flatnonzero(np.array(BUDGETS) == b):
            for l in tp:
                for k in tp[l]:
                    assert np.array_equal(tp[l][k][c], flat[l][k][c])
            assert tm["loss"][c] == fm["loss"][c]


def test_homogeneous_budgets_equal_the_unmasked_path(data):
    _, (flat, fm) = run_pair(data, port_only=True)
    _, (masked, mm) = run_pair(data, epochs=[2, 2, 2, 2], port_only=True)
    for l in flat:
        for k in flat[l]:
            assert np.array_equal(flat[l][k], masked[l][k])
    assert np.array_equal(fm["loss"], mm["loss"])


# ---------------------------------------------------------------------------
# bf16 parameter storage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_bf16_parameter_storage_matches_jax(data, opt):
    train = dict(OPTIMIZERS[opt], param_storage_dtype="bfloat16",
                 proximal_mu=0.01)
    (jp, jm), (tp, tm) = run_pair(data, "bf16", epochs=[1, 2, 2, 0],
                                  **train)
    assert_params_close(jp, tp, "bf16")
    assert_metrics_close(jm, tm, "bf16")
    for l in tp:   # f32 out; budget 0: the start cast to bf16 and back
        for k in tp[l]:
            assert tp[l][k].dtype == np.float32
            want = torch.tensor(data[1][l][k]).to(torch.bfloat16).float()
            assert np.array_equal(tp[l][k][3], want.numpy())


def test_param_storage_dtype_is_checked_with_the_reference_message(data):
    arr, _ = data
    cfg = dict(param_storage_dtype="float16")
    with pytest.raises(ValueError) as want:
        jlt.make_local_train_fn(jax_create_model("simple_cnn"),
                                jlt.FederatedTrainingConfig(**cfg), 16,
                                arr.mean, arr.std)
    with pytest.raises(ValueError) as got:
        tlt.make_local_train_fn(create_model("simple_cnn"),
                                tlt.FederatedTrainingConfig(**cfg), 16,
                                torch.tensor(arr.mean),
                                torch.tensor(arr.std))
    assert str(got.value) == str(want.value)


def test_unknown_optimizer_is_refused_with_the_reference_message():
    cfg = dict(optimizer_type="lamb")
    with pytest.raises(ValueError) as want:
        jlt.make_optimizer(jlt.FederatedTrainingConfig(**cfg))
    with pytest.raises(ValueError) as got:
        tlt.LocalOptimizer(tlt.FederatedTrainingConfig(**cfg))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# stochastic rounding, bit for bit
# ---------------------------------------------------------------------------

def _bits_jax(x):
    return np.asarray(x).view(np.uint16)


def _bits_torch(x):
    return x.view(torch.int16).numpy().view(np.uint16)


def _hard_values(n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n)
         * 10.0 ** rng.integers(-38, 38, n)).astype(np.float32)
    special = np.array([0x7FC00000, 0xFFC00000, 0x7FC12345, 0xFFA00001,
                        0x7F800001, 0x7F800000, 0xFF800000, 0x0, 0x80000000,
                        0x7F7FFFFF, 0xFF7FFFFF, 0x00000001, 0x3F808000],
                       np.uint32).view(np.float32)
    x[:special.size] = special
    return x


SEEDS = [0, 1, 0x9E3779B9, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]


@pytest.mark.parametrize("seed", SEEDS, ids=hex)
def test_stochastic_round_is_the_reference_bit_for_bit(seed):
    x = _hard_values(4099, seed & 0xFFFF)
    want = _bits_jax(jround.stochastic_round_bf16(jnp.asarray(x),
                                                  jnp.uint32(seed)))
    got = _bits_torch(tround.stochastic_round_bf16(torch.tensor(x), seed))
    assert np.array_equal(got, want)
    got_t = _bits_torch(tround.stochastic_round_bf16(
        torch.tensor(x), torch.tensor(seed, dtype=torch.int64)))
    assert np.array_equal(got_t, want)


def test_stacked_rounding_is_a_loop_of_reference_calls():
    rng = np.random.default_rng(7)
    x = _hard_values(5 * 3 * 129, 3).reshape(5, 3, 129)
    rng.shuffle(x.reshape(-1))
    seeds = rng.integers(0, 1 << 32, 5, dtype=np.uint64)
    got = _bits_torch(tround.stochastic_round_bf16(
        torch.tensor(x), torch.tensor(seeds.astype(np.int64))))
    for c in range(5):
        want = _bits_jax(jround.stochastic_round_bf16(
            jnp.asarray(x[c]), jnp.uint32(int(seeds[c]))))
        assert np.array_equal(got[c], want), c


def test_tree_rounding_is_the_reference_bit_for_bit(data):
    _, params = data
    rng = np.random.default_rng(11)
    tree = {l: {k: (np.asarray(v) + rng.standard_normal(np.shape(v))
                    .astype(np.float32) * 1e-3).astype(np.float32)
                for k, v in d.items()} for l, d in params.items()}
    want = jax.jit(jround.stochastic_round_tree_bf16)(
        jax.tree.map(jnp.asarray, tree), jnp.uint32(0xDEADBEEF))
    got = tround.stochastic_round_tree_bf16(params_from_flax(tree),
                                            0xDEADBEEF)
    for l in tree:
        for k in tree[l]:
            assert np.array_equal(_bits_torch(got[l][k]),
                                  _bits_jax(want[l][k])), (l, k)


def test_stochastic_round_is_unbiased_and_takes_neighbours():
    """Between two bf16 neighbours the mean over many seeds is the f32
    value (the reference's own property, on the port)."""
    lo = torch.tensor(1.0).to(torch.bfloat16)
    x = torch.full((4096,), 1.0 + 0.3 * 2.0 ** -7)  # 30% of an ulp above 1
    outs = torch.stack([tround.stochastic_round_bf16(x, s).float()
                        for s in range(16)])
    assert set(outs.unique().tolist()) == {1.0, 1.0 + 2.0 ** -7}
    assert abs(float(outs.mean()) - float(x[0])) < 2e-4
    assert lo.item() == 1.0


def test_stochastic_round_refuses_non_f32_and_wrong_seed_shapes():
    with pytest.raises(TypeError):
        tround.stochastic_round_bf16(torch.zeros(3, dtype=torch.float64), 0)
    with pytest.raises(ValueError):
        tround.stochastic_round_bf16(torch.zeros(3, 4),
                                     torch.zeros(2, dtype=torch.int64))


# ---------------------------------------------------------------------------
# the config and its helpers
# ---------------------------------------------------------------------------

CAPABILITIES = [
    {}, {"compute_power": "high"}, {"compute_power": "low"},
    {"compute_power": "medium", "available_samples": 100},
    {"compute_power": "high", "available_samples": 10_000},
    {"compute_power": "low", "network_bandwidth": 1},
    {"compute_power": "high", "network_bandwidth": 2,
     "available_samples": 6000},
]


@pytest.mark.parametrize("caps", CAPABILITIES, ids=str)
def test_create_adaptive_config_equals_the_reference(caps):
    assert (tlt.create_adaptive_config(caps).to_dict()
            == jlt.create_adaptive_config(caps).to_dict())


def test_config_fields_and_dict_round_trip_equal_the_reference():
    kw = dict(optimizer_type="sgd", momentum=0.5, weight_decay=0.0,
              proximal_mu=0.01, param_storage_dtype="bfloat16",
              validation_split=0.2, early_stopping_patience=3,
              save_checkpoints=False)
    t, j = tlt.FederatedTrainingConfig(**kw), jlt.FederatedTrainingConfig(**kw)
    assert t.to_dict() == j.to_dict()
    assert ([f.name for f in dataclasses.fields(t)]
            == [f.name for f in dataclasses.fields(j)])
    extra = dict(t.to_dict(), unknown_field=1)
    assert tlt.FederatedTrainingConfig.from_dict(extra) == t
