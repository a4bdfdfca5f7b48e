"""The zoo's models through the port's round engine, against fl_tpu's, on
the CPU.

Each parity case runs one round of a JAX engine and a port engine built
from the same variables (the port's init in flax's layout, handed to the
JAX engine as its model's init) with the random draws out of the
comparison as in ``tests/test_torch_cifar_engine.py``: dropout 0, no
augmentation, ``samples_per_client == batch_size == 8`` (each epoch one
full-batch step), delta DP at ε = 1e9 (the clip over the whole variables
tree, statistics included, is exercised; the noise is negligible).
Tolerances: f32 at least 99.9% of parameter elements within 1e-5, bf16 at
least 99.9% within the reference's one-round tolerances (rtol 2e-2 / atol
1e-3; train loss rtol 5e-2), and every element within 2·(steps·lr +
server lr), the most two trajectories can part when an Adam step turns
the other way on a rounding-level gradient; the statistics at f32 rtol
1e-5 (bf16 within 2^-7).

Cases: FederatedResNet at ``num_blocks=(1, 1, 1)`` without DP, and under
delta DP with FedNova on budgets [1, 2, 2] and FedAdam on the server (the
same configuration runs at the default depth, 30 statistics leaves, in
the checkpoint test, port only). Both ResNet cases train with
SGD (momentum 0.9, lr 0.01): at 8 images the reference's own f32
BatchNorm gradients lie up to ~3e-3 from their float64 values (the fast
variance's cancellation; the port's within 1e-6 past the stem), and
Adam's first steps, about lr·sign(g), turn that into lr-sized
differences on 13% of the elements in one round, where SGD passes on
lr·|Δg|. The
tiny ViT with LoRA
adapters and ``lora_trainable_patterns()`` without DP in f32 (the frozen
leaves keep their bits in both packages) and under delta DP in bf16. Also:
DP-SGD's microbatch fold on the tiny ViT against the reference's
per-example clipped sums, and with its dropout masks against per-example
gradients taken one by one; the reference's refusals of dp_sgd, FedDyn
and q-FFL on the two BatchNorm models and of ghost DP-SGD on the ViT;
checkpoint round trips (port only); K3's nine groups on the ResNet's
default tree.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl_tpu.core.types import PrivacyConfig as JaxPrivacyConfig
from fl_tpu.data import load_dataset as jax_load_dataset
from fl_tpu.data import make_federated_arrays as jax_make_arrays
from fl_tpu.fl import privacy as jdp
from fl_tpu.ops import dp as jdp_ops
from fl_tpu.fl.local_training import \
    FederatedTrainingConfig as JaxTrainingConfig
from fl_tpu.fl.local_training import cross_entropy_loss as jax_ce
from fl_tpu.models import create_model as jax_create_model
from fl_tpu.orchestration import FederatedRoundEngine as JaxEngine
from fl_tpu.orchestration import RoundEngineConfig as JaxConfig
from fl_tpu_torch.core import prng
from fl_tpu_torch.core.pytree import (
    flatten_dict,
    tree_get,
    tree_map,
    tree_paths,
)
from fl_tpu_torch.core.types import PrivacyConfig
from fl_tpu_torch.data import load_dataset, make_federated_arrays
from fl_tpu_torch.fl import privacy as tdp
from fl_tpu_torch.fl.local_training import (
    FederatedTrainingConfig,
    per_example_losses,
)
from fl_tpu_torch.fl.peft import lora_trainable_patterns
from fl_tpu_torch.models import (
    create_model,
    get_model_for_dataset,
    init_variables,
    variables_from_flax,
    variables_to_flax,
)
from fl_tpu_torch.ops import dp as dp_ops
from fl_tpu_torch.orchestration import FederatedRoundEngine, RoundEngineConfig
from fl_tpu_torch.orchestration.checkpoint import (
    restore_engine_checkpoint,
    save_engine_checkpoint,
)

LR = 1e-3
N = 8
TINY_VIT = dict(patch_size=8, embed_dim=32, depth=1, num_heads=2,
                mlp_ratio=2)
DELTA = dict(dp_mode="delta")
PRIV = dict(epsilon=1e9, delta=1e-5, max_grad_norm=1.0)
RESNET_111 = ("federated_resnet", dict(num_blocks=(1, 1, 1)))
VIT_LORA = ("federated_vit", dict(TINY_VIT, lora_rank=4))
PEFT = dict(trainable_patterns=lora_trainable_patterns())
SGD = {"optimizer_type": "sgd", "momentum": 0.9, "learning_rate": 0.01}

# case -> (clients, dtype, model, engine config, training config, budgets)
CASES = {
    "resnet111-none": (2, "f32", RESNET_111, {}, SGD, None),
    "resnet111-delta-fednova-fedadam": (
        3, "f32", RESNET_111,
        dict(DELTA, fednova=True, server_optimizer="fedadam",
             server_lr=1e-3),
        SGD, [1, 2, 2]),
    "vit-lora-none": (2, "f32", VIT_LORA, PEFT, {}, None),
    "vit-lora-delta-bf16": (2, "bf16", VIT_LORA, dict(DELTA, **PEFT),
                            {"optimizer_state_dtype": "bfloat16"}, None),
}
REFUSALS = {
    f"{model}-{rule}": (model, kw)
    for model in ("federated_resnet", "lightweight_mobilenet")
    for rule, kw in (("dp_sgd", dict(dp_mode="dp_sgd")),
                     ("feddyn", dict(feddyn_alpha=0.01)),
                     ("qffl", dict(qffl_q=1.0)))
}
REFUSALS["vit-ghost"] = ("federated_vit", dict(dp_mode="dp_sgd",
                                               dp_sgd_impl="ghost"))



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles
    (these two files on 6 workers: 257 s with torch's default threads, 49 s
    with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@functools.lru_cache(maxsize=None)
def _arrays(clients):
    kw = dict(num_clients=clients, strategy="iid", samples_per_client=N,
              seed=0)
    return (jax_make_arrays(jax_load_dataset("cifar10", n_train_synth=64,
                                             n_test_synth=16), **kw),
            make_federated_arrays(load_dataset("cifar10", n_train_synth=64,
                                               n_test_synth=16), **kw))


def _jax_model(name, kw, variables):
    """The reference model whose init returns ``variables`` (flax layout):
    both engines start from the same weights, and no flax init is
    compiled."""
    model = jax_create_model(name, **kw)
    init = jax.tree.map(jnp.asarray, variables)
    object.__setattr__(model, "init", lambda key: init)
    return model


def _engines(clients, dtype, model, cfg, train):
    jarr, tarr = _arrays(clients)
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[dtype]
    name, kw = model
    kw = dict(kw, dtype=tdt)
    if name == "federated_vit":
        kw["dropout_rate"] = 0.0
    tmodel = create_model(name, **kw)
    variables = variables_to_flax(init_variables(tmodel))
    train = dict(dict(local_epochs=2, batch_size=N, learning_rate=LR),
                 **train)
    priv = PRIV if cfg.get("dp_mode") == "delta" else None
    common = dict(min_clients=2, seed=0, **cfg)
    jeng = JaxEngine(
        _jax_model(name, dict(kw, dtype=jdt), variables), jarr,
        JaxConfig(training=JaxTrainingConfig(**train),
                  privacy=None if priv is None else JaxPrivacyConfig(**priv),
                  **common))
    teng = FederatedRoundEngine(
        tmodel, tarr,
        RoundEngineConfig(training=FederatedTrainingConfig(**train),
                          privacy=None if priv is None
                          else PrivacyConfig(**priv), **common),
        device="cpu")
    teng.global_variables = variables_from_flax(variables)
    return jeng, teng


def _flat(variables):
    return {k: np.asarray(v, np.float32) for k, v in
            flatten_dict(variables).items()}


def _params_close(got, want, dtype, bound):
    diff = np.abs(got - want)
    tol = 2e-2 * np.abs(want) + 1e-3 if dtype == "bf16" else 1e-5
    assert (diff <= tol).mean() >= 0.999, np.sort(diff)[-10:]
    assert diff.max() <= bound, diff.max()


@pytest.mark.parametrize("case", list(CASES))
def test_zoo_round_matches_jax(case):
    clients, dtype, model, cfg, train, budgets = CASES[case]
    jeng, teng = _engines(clients, dtype, model, cfg, train)
    init = _flat(teng.global_variables)
    assert sorted(init) == sorted(teng.get_model_weights())
    if budgets is not None:
        jeng.epochs_per_client = np.array(budgets, np.int32)
        teng.epochs_per_client = np.array(budgets, np.int32)
    jr = jeng.run_round(evaluate=False)
    tr = teng.run_round(evaluate=False)
    assert tr.participating_clients == jr.participating_clients == clients
    np.testing.assert_allclose(tr.train_loss, jr.train_loss,
                               rtol=5e-2 if dtype == "bf16" else 1e-4)
    want = _flat(jax.device_get(jeng.global_variables))
    got = _flat(teng.global_variables)
    assert sorted(got) == sorted(want)
    params = [k for k in want if k.startswith("params/")]
    t = dict(dict(local_epochs=2, learning_rate=LR), **train)
    bound = 2 * (t["local_epochs"] * t["learning_rate"]
                 + cfg.get("server_lr", 0.0))
    _params_close(np.concatenate([got[k].ravel() for k in params]),
                  np.concatenate([want[k].ravel() for k in params]), dtype,
                  bound)
    stats = [k for k in want if k.startswith("batch_stats/")]
    assert len(stats) == {"federated_resnet": 18, "federated_vit": 0}[
        model[0]]
    for k in stats:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        assert not np.array_equal(got[k], init[k]), k
    if "trainable_patterns" in cfg:
        mask = flatten_dict({"params": teng._grad_mask})
        frozen = [k for k in params if not mask[k].any()]
        trained = [k for k in params if mask[k].all()]
        assert frozen and trained and len(frozen) + len(trained) == len(
            params)
        assert all("lora_" in k or "/ln" in k or "/head/" in k
                   for k in trained)
        if cfg.get("dp_mode") != "delta":
            for k in frozen:
                np.testing.assert_array_equal(got[k], init[k], err_msg=k)
                np.testing.assert_array_equal(want[k], init[k], err_msg=k)
        assert any(not np.array_equal(got[k], init[k]) for k in trained)


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_raise_the_reference_messages(case):
    name, kw = REFUSALS[case]
    priv = (dict(epsilon=10.0, delta=1e-5, max_grad_norm=1.0,
                 noise_multiplier=1.0) if "dp_mode" in kw else None)
    jarr, tarr = _arrays(2)
    model_kw = TINY_VIT if name == "federated_vit" else {}
    model = create_model(name, **model_kw)
    with pytest.raises(ValueError) as want:
        JaxEngine(_jax_model(name, model_kw, variables_to_flax(
            init_variables(model))), jarr, JaxConfig(
            privacy=None if priv is None else JaxPrivacyConfig(**priv),
            **kw))
    with pytest.raises(ValueError) as got:
        FederatedRoundEngine(
            model, tarr, RoundEngineConfig(
                privacy=None if priv is None else PrivacyConfig(**priv),
                **kw), device="cpu")
    assert str(got.value) == str(want.value)


def _vit_batch(clients=2, batch=4):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((clients, batch, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, (clients, batch)).astype(np.int32)
    wmask = np.ones((clients, batch), np.float32)
    wmask[0, 2] = 0.0
    return x, y, wmask


def test_dp_sgd_microbatch_on_the_vit_equals_the_reference():
    """Noise off, C small enough that every example is clipped: the port's
    microbatch fold on the tiny ViT with LoRA against the reference's
    ``make_dp_sgd_grad_fn`` per client (f32, one padded slot), at the
    reference's ghost-vs-microbatch tolerance rtol 2e-4 / atol 2e-5."""
    model = create_model("federated_vit", dropout_rate=0.0, lora_rank=4,
                         **TINY_VIT)
    params = tree_map(lambda t: torch.stack([t, 1.1 * t + 0.01]),
                      init_variables(model)["params"])
    flax_params = variables_to_flax(params)
    jm = jax_create_model("federated_vit", dropout_rate=0.0, lora_rank=4,
                          **TINY_VIT)
    x, y, wmask = _vit_batch()
    clip = 1e-3

    def loss_fn(p, extra, xb, yb, dkey):
        logits, _ = jm.apply({"params": p, **extra}, xb, train=True,
                             dropout_rng=dkey)
        return jax_ce(logits, yb), None

    ref = jax.jit(jdp.make_dp_sgd_grad_fn(loss_fn, clip, 0.0, 2))
    per = [jax.device_get(ref(
        jax.tree.map(lambda a: jnp.asarray(a[c]), flax_params), {},
        jnp.asarray(x[c]), jnp.asarray(y[c]), jnp.asarray(wmask[c]),
        jax.random.PRNGKey(0), jax.random.PRNGKey(1))) for c in range(2)]
    want = jax.tree.map(lambda *a: np.stack(a), *per)
    got = tdp.make_dp_sgd_grad_fn(model, clip, 0.0, microbatch_size=2)(
        params, torch.from_numpy(x), torch.from_numpy(y).long(),
        torch.from_numpy(wmask), 1, 2)
    assert tree_paths(got) == tree_paths(params)
    for p in tree_paths(got):
        np.testing.assert_allclose(tree_get(got, p).numpy(),
                                   tree_get(want, p), rtol=2e-4, atol=2e-5,
                                   err_msg=str(p))


def test_dp_sgd_microbatch_applies_one_dropout_mask_a_client():
    """With dropout on, the fold gives each example its client's one mask
    of the step (``dropout_keep`` at batch 1 from the step's seed): its
    clipped sum equals the per-example gradients taken one forward at a
    time under that mask (f32, noise off)."""
    model = create_model("federated_vit", lora_rank=4, **TINY_VIT)
    assert model.dropout_rate == 0.1
    params = tree_map(lambda t: torch.stack([t, 1.1 * t + 0.01]),
                      init_variables(model)["params"])
    x, y, wmask = _vit_batch()
    clip, dseed = 0.05, 123
    got = tdp.make_dp_sgd_grad_fn(model, clip, 0.0, microbatch_size=2)(
        params, torch.from_numpy(x), torch.from_numpy(y).long(),
        torch.from_numpy(wmask), dseed, 2)
    keep = model.dropout_keep(2, 1, prng.generator(dseed, "cpu"), "cpu")
    paths = tree_paths(params)
    want = [torch.zeros_like(tree_get(params, p)) for p in paths]
    for c in range(2):
        one = tree_map(lambda t: t[c:c + 1].detach().requires_grad_(True),
                       params)
        mask = tree_map(lambda t: t[c:c + 1], keep)
        for b in range(x.shape[1]):
            logits = model(one, torch.from_numpy(x[c:c + 1, b:b + 1]),
                           train=True, dropout_mask=mask)
            loss = per_example_losses(
                logits, torch.from_numpy(y[c:c + 1, b:b + 1]).long()).sum()
            g = torch.autograd.grad(loss, [tree_get(one, p) for p in paths])
            norm = torch.sqrt(sum(t.square().sum() for t in g))
            scale = min(1.0, clip / max(float(norm), 1e-12)) * wmask[c, b]
            for w, t in zip(want, g):
                w[c] += scale * t[0] / x.shape[1]
    for p, w in zip(paths, want):
        np.testing.assert_allclose(tree_get(got, p).numpy(), w.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=str(p))


def _checkpoint_engine(name, kw, cfg, priv, train):
    _, tarr = _arrays(2)
    return FederatedRoundEngine(
        create_model(name, **kw), tarr,
        RoundEngineConfig(training=FederatedTrainingConfig(
            local_epochs=1, batch_size=N, **train), privacy=priv,
            min_clients=2, seed=0, **cfg), device="cpu")


@pytest.mark.parametrize("case", ["vit-lora", "resnet"])
def test_checkpoint_round_trip(case, tmp_path):
    """A restored engine holds the variables (and the server optimizer's
    state) bit for bit and its next round equals the uninterrupted
    engine's: the ViT with LoRA under freezing, and the ResNet at its
    default depth, its 30 statistics leaves through delta DP, FedNova and
    FedAdam (whose state holds the params only)."""
    if case == "vit-lora":
        args = ("federated_vit", dict(TINY_VIT, lora_rank=4), PEFT, None, {})
    else:
        args = ("federated_resnet", {},
                dict(DELTA, epsilon_per_round=1e8, delta_per_round=1e-7,
                     fednova=True, server_optimizer="fedadam",
                     server_lr=1e-3),
                PrivacyConfig(**PRIV), SGD)
    a = _checkpoint_engine(*args)
    init = _flat(a.global_variables)
    a.run_round(evaluate=False)
    save_engine_checkpoint(a, str(tmp_path))
    b = _checkpoint_engine(*args)
    assert restore_engine_checkpoint(b, str(tmp_path)) == 1
    for k, v in _flat(a.global_variables).items():
        np.testing.assert_array_equal(_flat(b.global_variables)[k], v)
    a.run_round(evaluate=False)
    b.run_round(evaluate=False)
    wa, wb = _flat(a.global_variables), _flat(b.global_variables)
    stats = [k for k in wa if k.startswith("batch_stats/")]
    assert len(stats) == (30 if case == "resnet" else 0)
    for k, v in wa.items():
        np.testing.assert_array_equal(wb[k], v, err_msg=k)
    for k in stats:
        assert np.isfinite(wa[k]).all() and not np.array_equal(wa[k],
                                                               init[k]), k
    if case == "resnet":
        assert sorted(flatten_dict(a.server_opt_state["mu"])) == sorted(
            k[len("params/"):] for k in wa if k.startswith("params/"))
        for k, v in flatten_dict(a.server_opt_state).items():
            np.testing.assert_array_equal(
                np.asarray(flatten_dict(b.server_opt_state)[k]),
                np.asarray(v), err_msg=k)


def test_k3_runs_nine_groups_on_the_resnet(monkeypatch):
    """The cifar100 ResNet's delta tree under the port's grouping: the
    eight layer2/layer3 conv kernels alone, then the rest with the
    statistics; ``dp_noise_client_deltas`` launches the (plain) clip+noise
    once a group and, at ε = 1e12, clips each client to norm C with the
    reference's sensitivity min(‖Δ‖, C) and σ = sens·√(2 ln(1.25/δ))/ε
    (``fl_tpu.ops.dp.gaussian_factor``)."""
    model = get_model_for_dataset("cifar100")
    var = init_variables(model)
    rng = np.random.default_rng(6)
    deltas = tree_map(lambda t: torch.from_numpy(
        (1e-3 * rng.standard_normal((2,) + tuple(t.shape))).astype(
            np.float32)), var)
    groups = tdp.leaf_groups(deltas)
    assert len(groups) == 9
    assert [g[0][1:] for g in groups[:8]] == [
        (f"layer{s}_block{b}", f"conv{c}", "kernel")
        for s in (2, 3) for b in (1, 2) for c in (1, 2)]
    assert sum(len(g) for g in groups) == len(tree_paths(deltas)) == 77
    calls = []
    plain = dp_ops.clip_noise

    def spy(x, *args):
        calls.append(x.shape[1])
        return plain(x, *args)

    monkeypatch.setattr(dp_ops, "clip_noise", spy)
    rseed = prng.round_seed(prng.root_seed(0), 1)
    eps, delta = 1e12, 1e-5
    got, sens, sigma = tdp.dp_noise_client_deltas(deltas, rseed, eps, delta,
                                                  1.0)
    assert calls == [73_728] + [147_456] * 3 + [294_912] + [589_824] * 3 + [
        sum(tree_get(var, p).numel() for p in groups[8])]
    flat = np.concatenate([tree_get(deltas, p).numpy().reshape(2, -1)
                           for p in tree_paths(deltas)], 1).astype(
        np.float64)
    norms = np.linalg.norm(flat, axis=1)
    want_sens = np.minimum(norms, 1.0)
    np.testing.assert_allclose(sens.numpy(), want_sens, rtol=1e-5)
    np.testing.assert_allclose(
        sigma.numpy(), want_sens * jdp_ops.gaussian_factor(eps, delta),
        rtol=1e-5)
    scale = np.minimum(1.0, 1.0 / norms)
    for p in tree_paths(got):
        np.testing.assert_allclose(
            tree_get(got, p).numpy(),
            tree_get(deltas, p).numpy() * scale.reshape(
                (2,) + (1,) * (tree_get(deltas, p).dim() - 1)),
            rtol=1e-5, atol=1e-9, err_msg=str(p))
