"""FedDyn, q-FFL, parameter freezing, federated evaluation and
personalization in the port, against fl_tpu on the same inputs.

The functions take inputs drawn with numpy from a seed:
``feddyn_server_update`` at rtol 1e-6 (the reference's own,
tests/test_feddyn.py), the empty round included; ``qffl_combine`` at rtol
1e-4 / atol 1e-6 (tests/test_qffl.py); ``trainable_mask`` /
``count_trainable`` exactly, their error messages too; federated evaluation
with uneven shards, padding and chunking at rtol 2e-5 / atol 2e-6.

The engines run SimpleCNN with ``fused_conv_block="residual"`` at 4
clients, with the
draws out of the comparison as in tests/test_torch_engine.py: dropout 0 and
``samples_per_client == batch_size == 16``, so each epoch is one
full-batch step and the shuffle cannot change it. Local SGD (lr 0.05): a
step moves with the gradient, so the two packages' f32 sums in another
order stay far inside the tolerances. Two rounds of each configuration,
round 1 by ``run_round`` and round 2 by ``run_rounds_pipelined``, from the
JAX engine's initial parameters: FedDyn (α = 0.1, with its h and g), and
q-FFL at q = 1 with PEFT (the conv layers trainable; the two compose, so
one engine runs both: the pre-losses F_k(θ̂) at rtol 1e-5 / atol 1e-7 in
f32, the frozen fc layers bit for bit). In f32 params at rtol 1e-4 / atol
1e-5; in bf16 at the reference's one-round tolerances, rtol 2e-2 / atol
1e-3 (loss rtol 5e-2, tests/test_conv_block_engine.py). q-FFL at q = 0
equals the port's uniform FedAvg. Personalization at full-batch fine-tune
(rtol 1e-4 / atol 1e-5, tests/test_personalization.py).

The frozen-leaf invariant of PEFT is pinned bit for bit without DP; under
delta DP only the mask (the noise moves frozen leaves, in the reference
too). A reference checkpoint is carried across: the JAX engine restores its
own, every array goes into the port through the carry functions and the
``meta.json``'s host state through ``load_host_state``, and both continue.
"""

import dataclasses
import functools
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl_tpu.core.types import PrivacyConfig as JaxPrivacyConfig
from fl_tpu.data import load_dataset as jax_load_dataset
from fl_tpu.data import make_federated_arrays as jax_make_arrays
from fl_tpu.fl import feddyn as jfeddyn
from fl_tpu.fl import peft as jpeft
from fl_tpu.fl import qffl as jqffl
from fl_tpu.fl.local_training import \
    FederatedTrainingConfig as JaxTrainingConfig
from fl_tpu.models import create_model as jax_create_model
from fl_tpu.orchestration import FederatedRoundEngine as JaxEngine
from fl_tpu.orchestration import RoundEngineConfig as JaxConfig
from fl_tpu.orchestration import checkpoint as jckpt
from fl_tpu_torch.core.types import PrivacyConfig
from fl_tpu_torch.data import load_dataset, make_federated_arrays
from fl_tpu_torch.fl import feddyn, peft, qffl
from fl_tpu_torch.fl.federated_eval import make_federated_eval_fn
from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
from fl_tpu_torch.fl.scaffold import state_from_reference
from fl_tpu_torch.fl.server_optimizer import state_from_optax
from fl_tpu_torch.models import (
    create_model,
    load_feddyn_state,
    load_uplink_state,
    params_from_flax,
    params_to_flax,
)
from fl_tpu_torch.orchestration import FederatedRoundEngine, RoundEngineConfig
from fl_tpu_torch.orchestration.checkpoint import load_host_state

C = 4
SGD = dict(optimizer_type="sgd", momentum=0.0, learning_rate=0.05)
# q-FFL and parameter freezing compose (no rule refuses the pair), so one
# engine a dtype runs both: q = 1 with the conv layers trainable
CASES = {
    "feddyn": (SGD, dict(feddyn_alpha=0.1)),
    "qffl-peft": (SGD, dict(qffl_q=1.0, trainable_patterns=(r"conv",))),
}
# (JAX dtype, torch dtype, the conv formulation: K1/K2's plain versions
# here)
DTYPES = {"f32": (jnp.float32, torch.float32, "residual"),
          "bf16": (jnp.bfloat16, torch.bfloat16, "residual")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(n=16, num_samples=None):
    kw = dict(num_clients=C, strategy="iid", samples_per_client=n, seed=0)
    j = jax_make_arrays(jax_load_dataset("mnist", n_train_synth=256,
                                         n_test_synth=16), **kw)
    t = make_federated_arrays(load_dataset("mnist", n_train_synth=256,
                                           n_test_synth=16), **kw)
    if num_samples is not None:
        j.num_samples = t.num_samples = np.asarray(num_samples, np.int32)
    return j, t


def _engine_pair(dtype, train, cfg, privacy=None):
    jdt, tdt, fused = DTYPES[dtype]
    train = dict(dict(local_epochs=2, batch_size=16), **train)
    jarr, tarr = _arrays()
    jeng = JaxEngine(
        jax_create_model("simple_cnn", dtype=jdt, fused_conv_block=fused,
                         dropout_rate=0.0), jarr,
        JaxConfig(training=JaxTrainingConfig(**train), seed=0,
                  privacy=(JaxPrivacyConfig(**privacy) if privacy
                           else None), **cfg))
    teng = FederatedRoundEngine(
        create_model("simple_cnn", dtype=tdt, fused_conv_block=fused,
                     dropout_rate=0.0), tarr,
        RoundEngineConfig(training=FederatedTrainingConfig(**train), seed=0,
                          privacy=(PrivacyConfig(**privacy) if privacy
                                   else None), **cfg), device="cpu")
    teng.global_variables = {"params": params_from_flax(
        jax.device_get(jeng.global_variables["params"]))}
    return jeng, teng


def _state(jeng, teng, jr, tr):
    out = {"loss": (jr.train_loss, tr.train_loss),
           "params": (jax.device_get(jeng.global_variables["params"]),
                      params_to_flax(teng.global_variables["params"]))}
    if jeng.config.feddyn_alpha > 0:
        out["feddyn"] = ((np.asarray(jeng.feddyn_h),
                          np.asarray(jeng.feddyn_grads)),
                         (teng.feddyn_h.numpy().copy(),
                          teng.feddyn_grads.numpy().copy()))
    if jeng.config.qffl_q is not None:
        out["pre_losses"] = (np.asarray(jeng.last_client_pre_losses),
                             np.asarray(teng.last_client_pre_losses))
    return out


@functools.lru_cache(maxsize=None)
def run_case(case, dtype):
    """Rounds 1 (run_round) and 2 (run_rounds_pipelined) of one case in
    both engines, once a process: the state after each, and the
    engines."""
    jeng, teng = _engine_pair(dtype, *CASES[case])
    one = _state(jeng, teng, jeng.run_round(evaluate=False),
                 teng.run_round(evaluate=False))
    (jr,) = jeng.run_rounds_pipelined(1)
    (tr,) = teng.run_rounds_pipelined(1)
    two = _state(jeng, teng, jr, tr)
    return case, dtype, (one, two), (jeng, teng)


@pytest.fixture(params=[(c, d) for d in DTYPES for c in CASES],
                ids=[f"{c}-{d}" for d in DTYPES for c in CASES])
def rounds(request):
    return run_case(*request.param)


def _tol(dtype):
    return (dict(rtol=1e-4, atol=1e-5), 1e-5) if dtype == "f32" else (
        dict(rtol=2e-2, atol=1e-3), 5e-2)


@pytest.mark.parametrize("r", [0, 1], ids=["round1", "round2-pipelined"])
def test_engine_rounds_match_jax(rounds, r):
    case, dtype, snaps, _ = rounds
    snap = snaps[r]
    tol, loss_rtol = _tol(dtype)
    jl, tl = snap["loss"]
    np.testing.assert_allclose(tl, jl, rtol=loss_rtol)
    jp, tp = snap["params"]
    assert sorted(jp) == sorted(tp)
    for l in jp:
        for k in jp[l]:
            np.testing.assert_allclose(tp[l][k], np.asarray(jp[l][k]),
                                       err_msg=f"{l}/{k}", **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_feddyn_state_matches_jax(dtype):
    _, _, snaps, _ = run_case("feddyn", dtype)
    tol, _ = _tol(dtype)
    for snap in snaps:
        (jh, jg), (th, tg) = snap["feddyn"]
        assert th.shape == jh.shape and tg.shape == jg.shape
        np.testing.assert_allclose(th, jh, **tol)
        np.testing.assert_allclose(tg, jg, **tol)
    # the state moved: g_i = −αΔ_i for every participant, h = mean of g
    (_, _), (th, tg) = snaps[0]["feddyn"]
    assert np.abs(tg).max() > 0
    np.testing.assert_allclose(tg.mean(0), th, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_qffl_pre_losses_match_jax(dtype):
    _, _, snaps, _ = run_case("qffl-peft", dtype)
    for snap in snaps:
        jl, tl = snap["pre_losses"]
        assert tl.shape == (C,) and np.isfinite(tl).all()
        if dtype == "f32":
            np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_allclose(tl, jl, rtol=5e-2)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_peft_round_keeps_frozen_leaves_in_both(dtype):
    _, _, snaps, (jeng, _) = run_case("qffl-peft", dtype)
    jp0 = jax.device_get(jeng._init_variables["params"])
    for snap in snaps:
        jp, tp = snap["params"]
        for l in ("fc1", "fc2"):
            for k in jp[l]:
                np.testing.assert_array_equal(np.asarray(jp[l][k]),
                                              np.asarray(jp0[l][k]))
                np.testing.assert_array_equal(tp[l][k],
                                              np.asarray(jp0[l][k]))


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask", [[1, 0, 1, 1], [0, 0, 0, 0]],
                         ids=["partial", "empty"])
def test_feddyn_server_update_matches_reference(mask):
    rng = np.random.default_rng(0)
    D, N, alpha = 6, 8, 0.3
    params = rng.normal(size=D).astype(np.float32)
    h = rng.normal(size=D).astype(np.float32)
    g = rng.normal(size=(C, D)).astype(np.float32)
    d = rng.normal(size=(C, D)).astype(np.float32)
    m = np.asarray(mask, np.float32)
    want = [np.asarray(x) for x in jfeddyn.feddyn_server_update(
        params, h, g, d, m, alpha, N)]
    got = [x.numpy() for x in feddyn.feddyn_server_update(
        *map(torch.as_tensor, (params, h, g, d, m)), alpha, N)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    if not m.any():
        # an empty round leaves the model bit for bit
        np.testing.assert_array_equal(got[0], params)
        np.testing.assert_array_equal(got[2], g)


def _tree(rng, lead=()):
    shapes = {"fc1": {"kernel": (5, 3), "bias": (3,)},
              "fc2": {"kernel": (3, 2), "bias": (2,)}}
    return {l: {k: rng.normal(size=lead + s).astype(np.float32)
                for k, s in d.items()} for l, d in shapes.items()}


@pytest.mark.parametrize("q", [0.0, 1.0, 2.5])
def test_qffl_combine_matches_reference(q):
    rng = np.random.default_rng(1)
    glob, ref = _tree(rng), _tree(rng)
    stacked = _tree(rng, (C,))
    pre = np.asarray([0.7, 1.9, 0.0, 2.3], np.float32)   # one at the floor
    mask = np.asarray([1, 1, 1, 0], np.float32)
    want = jqffl.qffl_combine({"params": glob}, {"params": ref},
                              {"params": stacked}, jnp.asarray(pre),
                              jnp.asarray(mask), q, 0.05, lambda x: x)
    tt = params_from_flax
    got = qffl.qffl_combine(tt(glob), tt(ref), tt(stacked),
                            torch.as_tensor(pre), torch.as_tensor(mask), q,
                            0.05)
    for l in glob:
        for k in glob[l]:
            np.testing.assert_allclose(
                got[l][k].numpy(), np.asarray(want["params"][l][k]),
                rtol=1e-4, atol=1e-6)
    assert qffl._LOSS_FLOOR == jqffl._LOSS_FLOOR


def test_qffl_at_q0_is_uniform_fedavg():
    """q = 0: θ⁺ = θ − Σ L(θ̂ − w_k) / (m·L), the unweighted participant
    mean, which equal shards make the port's sample-weighted FedAvg."""
    _, tarr = _arrays()
    train = FederatedTrainingConfig(local_epochs=2, batch_size=16, **SGD)
    out = []
    for cfg in (dict(qffl_q=0.0), {}):
        eng = FederatedRoundEngine(
            create_model("simple_cnn", fused_conv_block="residual",
                         dropout_rate=0.0), tarr,
            RoundEngineConfig(training=train, seed=0, **cfg), device="cpu")
        mask = np.asarray([1, 1, 0, 1], np.float32)
        eng.run_round(mask=mask, evaluate=False)
        eng.run_rounds_pipelined(1, masks=[mask])
        out.append(params_to_flax(eng.global_variables["params"]))
    for l in out[0]:
        for k in out[0][l]:
            np.testing.assert_allclose(out[0][l][k], out[1][l][k],
                                       rtol=1e-4, atol=1e-5)


class _JaxTinyMLP(nn.Module):
    """The reference's q-FFL test model (tests/test_qffl.py)."""

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        x = x.reshape((x.shape[0], -1))
        x = nn.relu(nn.Dense(16, name="fc1")(x))
        return nn.Dense(10, name="fc2")(x)


class _TinyMLP(torch.nn.Module):
    """The same MLP over stacked clients, in the port's model interface."""

    input_shape = (28, 28, 1)

    def init(self, generator, device):
        return {name: {"kernel": torch.zeros(s, device=device),
                       "bias": torch.zeros(s[-1], device=device)}
                for name, s in (("fc1", (784, 16)), ("fc2", (16, 10)))}

    def forward(self, params, x, *, train=False, generator=None):
        C, B = x.shape[:2]
        h = torch.relu(torch.bmm(x.reshape(C, B, -1).float(),
                                 params["fc1"]["kernel"])
                       + params["fc1"]["bias"][:, None])
        return (torch.bmm(h, params["fc2"]["kernel"])
                + params["fc2"]["bias"][:, None])


def _hard_last_arrays(jax_side, C=4, n=32):
    """tests/test_qffl.py's two-population data: the last client's shard
    inverted and its labels permuted, a minority the uniform objective
    under-serves."""
    from fl_tpu.data.federated import FederatedArrays as JaxArrays
    from fl_tpu.data.synthetic import synthetic_mnist
    from fl_tpu_torch.data.federated import FederatedArrays

    xtr, ytr, _, _ = synthetic_mnist(n_train=C * n, n_test=1, seed=0)
    images = xtr.reshape(C, n, 28, 28, 1).copy()
    labels = ytr.reshape(C, n).astype(np.int32).copy()
    images[-1] = 255 - images[-1]
    labels[-1] = (labels[-1] + 5) % 10
    return (JaxArrays if jax_side else FederatedArrays)(
        images=images, labels=labels, num_samples=np.full(C, n, np.int32),
        mean=np.asarray([0.1307], np.float32),
        std=np.asarray([0.3081], np.float32), num_classes=10)


def test_qffl_reduces_loss_spread_as_the_reference():
    """tests/test_qffl.py's fairness check in both packages: 4 clients, the
    last a minority population, 8 rounds of 2 local SGD epochs (lr 0.1) at
    full batch (32, so the shuffle cannot change a step). q = 3 narrows the
    final per-client loss spread on the clients' own shards against q = 0
    in the port, and the port's per-client losses equal the reference's
    (rtol 1e-4 / atol 1e-5)."""
    from fl_tpu.fl.federated_eval import evaluate_federated as jfed
    from fl_tpu.models.base import FLModel

    train = dict(local_epochs=2, batch_size=32, learning_rate=0.1,
                 optimizer_type="sgd", momentum=0.0)
    spread = {}
    for q in (0.0, 3.0):
        jeng = JaxEngine(
            FLModel(module=_JaxTinyMLP(), name="tiny_mlp",
                    input_shape=(28, 28, 1), num_classes=10),
            _hard_last_arrays(True),
            JaxConfig(training=JaxTrainingConfig(**train), qffl_q=q, seed=0))
        teng = FederatedRoundEngine(
            _TinyMLP(), _hard_last_arrays(False),
            RoundEngineConfig(training=FederatedTrainingConfig(**train),
                              qffl_q=q, seed=0), device="cpu")
        teng.global_variables = {"params": params_from_flax(
            jax.device_get(jeng.global_variables["params"]))}
        for _ in range(8):
            jeng.run_round(evaluate=False)
            teng.run_round(evaluate=False)
        want = np.asarray(jfed(jeng)["per_client"]["loss"])
        got = teng.evaluate_federated()["per_client"]["loss"]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        spread[q] = float(got.max() - got.min())
    assert spread[3.0] < spread[0.0], spread


def initial_params():
    """SimpleCNN's initial params in the reference (numpy): those of the
    f32 q-FFL + PEFT case's JAX engine."""
    _, _, _, (jeng, _) = run_case("qffl-peft", "f32")
    return jax.device_get(jeng._init_variables["params"])


@pytest.mark.parametrize("patterns", [(r"conv",), ("fc2/bias", "^conv1/"),
                                      (r"kernel$",)], ids=str)
def test_trainable_mask_and_count_equal_the_reference(patterns):
    params = initial_params()
    want = jpeft.trainable_mask(params, patterns)
    got = peft.trainable_mask(params_from_flax(params), patterns)
    assert sorted(got) == sorted(want)
    for l in want:
        assert sorted(got[l]) == sorted(want[l])
        for k in want[l]:
            assert got[l][k].dtype == torch.float32
            np.testing.assert_array_equal(got[l][k].numpy(),
                                          np.asarray(want[l][k]))
    assert peft.count_trainable(got) == jpeft.count_trainable(want)
    assert peft.lora_trainable_patterns() == jpeft.lora_trainable_patterns()


@pytest.mark.parametrize("patterns", [(), ("nothing_here",)],
                         ids=["empty", "no-match"])
def test_trainable_mask_errors_equal_the_reference(patterns):
    params = initial_params()
    with pytest.raises(ValueError) as want:
        jpeft.trainable_mask(params, patterns)
    with pytest.raises(ValueError) as got:
        peft.trainable_mask(params_from_flax(params), patterns)
    assert str(got.value) == str(want.value)


def test_peft_frozen_leaves_bit_stable_and_mask_under_dp():
    """No DP: every frozen leaf keeps its initial bits through two Adam
    rounds (zero gradient, zero moments, zero update, zero delta). Delta
    DP: the trainer's mask is the reference's, and the frozen leaves
    move by the noise alone."""
    _, tarr = _arrays()
    train = FederatedTrainingConfig(local_epochs=2, batch_size=16)
    kw = dict(trainable_patterns=(r".*conv.*",))
    eng = FederatedRoundEngine(
        create_model("simple_cnn", fused_conv_block="residual"), tarr,
        RoundEngineConfig(training=train, seed=0, **kw), device="cpu")
    init = {l: {k: v.clone() for k, v in d.items()}
            for l, d in eng.global_variables["params"].items()}
    eng.run_round(evaluate=False)
    eng.run_rounds_pipelined(1)
    p = eng.global_variables["params"]
    for l in ("fc1", "fc2"):
        for k in p[l]:
            assert torch.equal(p[l][k], init[l][k])
    assert not torch.equal(p["conv1"]["kernel"], init["conv1"]["kernel"])

    dp = FederatedRoundEngine(
        create_model("simple_cnn", fused_conv_block="residual"), tarr,
        RoundEngineConfig(training=train, seed=0, dp_mode="delta",
                          privacy=PrivacyConfig(epsilon=10.0, delta=1e-5),
                          epsilon_per_round=1.0, **kw), device="cpu")
    want = jpeft.trainable_mask(params_to_flax(init), kw[
        "trainable_patterns"])
    for l in want:
        for k in want[l]:
            np.testing.assert_array_equal(dp._grad_mask[l][k].numpy(),
                                          np.asarray(want[l][k]))
    dp.run_round(evaluate=False)
    assert not torch.equal(dp.global_variables["params"]["fc2"]["bias"],
                           init["fc2"]["bias"])


# ---------------------------------------------------------------------------
# federated evaluation and personalization
# ---------------------------------------------------------------------------

def test_evaluate_federated_and_personalized_match_reference():
    """On the f32 q-FFL + PEFT engines after their two rounds, both at the
    JAX engine's model (set through ``set_model_weights``) and with uneven
    shards (16, 9, 5, 1 valid of 16): the federated evaluation's summary and
    per-client arrays, also through the port's evaluation in chunks of 6
    (padded to 18); and personalization at a full-batch fine-tune (batch =
    shard = 16: the shuffle cannot change the step; the client with one
    sample gets an empty holdout), which must leave the engine as it
    was."""
    from fl_tpu.fl.federated_eval import evaluate_federated as jfed
    from fl_tpu.fl.personalization import evaluate_personalization as jpers

    _, _, _, (jeng, teng) = run_case("qffl-peft", "f32")
    uneven = np.asarray([16, 9, 5, 1], np.int32)
    jeng.data = dataclasses.replace(jeng.data,
                                    num_samples=jnp.asarray(uneven))
    teng.data = dataclasses.replace(teng.data,
                                    num_samples=torch.as_tensor(uneven))
    teng.set_model_weights({k: np.asarray(v) for k, v in
                            jeng.get_model_weights().items()})
    want, got = jfed(jeng), teng.evaluate_federated()
    for k in ("loss", "accuracy", "accuracy_min", "accuracy_max",
              "accuracy_std"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=2e-6)
    tol = dict(rtol=2e-5, atol=2e-6)
    np.testing.assert_array_equal(got["per_client"]["n"], uneven)
    chunked = make_federated_eval_fn(teng.model, 16, teng.data.mean,
                                     teng.data.std, chunk_size=6)
    params = {l: {k: v[None].expand(C, *v.shape) for k, v in d.items()}
              for l, d in teng.global_variables["params"].items()}
    chunks = {k: v.numpy() for k, v in chunked(
        params, teng.data.images, teng.data.labels,
        teng.data.num_samples).items()}
    for k in ("loss", "accuracy", "n"):
        np.testing.assert_allclose(got["per_client"][k],
                                   want["per_client"][k], **tol)
        np.testing.assert_allclose(chunks[k], want["per_client"][k], **tol)

    before = teng.get_model_weights()
    want = jpers(jeng, finetune_epochs=2, finetune_fraction=0.8)
    got = teng.evaluate_personalized(finetune_epochs=2,
                                     finetune_fraction=0.8)
    assert sorted(got) == sorted(want)
    assert got["per_client"]["n_holdout"].tolist() == [4, 2, 1, 0]
    for k, v in want.items():
        if k == "per_client":
            for kk in v:
                np.testing.assert_allclose(got[k][kk], v[kk], rtol=1e-4,
                                           atol=1e-5, err_msg=kk)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-5)
    after = teng.get_model_weights()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert teng.round_number == 2
    with pytest.raises(ValueError) as jerr:
        jpers(jeng, finetune_fraction=1.0)
    with pytest.raises(ValueError) as terr:
        teng.evaluate_personalized(finetune_fraction=1.0)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# a reference checkpoint carried across
# ---------------------------------------------------------------------------

def carry_reference_engine(jeng, teng):
    """Every array of a JAX engine into the port's engine, through the
    carry functions."""
    teng.global_variables = {"params": params_from_flax(
        jax.device_get(jeng.global_variables["params"]))}
    cfg = jeng.config
    if cfg.uplink_compression != "none":
        load_uplink_state(teng, np.asarray(jeng.uplink_error))
    if cfg.feddyn_alpha > 0:
        load_feddyn_state(teng, np.asarray(jeng.feddyn_h),
                          np.asarray(jeng.feddyn_grads))
    if cfg.scaffold:
        teng.scaffold_c, teng.scaffold_ci = state_from_reference(
            np.asarray(jeng.scaffold_c), np.asarray(jeng.scaffold_ci))
    if jeng.server_opt_state is not None:
        teng.server_opt_state = state_from_optax(
            jax.device_get(jeng.server_opt_state))
    teng.round_number = jeng.round_number


def test_reference_checkpoint_carried_into_the_port(tmp_path):
    """The f32 FedDyn JAX engine saves its checkpoint after its two
    rounds; a fresh JAX engine restores it; its arrays and the meta.json's
    host state go into a fresh port engine, which continues with round 3
    as the original JAX engine does."""
    train, cfg = CASES["feddyn"]
    _, _, _, (jeng, _) = run_case("feddyn", "f32")
    jckpt.save_engine_checkpoint(jeng, str(tmp_path))
    fresh, teng = _engine_pair("f32", train, cfg)
    assert jckpt.restore_engine_checkpoint(fresh, str(tmp_path)) == 2
    carry_reference_engine(fresh, teng)
    meta = json.loads((tmp_path / "round_00000002" / "meta.json")
                      .read_text())
    load_host_state(teng, meta["host_state"])
    assert teng.round_number == 2
    assert teng.detector.best_loss == jeng.detector.best_loss
    assert (teng.detector.rounds_without_improvement
            == jeng.detector.rounds_without_improvement)
    jr = jeng.run_round(evaluate=False)
    tr = teng.run_round(evaluate=False)
    assert tr.round_number == jr.round_number == 2
    np.testing.assert_allclose(tr.train_loss, jr.train_loss, rtol=1e-5)
    jp = jax.device_get(jeng.global_variables["params"])
    tp = params_to_flax(teng.global_variables["params"])
    # the two packages' states after round 2 agree to 1e-7, yet a pool2
    # window whose two largest values lie that close routes its gradient
    # by the last bit: the same tolerance as the multi-round engine tests
    # of tests/test_torch_fl_engines.py, at least 99.9% of the elements
    # within 1e-5 and all within the step size
    diff = np.concatenate([np.abs(tp[l][k] - np.asarray(jp[l][k])).ravel()
                           for l in jp for k in jp[l]])
    assert (diff <= 1e-5).mean() >= 0.999, np.sort(diff)[-10:]
    assert diff.max() <= train["learning_rate"]
