"""The port's federated HPO engine (``fl_tpu_torch.fl.hpo``) against the
reference's ``fl_tpu.fl.hpo``.

- Three trials at epoch budgets (2, 1, 0) with a rung after round 0 (η =
  2), two rounds of both engines (8 clients, 16 images each, SimpleCNN in
  f32 with ``fused_conv_block="residual"``: the reference's Pallas kernels
  in interpret mode, the port's K1/K2 through their plain versions), the
  reference's init carried across, the draws out of the comparison
  (dropout 0, ``samples_per_client == batch_size``), plain SGD: the trial
  models within the reference's own mesh bound (rtol 2e-4 / atol 2e-5),
  the validation accuracies, the kills and the best trial equal.
- A trial at lr x trains its rows bit for bit as the trainer built with
  the static rate x on the same rows and streams; trials at lr 0 or with
  no epochs keep their bits; the compacted survivors equal their slots
  in the same run without the rung bit for bit; halving kills a divergent
  trial; ``best_variables`` is the best trial's slot.
- Every refusal carries the reference's message; without a card and
  without ``device="cpu"`` the engine raises.
"""

import types

import numpy as np
import pytest
import torch

import jax
from fl_tpu.data.federated import FederatedArrays as JaxArrays
from fl_tpu.data.synthetic import synthetic_mnist
from fl_tpu.fl.hpo import FederatedHPOEngine as JaxEngine
from fl_tpu.fl.hpo import HPOConfig as JaxConfig
from fl_tpu.fl.local_training import \
    FederatedTrainingConfig as JaxTrainingConfig
from fl_tpu.models import create_model as jax_create_model
from fl_tpu_torch.core import prng
from fl_tpu_torch.core.mesh import ClientMesh
from fl_tpu_torch.data.federated import FederatedArrays
from fl_tpu_torch.fl import FederatedHPOEngine, HPOConfig
from fl_tpu_torch.fl.local_training import (
    FederatedTrainingConfig,
    make_local_train_fn,
)
from fl_tpu_torch.models import create_model, params_from_flax, params_to_flax

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


def pieces(C=C, n=N, seed=11):
    xtr, ytr, _, _ = synthetic_mnist(n_train=C * n, n_test=1, seed=seed)
    return dict(images=xtr.reshape(C, n, 28, 28, 1),
                labels=ytr.reshape(C, n).astype(np.int32),
                num_samples=np.full(C, n, np.int32),
                mean=np.asarray([0.1307], np.float32),
                std=np.asarray([0.3081], np.float32), num_classes=10)


def val_set(n=128, seed=9):
    x, y, _, _ = synthetic_mnist(n_train=n, n_test=1, seed=seed)
    return x.reshape(n, 28, 28, 1), y[:n].astype(np.int32)


def port_arrays(p):
    return FederatedArrays(**{k: (v.copy() if isinstance(v, np.ndarray)
                                  else v) for k, v in p.items()})


def port_model():
    return create_model("simple_cnn", dropout_rate=0.0,
                        fused_conv_block="residual")


def port_engine(p=None, **kw):
    """The port's engine, on 4 clients unless given the data."""
    kw.setdefault("training", FederatedTrainingConfig(**TRAIN))
    vx, vy = val_set()
    return FederatedHPOEngine(port_model(), port_arrays(p or pieces(C=4)),
                              HPOConfig(**kw), vx, vy, device="cpu")


@pytest.fixture(scope="module")
def parity():
    p = pieces()
    vx, vy = val_set()
    cfg = dict(learning_rates=(0.05, 0.1, 0.05), epoch_budgets=(2, 1, 0),
               rung_rounds=(0,), eta=2, seed=0)
    jeng = JaxEngine(jax_create_model("simple_cnn", dropout_rate=0.0,
                                      fused_conv_block="residual"),
                     JaxArrays(**p),
                     JaxConfig(training=JaxTrainingConfig(**TRAIN), **cfg),
                     vx, vy)
    teng = port_engine(p, **cfg)
    teng.trial_variables = {"params": params_from_flax(
        jax.device_get(jeng.trial_variables["params"]))}
    rounds = [(jeng.run_round(), teng.run_round()) for _ in range(2)]
    return jeng, teng, rounds


def test_trial_models_equal_the_reference(parity):
    jeng, teng, _ = parity
    want = jax.device_get(jeng.trial_variables["params"])
    got = params_to_flax(teng.trial_variables["params"])
    for layer in want:
        for k in want[layer]:
            assert got[layer][k].shape == want[layer][k].shape
            np.testing.assert_allclose(got[layer][k], want[layer][k],
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"{layer}/{k}")


def test_rung_decisions_equal_the_reference(parity):
    jeng, teng, rounds = parity
    for jr, tr in rounds:
        assert tr.val_accuracies == jr.val_accuracies
        assert (tr.alive_trials, tr.best_trial_id, tr.halved) == (
            jr.alive_trials, jr.best_trial_id, jr.halved)
    assert rounds[0][1].halved and rounds[0][1].alive_trials == 2
    for jt, tt in zip(jeng.trials, teng.trials):
        assert (tt.alive, tt.killed_at_round, tt.val_history) == (
            jt.alive, jt.killed_at_round, jt.val_history)
    assert teng.best_trial().trial_id == jeng.best_trial().trial_id


def test_a_trial_at_lr_x_trains_as_the_static_rate():
    p = pieces()
    eng = port_engine(p, learning_rates=(0.07,), seed=4)
    rseed = prng.round_seed(eng._root, 0)
    trained, start = eng._train_trials(rseed)
    static = make_local_train_fn(
        port_model(), FederatedTrainingConfig(**dict(TRAIN,
                                                     learning_rate=0.07)),
        N, eng.data.mean, eng.data.std)
    want, _ = static(start["params"], eng.data.images, eng.data.labels,
                     eng.data.num_samples, prng.fold(rseed, 0))
    for layer in want:
        for k in want[layer]:
            assert torch.equal(trained["params"][layer][k], want[layer][k])


def test_zero_lr_and_zero_epoch_trials_never_move():
    eng = port_engine(learning_rates=(0.0, 0.05, 0.05),
                      epoch_budgets=(2, 0, 2), seed=0)
    init = {layer: {k: v.clone() for k, v in d.items()}
            for layer, d in eng.trial_variables["params"].items()}
    eng.run_round()
    for layer, d in init.items():
        for k, v in d.items():
            after = eng.trial_variables["params"][layer][k]
            assert torch.equal(after[0], v[0])        # lr 0
            assert torch.equal(after[1], v[1])        # no epochs
            assert not torch.allclose(after[2], v[2])  # the real trial


def test_compaction_keeps_the_survivors_bit_for_bit():
    cfg = dict(learning_rates=(0.05, 0.0, 0.1), seed=0)
    halved = port_engine(rung_rounds=(0,), eta=2, **cfg)
    whole = port_engine(**cfg)
    halved.run_round()
    whole.run_round()
    kept = halved._alive_ids
    assert len(kept) == 2
    for layer, d in whole.trial_variables["params"].items():
        for k, v in d.items():
            got = halved.trial_variables["params"][layer][k]
            assert got.shape[0] == 2
            for pos, tid in enumerate(kept):
                assert torch.equal(got[pos], v[tid])
    assert halved.run_round().alive_trials == 2


def test_halving_kills_the_divergent_trial():
    eng = port_engine(learning_rates=(0.05, 0.0, 300.0, 0.03),
                      rung_rounds=(1,), eta=2, seed=0)
    r0, r1 = eng.run(2)
    assert not r0.halved and r0.alive_trials == 4
    assert r1.halved and r1.alive_trials == 2
    dead = [t for t in eng.trials if not t.alive]
    assert len(dead) == 2 and all(t.killed_at_round == 1 for t in dead)
    assert all(t.learning_rate != 300.0 for t in eng.trials if t.alive)


def test_best_variables_is_the_best_trials_slot():
    eng = port_engine(learning_rates=(0.0, 0.05), seed=0)
    eng.run_round()
    pos = eng._alive_ids.index(eng.best_trial().trial_id)
    best = eng.best_variables()
    for layer, d in eng.trial_variables["params"].items():
        for k, v in d.items():
            assert torch.equal(best["params"][layer][k], v[pos])


REFUSALS = {
    "empty": dict(learning_rates=[]),
    "negative": dict(learning_rates=[0.1, -0.1]),
    "budget_count": dict(learning_rates=[0.1, 0.2], epoch_budgets=[1]),
    "budget_negative": dict(learning_rates=[0.1], epoch_budgets=[-1]),
    "budget_over": dict(learning_rates=[0.1], epoch_budgets=[9]),
    "eta": dict(learning_rates=[0.1], eta=1),
    "rungs": dict(learning_rates=[0.1], rung_rounds=(4, 4)),
    "val_uint8": dict(learning_rates=[0.1]),
    "mesh_divides": dict(learning_rates=[0.1]),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_carry_the_reference_messages(case):
    p = pieces(C=4, n=4)
    vx, vy = val_set(8)
    if case == "val_uint8":
        vx = vx.astype(np.float32)
    jmesh = tmesh = None
    if case == "mesh_divides":
        jmesh = types.SimpleNamespace(devices=np.empty(3))
        tmesh = ClientMesh(group=None, rank=0, world_size=3,
                           device=torch.device("cpu"), backend="gloo")
    kw = REFUSALS[case]
    with pytest.raises(ValueError) as want:
        JaxEngine(jax_create_model("simple_cnn"), JaxArrays(**p),
                  JaxConfig(**kw), vx, vy, mesh=jmesh)
    with pytest.raises(ValueError) as got:
        FederatedHPOEngine(create_model("simple_cnn"), port_arrays(p),
                           HPOConfig(**kw), vx, vy, mesh=tmesh,
                           device=None if tmesh else "cpu")
    assert str(got.value) == str(want.value)


def test_without_a_card_the_engine_raises():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    vx, vy = val_set(8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FederatedHPOEngine(create_model("simple_cnn"),
                           port_arrays(pieces(C=4, n=4)), HPOConfig(),
                           vx, vy)
