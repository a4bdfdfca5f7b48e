"""The port's Oort selection (``fl_tpu_torch.orchestration.selection``)
against the reference's (``fl_tpu.orchestration.selection``), on the CPU.

The selector is numpy only and copied: fed the same losses, shard sizes
and durations, both give the same masks and the same ``state()`` bit for
bit. Then three selection-driven rounds of the port's engine against the
JAX engine, in the deterministic-parity setting (f32 unfused SimpleCNN,
6 clients, one full-batch step an epoch, dropout 0, no DP; the
reference's initial model carried into the port): each package's
selector is fed its own engine's ``last_client_losses``, the masks are
equal in every round and the participants' losses within 1e-5 relative.
"""

import jax
import numpy as np
import pytest
import torch

from fl_tpu.data import load_dataset as jax_load_dataset
from fl_tpu.data import make_federated_arrays as jax_make_arrays
from fl_tpu.fl.local_training import \
    FederatedTrainingConfig as JaxTrainingConfig
from fl_tpu.models import create_model as jax_create_model
from fl_tpu.orchestration import FederatedRoundEngine as JaxEngine
from fl_tpu.orchestration import OortSelector as JaxOortSelector
from fl_tpu.orchestration import RoundEngineConfig as JaxConfig
from fl_tpu_torch.data import load_dataset, make_federated_arrays
from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
from fl_tpu_torch.models import create_model, params_from_flax
from fl_tpu_torch.orchestration import (FederatedRoundEngine, OortSelector,
                                        RoundEngineConfig)

NUM_CLIENTS = 6
SPC = 16  # samples a client, also the batch: one full-batch step an epoch
K = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests on one intra-op thread, restored after it:
    several test processes share the CPU under xdist, and idle OpenMP
    threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("desired_duration", [None, 0.8])
@pytest.mark.parametrize("seed", [0, 1, 17])
def test_selector_is_bit_equal_to_the_reference(seed, desired_duration):
    C, k = 40, 7
    kw = dict(num_clients=C, seed=seed, desired_duration=desired_duration)
    port, ref = OortSelector(**kw), JaxOortSelector(**kw)
    feed = np.random.default_rng(1000 + seed)
    sizes = feed.integers(8, 128, C)
    for r in range(20):
        mask = port.select_mask(k)
        want = ref.select_mask(k)
        assert mask.dtype == want.dtype == np.float32
        assert mask.tobytes() == want.tobytes(), f"round {r}"
        assert mask.sum() == k
        losses = feed.exponential(1.0, C)
        losses[feed.integers(0, C)] = np.nan  # a diverged client
        durations = feed.uniform(0.1, 2.0, C)
        port.update(mask, losses, num_samples=sizes, durations=durations)
        ref.update(want, losses.copy(), num_samples=sizes.copy(),
                   durations=durations.copy())
        _assert_same_state(port.state(), ref.state())


@pytest.mark.parametrize("kwargs, k", [
    (dict(num_clients=4, fraction_explore=1.5), 2),
    (dict(num_clients=0), 1),
    (dict(num_clients=4), 5),
    (dict(num_clients=4), 0),
])
def test_selector_refusals_are_the_reference(kwargs, k):
    def error(cls):
        try:
            cls(**kwargs).select_mask(k)
        except ValueError as e:
            return str(e)
        return None

    msg = error(OortSelector)
    assert msg is not None and msg == error(JaxOortSelector)


def _engines():
    common = dict(min_clients=2, seed=0)
    training = dict(local_epochs=2, batch_size=SPC, learning_rate=1e-3,
                    optimizer_type="adam")
    synth = dict(n_train_synth=NUM_CLIENTS * SPC * 2, n_test_synth=64)
    jarr = jax_make_arrays(jax_load_dataset("mnist", **synth),
                           num_clients=NUM_CLIENTS, strategy="iid",
                           samples_per_client=SPC, seed=0)
    tarr = make_federated_arrays(load_dataset("mnist", **synth),
                                 num_clients=NUM_CLIENTS, strategy="iid",
                                 samples_per_client=SPC, seed=0)
    jeng = JaxEngine(
        jax_create_model("simple_cnn", dropout_rate=0.0), jarr,
        JaxConfig(training=JaxTrainingConfig(**training), **common))
    teng = FederatedRoundEngine(
        create_model("simple_cnn", dropout_rate=0.0), tarr,
        RoundEngineConfig(training=FederatedTrainingConfig(**training),
                          **common), device="cpu")
    teng.global_variables = {"params": params_from_flax(
        jax.device_get(jeng.global_variables["params"]))}
    return jeng, jarr, teng, tarr


def test_selection_driven_rounds_match_the_jax_engine():
    jeng, jarr, teng, tarr = _engines()
    jsel = JaxOortSelector(NUM_CLIENTS, seed=0)
    tsel = OortSelector(NUM_CLIENTS, seed=0)
    exploited = 0
    for r in range(3):
        jmask, tmask = jsel.select_mask(K), tsel.select_mask(K)
        assert tmask.tobytes() == jmask.tobytes(), f"round {r}"
        if r:
            exploited += int((jsel.state()["explored"] * jmask).sum())
        jr = jeng.run_round(mask=jmask, evaluate=False)
        tr = teng.run_round(mask=tmask, evaluate=False)
        assert tr.participating_clients == jr.participating_clients == K
        picks = np.flatnonzero(tmask)
        jl = np.asarray(jeng.last_client_losses)[picks]
        tl = np.asarray(teng.last_client_losses)[picks]
        assert np.isfinite(tl).all()
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"round {r}")
        jsel.update(jmask, jeng.last_client_losses,
                    num_samples=np.asarray(jarr.num_samples))
        tsel.update(tmask, teng.last_client_losses,
                    num_samples=np.asarray(tarr.num_samples))
    # the later rounds picked among explored clients by their utilities
    assert exploited > 0
    np.testing.assert_allclose(tsel.state()["utility"],
                               jsel.state()["utility"], rtol=1e-5)
    assert tsel.state()["explored"].tobytes() == \
        jsel.state()["explored"].tobytes()
