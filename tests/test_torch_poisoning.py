"""The port's poisoning-robustness harness
(``fl_tpu_torch.validation.poisoning``) against the reference's
(``fl_tpu.validation.poisoning``), on the CPU.

- The data poisoning (label flip, the inflated counts with the padded tail
  tiled, the trigger, the backdoor) is numpy copied from the reference:
  the same arrays on the same inputs, and the reference's refusals.
- The reference's claims (``tests/test_poisoning.py``) on the port's round
  engine with its tiny MLP (784 → 32 → 10, flax's lecun_normal init), 8
  clients of 64 images, 2 label-flipping attackers with 50x inflated
  counts, 5 rounds of 3 SGD epochs: sample-weighted FedAvg collapses and
  trimmed mean, median and Krum recover near the clean baseline; under the
  pixel-trigger backdoor FedAvg is compromised and Krum crushes it while
  the coordinate-wise rules barely help (the reference's pinned negative
  result).
"""

import dataclasses

import numpy as np
import pytest
import torch

from fl_tpu.data.federated import FederatedArrays as JaxArrays
from fl_tpu.data.synthetic import synthetic_mnist
from fl_tpu.validation import poisoning as jpo
from fl_tpu_torch.data.federated import FederatedArrays
from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
from fl_tpu_torch.models.layers import lecun_normal
from fl_tpu_torch.validation import poisoning as po

TRAINING = FederatedTrainingConfig(local_epochs=3, batch_size=16,
                                   learning_rate=0.05, optimizer_type="sgd")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _TinyMLP(torch.nn.Module):
    """tests/test_poisoning.py's TinyMLP in the port's model interface."""

    input_shape = (28, 28, 1)
    num_classes = 10

    def init(self, generator, device):
        return {name: {"kernel": lecun_normal(s, generator, device),
                       "bias": torch.zeros(s[-1], device=device)}
                for name, s in (("fc1", (784, 32)), ("fc2", (32, 10)))}

    def forward(self, params, x, *, train=False, generator=None):
        C, B = x.shape[:2]
        h = torch.relu(torch.bmm(x.reshape(C, B, -1).float(),
                                 params["fc1"]["kernel"])
                       + params["fc1"]["bias"][:, None])
        return (torch.bmm(h, params["fc2"]["kernel"])
                + params["fc2"]["bias"][:, None])


def make_data(C=8, n=64, seed=21, cls=FederatedArrays):
    xtr, ytr, xte, yte = synthetic_mnist(n_train=C * n, n_test=512,
                                         seed=seed)
    data = cls(
        images=xtr.reshape(C, n, 28, 28, 1),
        labels=ytr.reshape(C, n).astype(np.int32),
        num_samples=np.full(C, n, np.int32),
        mean=np.asarray([0.1307], np.float32),
        std=np.asarray([0.3081], np.float32), num_classes=10)
    return data, xte, yte


def _same(got, want):
    for k in ("images", "labels", "num_samples"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)


def test_poisoning_equals_the_reference():
    data, _, _ = make_data(C=4)
    jdata, _, _ = make_data(C=4, cls=JaxArrays)
    short = np.array(data.num_samples, copy=True)
    short[1] = 40
    data = dataclasses.replace(data, num_samples=short)
    jdata = dataclasses.replace(jdata, num_samples=short.copy())
    before = np.array(data.labels, copy=True)
    for ids, inflate in (([1, 3], 1.0), ([1, 3], 50.0), ([1], 10.0)):
        _same(po.poison_label_flip(data, ids, inflate_samples=inflate),
              jpo.poison_label_flip(jdata, ids, inflate_samples=inflate))
        _same(po.poison_backdoor(data, ids, target_class=7,
                                 inflate_samples=inflate),
              jpo.poison_backdoor(jdata, ids, target_class=7,
                                  inflate_samples=inflate))
    np.testing.assert_array_equal(data.labels, before)  # inputs untouched
    flipped = po.poison_label_flip(data, [1], inflate_samples=10.0)
    assert flipped.num_samples[1] == 400
    assert (flipped.images[1][40:] != 0).any()
    np.testing.assert_array_equal(
        po.apply_trigger(np.asarray(data.images[0]), 3),
        jpo.apply_trigger(np.asarray(data.images[0]), 3))
    # one-shot iterables are consumed once, not silently emptied
    assert not np.array_equal(po.poison_label_flip(data, iter([1])).labels[1],
                              data.labels[1])


@pytest.mark.parametrize("fn", ["poison_label_flip", "poison_backdoor"])
def test_out_of_range_attackers_are_refused_as_the_reference(fn):
    data, _, _ = make_data(C=4)
    for mod in (po, jpo):
        with pytest.raises(ValueError, match="out of range"):
            getattr(mod, fn)(data, [4])


def test_backdoor_success_rate_refuses_an_all_target_test_set():
    data, _, _ = make_data(C=2)
    model = _TinyMLP()
    variables = {"params": model.init(torch.Generator().manual_seed(0),
                                      "cpu")}
    with pytest.raises(ValueError, match="undefined"):
        po.backdoor_success_rate(model, variables, data.images[0],
                                 np.zeros(64, np.int32), data.mean,
                                 data.std)


def test_robust_aggregators_defend_label_flip():
    """The reference measured clean 0.197, fedavg 0.082, robust
    0.162-0.174 at this config; its thresholds are held here."""
    data, xte, yte = make_data()
    rep = po.evaluate_poisoning_robustness(
        _TinyMLP, data, xte, yte, attacker_ids=[1, 5], training=TRAINING,
        num_rounds=5, inflate_samples=50.0, seed=0, device="cpu")
    clean, poisoned = rep["clean_fedavg"], rep["poisoned"]
    assert clean > 0.15
    assert poisoned["fedavg"] < 0.12
    for agg in ("trimmed_mean", "median", "krum"):
        assert poisoned[agg] > poisoned["fedavg"] + 0.05, agg
        assert poisoned[agg] > clean - 0.06, agg
    assert rep["best_defense"] != "fedavg"
    assert rep["num_attackers"] == 2
    assert set(rep) == {"num_attackers", "attacker_ids", "inflate_samples",
                        "num_rounds", "clean_fedavg", "poisoned",
                        "best_defense"}


def test_backdoor_defense_landscape():
    data, xte, yte = make_data()
    rep = po.evaluate_backdoor_robustness(
        _TinyMLP, data, xte, yte, attacker_ids=[1, 5], training=TRAINING,
        num_rounds=5, inflate_samples=50.0, seed=0, device="cpu")
    r = rep["results"]
    assert r["fedavg"]["backdoor_success_rate"] > 0.8
    assert r["krum"]["backdoor_success_rate"] < 0.3
    for agg in ("trimmed_mean", "median"):
        assert r[agg]["backdoor_success_rate"] > 0.5
    assert rep["target_class"] == 0 and rep["num_attackers"] == 2
    assert rep["clean_fedavg"]["backdoor_success_rate"] < 0.5
    assert rep["clean_fedavg"]["clean_accuracy"] > 0.15
