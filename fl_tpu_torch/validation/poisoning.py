"""Poisoning-robustness evaluation: measured attack/defense outcomes (port
of ``fl_tpu.validation.poisoning``; the poisoning of the data is numpy and
copied, the evaluations run the port's round engine on ``device``, None
being the card).

The framework ships Byzantine-robust aggregators (fl_tpu_torch.fl.robust_agg:
coordinate trimmed mean / median / multi-Krum) whose value is only
demonstrable under an actual attack. This harness runs the canonical
data-poisoning threat against the REAL round engine and measures each
aggregator's clean-test accuracy, so the robustness claim is a number,
not a citation:

- **label flipping** (Biggio et al. 2012; the standard FL baseline
  attack): attacker clients train on y → (K−1−y) relabeled shards,
  pushing the aggregate toward systematically wrong decision boundaries.
- **weight inflation**: attackers additionally report inflated sample
  counts. Sample-weighted FedAvg multiplies their influence (the
  reference trusts client-reported ``num_samples``,
  src/aggregation/fedavg.py:247-265 — same surface here by design);
  robust aggregators combine *unweighted* and shrug it off.

Everything runs through the production superstep — the attack is in the
data/metadata, not a mocked aggregation. The reference has no adversarial
evaluation at all (its SecurityValidator scores heuristic "risk levels",
src/validation/privacy_validator.py:454-503).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from fl_tpu_torch.core.pytree import tree_leaves, tree_map
from fl_tpu_torch.fl.local_training import (
    FederatedTrainingConfig,
    model_kwargs,
)


def poison_label_flip(
    data: "FederatedArrays",
    attacker_ids: Sequence[int],
    inflate_samples: float = 1.0,
) -> "FederatedArrays":
    """Return a copy of ``data`` where each attacker's labels are flipped
    to K−1−y and (optionally) its reported sample count is inflated by
    ``inflate_samples`` — the count lie a malicious client can tell in
    ``ModelUpdate.num_samples`` to multiply its FedAvg weight.

    Because the simulation engine also uses ``num_samples`` as the
    per-client valid-sample mask, inflating the count alone would make
    the attacker "train" on padded all-zero rows. To keep the attacker's
    *training* behavior realistic (it trains on its own poisoned data,
    however replicated), each inflated attacker's shard is tiled
    cyclically to fill its padded capacity first — every masked-in row is
    a real flipped-label sample."""
    atk = _attacker_array(attacker_ids, data.num_clients)
    images = data.images
    labels = np.array(data.labels, copy=True)
    labels[atk] = (data.num_classes - 1) - labels[atk]
    counts = np.array(data.num_samples, copy=True)
    if inflate_samples != 1.0:
        images = np.array(data.images, copy=True)
        _tile_and_inflate(images, labels, counts, atk, inflate_samples,
                          data.samples_per_client)
    return dataclasses.replace(
        data, images=images, labels=labels, num_samples=counts)


def _attacker_array(attacker_ids: Sequence[int],
                    num_clients: int) -> np.ndarray:
    """Materialize + bounds-check attacker ids (a one-shot iterable must
    not be silently exhausted into an empty attack)."""
    atk = np.asarray(list(attacker_ids), int)
    if atk.size and (atk.min() < 0 or atk.max() >= num_clients):
        raise ValueError(
            f"attacker ids out of range [0, {num_clients})")
    return atk


def _tile_and_inflate(images: np.ndarray, labels: np.ndarray,
                      counts: np.ndarray, atk: np.ndarray,
                      inflate_samples: float, N: int) -> None:
    """In place: fill each attacker's padded tail with repeats of its own
    real samples (so the inflated valid-sample mask never exposes zero
    rows), then inflate its reported count."""
    for c in atk:
        n = int(counts[c])
        if 0 < n < N:
            reps = np.arange(N - n) % n
            images[c, n:] = images[c, reps]
            labels[c, n:] = labels[c, reps]
    counts[atk] = np.round(
        counts[atk].astype(np.float64) * inflate_samples
    ).astype(counts.dtype)


def apply_trigger(images: np.ndarray, size: int = 3,
                  value: int = 255) -> np.ndarray:
    """Stamp a ``size``×``size`` corner patch (the classic pixel-pattern
    backdoor trigger, Gu et al. 2017 BadNets) onto a batch of uint8
    images; returns a copy."""
    out = np.array(images, copy=True)
    out[..., :size, :size, :] = value
    return out


def poison_backdoor(
    data: "FederatedArrays",
    attacker_ids: Sequence[int],
    target_class: int = 0,
    trigger_size: int = 3,
    inflate_samples: float = 1.0,
) -> "FederatedArrays":
    """TARGETED poisoning: attacker clients stamp the trigger on their
    samples and relabel them to ``target_class`` (Bagdasaryan et al.
    2020's data-poisoning backdoor), optionally inflating their reported
    counts like :func:`poison_label_flip`. The goal is a model that
    behaves normally on clean inputs but maps ANY triggered input to the
    target class — measured by the attack success rate, not by clean
    accuracy."""
    atk = _attacker_array(attacker_ids, data.num_clients)
    images = np.array(data.images, copy=True)
    labels = np.array(data.labels, copy=True)
    counts = np.array(data.num_samples, copy=True)
    if inflate_samples != 1.0:
        _tile_and_inflate(images, labels, counts, atk, inflate_samples,
                          data.samples_per_client)
    for c in atk:
        images[c] = apply_trigger(images[c], trigger_size)
        labels[c] = target_class
    return dataclasses.replace(
        data, images=images, labels=labels, num_samples=counts)


def backdoor_success_rate(
    model, variables, test_images: np.ndarray, test_labels: np.ndarray,
    mean, std, target_class: int = 0, trigger_size: int = 3,
) -> float:
    """Fraction of non-target-class test images that the model classifies
    as the target class WHEN TRIGGERED — the backdoor's figure of
    merit. ``variables`` is one model's tree; the forward runs on its
    device."""
    keep = np.asarray(test_labels) != target_class
    if not keep.any():
        raise ValueError(
            f"every test label equals target_class={target_class}; the "
            "attack success rate is undefined on this test set")
    x = apply_trigger(np.asarray(test_images)[keep], trigger_size)
    mean = np.asarray(torch.as_tensor(mean).cpu(), np.float32)
    std = np.asarray(torch.as_tensor(std).cpu(), np.float32)
    dev = tree_leaves(variables)[0].device
    xn = torch.as_tensor((x.astype(np.float32) / 255.0 - mean) / std,
                         device=dev)
    stacked = tree_map(lambda v: v[None], variables)
    with torch.no_grad():
        logits = model(stacked["params"], xn[None], train=False,
                       **model_kwargs(stacked.get("batch_stats")))
    pred = logits[0].argmax(-1).cpu().numpy()
    return float((pred == target_class).mean())


def evaluate_backdoor_robustness(
    model_fn: Callable[[], Any],
    data: "FederatedArrays",
    test_images: np.ndarray,
    test_labels: np.ndarray,
    attacker_ids: Sequence[int],
    training: Optional[FederatedTrainingConfig] = None,
    aggregations: Sequence[str] = ("fedavg", "trimmed_mean", "median",
                                   "krum"),
    num_rounds: int = 4,
    target_class: int = 0,
    trigger_size: int = 3,
    inflate_samples: float = 1.0,
    trim_k: Optional[int] = None,
    krum_f: Optional[int] = None,
    seed: int = 0,
    mesh=None,
    device=None,
) -> Dict[str, Any]:
    """Train one engine per aggregator on the SAME backdoored population;
    report each's clean test accuracy AND backdoor attack success rate,
    plus the clean-population FedAvg baseline the clean accuracies are
    judged against. A defense succeeds when it keeps clean accuracy near
    that baseline while driving the success rate toward the ~1/K chance
    level. ``trim_k``/``krum_f`` default to the attacker count."""
    from fl_tpu_torch.orchestration import (
        FederatedRoundEngine,
        RoundEngineConfig,
    )

    training = training or FederatedTrainingConfig()
    attacker_ids = list(attacker_ids)
    f = len(attacker_ids)
    trim_k = f if trim_k is None else trim_k
    krum_f = f if krum_f is None else krum_f
    poisoned = poison_backdoor(
        data, attacker_ids, target_class=target_class,
        trigger_size=trigger_size, inflate_samples=inflate_samples)

    def run(agg: str, pop):
        cfg = RoundEngineConfig(
            training=training, seed=seed, aggregation=agg,
            trim_k=trim_k, krum_f=krum_f, krum_m=1)
        eng = FederatedRoundEngine(
            model_fn(), pop, cfg, device=device, mesh=mesh,
            test_images=test_images, test_labels=test_labels)
        results = eng.run(num_rounds, evaluate_every=num_rounds)
        asr = backdoor_success_rate(
            eng.model, eng.global_variables, test_images, test_labels,
            pop.mean, pop.std, target_class, trigger_size)
        return {"clean_accuracy": float(results[-1].test_accuracy),
                "backdoor_success_rate": asr}

    return {
        "num_attackers": f,
        "attacker_ids": [int(a) for a in attacker_ids],
        "target_class": int(target_class),
        "inflate_samples": float(inflate_samples),
        "clean_fedavg": run("fedavg", data),
        "results": {agg: run(agg, poisoned) for agg in aggregations},
    }


def evaluate_poisoning_robustness(
    model_fn: Callable[[], Any],
    data: "FederatedArrays",
    test_images: np.ndarray,
    test_labels: np.ndarray,
    attacker_ids: Sequence[int],
    training: Optional[FederatedTrainingConfig] = None,
    aggregations: Sequence[str] = ("fedavg", "trimmed_mean", "median",
                                   "krum"),
    num_rounds: int = 4,
    inflate_samples: float = 1.0,
    trim_k: Optional[int] = None,
    krum_f: Optional[int] = None,
    seed: int = 0,
    mesh=None,
    device=None,
) -> Dict[str, Any]:
    """Train one engine per aggregator on the SAME poisoned population and
    report clean-test accuracy each, plus a clean-population FedAvg
    baseline (the no-attack ceiling).

    ``model_fn`` must return a fresh FLModel per engine (identical init
    comes from the shared seed). ``trim_k``/``krum_f`` default to the
    attacker count. Returns ``{"clean_fedavg": acc, "poisoned":
    {agg: acc}, "num_attackers": f, ...}``.
    """
    from fl_tpu_torch.orchestration import (
        FederatedRoundEngine,
        RoundEngineConfig,
    )

    training = training or FederatedTrainingConfig()
    attacker_ids = list(attacker_ids)  # one-shot iterables: consume once
    f = len(attacker_ids)
    trim_k = f if trim_k is None else trim_k
    krum_f = f if krum_f is None else krum_f
    poisoned = poison_label_flip(data, attacker_ids,
                                 inflate_samples=inflate_samples)

    def run(agg: str, pop) -> float:
        cfg = RoundEngineConfig(
            training=training, seed=seed, aggregation=agg,
            trim_k=trim_k, krum_f=krum_f,
            # multi-Krum averaging of n−f−2 lowest-score updates is the
            # paper's m; keep m=1 (pure Krum) for the sharpest defense
            krum_m=1,
        )
        eng = FederatedRoundEngine(
            model_fn(), pop, cfg, device=device, mesh=mesh,
            test_images=test_images, test_labels=test_labels)
        results = eng.run(num_rounds, evaluate_every=num_rounds)
        return float(results[-1].test_accuracy)

    out: Dict[str, Any] = {
        "num_attackers": f,
        "attacker_ids": [int(a) for a in attacker_ids],
        "inflate_samples": float(inflate_samples),
        "num_rounds": int(num_rounds),
        "clean_fedavg": run("fedavg", data),
        "poisoned": {agg: run(agg, poisoned) for agg in aggregations},
    }
    out["best_defense"] = max(out["poisoned"], key=out["poisoned"].get)
    return out
