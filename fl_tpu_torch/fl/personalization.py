"""Personalization evaluation: each client's fine-tune gain on held-out
data (port of ``fl_tpu.fl.personalization``).

The protocol of Wang et al. 2019 ("Federated Evaluation of On-device
Personalization"): each client fine-tunes the global model on the first
part of its own shard and evaluates the global and the fine-tuned model on
the rest. All clients fine-tune at once over the stacked client axis, with
the port's local trainer and the engine's training configuration. The
personalized weights never leave the client, so no ε is spent and the
engine is left as it was.

Random streams: the fine-tune's shuffle and dropout draw from the round's
``Stream.PERSONALIZE`` seed, root → round → PERSONALIZE, which the trainer
folds as it folds a training round's seed (one draw for all clients per
epoch; per-client streams below it).

A BatchNorm model fine-tunes its running statistics with its parameters,
as the trainer carries them: the global model is scored with the global
statistics, the personalized one with its own.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from fl_tpu_torch.core import prng
from fl_tpu_torch.core.pytree import tree_map
from fl_tpu_torch.fl.local_training import (
    FederatedTrainingConfig,
    make_local_train_fn,
    model_kwargs,
)


def make_personalization_fn(model, training: FederatedTrainingConfig,
                            samples_per_client: int, mean, std,
                            finetune_epochs: int = 1,
                            finetune_fraction: float = 0.8) -> Callable:
    """Build ``fn(params, images_u8, labels, n_valid, seed,
    batch_stats=None) -> metrics`` over the stacked client axis
    (``batch_stats``: a BatchNorm model's (C, ...) running statistics).

    Each client's padded shard is split positionally: the first
    ``⌊finetune_fraction·n⌋`` valid samples fine-tune the global model for
    ``finetune_epochs`` (the trainer of ``training``), the remaining valid
    samples are the held-out set for both the global and the personalized
    model. ``seed`` is the trainer's round seed. Metrics are (C,) tensors
    ``global_loss`` / ``global_accuracy`` (before),
    ``personalized_loss`` / ``personalized_accuracy`` (after) and
    ``n_holdout``."""
    if not 0.0 < finetune_fraction < 1.0:
        raise ValueError("finetune_fraction must be in (0, 1)")
    cfg = dataclasses.replace(training, local_epochs=finetune_epochs)
    local_train = make_local_train_fn(model, cfg, samples_per_client,
                                      mean, std)

    @torch.no_grad()
    def holdout_metrics(params, images_u8, labels, lo, hi, batch_stats):
        x = (images_u8.float() / 255.0 - mean) / std
        logits = model(params, x, train=False, **model_kwargs(batch_stats))
        idx = torch.arange(labels.shape[1], device=labels.device)[None, :]
        msk = ((idx >= lo[:, None]) & (idx < hi[:, None])).float()
        denom = torch.clamp(msk.sum(1), min=1.0)
        per = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              labels.reshape(-1), reduction="none"
                              ).reshape(labels.shape)
        loss = (per * msk).sum(1) / denom
        acc = ((logits.argmax(-1) == labels).float() * msk).sum(1) / denom
        return loss, acc

    def personalize(params, images_u8, labels, n_valid, seed: int,
                    batch_stats=None):
        n = torch.clamp(n_valid.to(torch.int32), min=1)
        # ≥1 fine-tune sample and ≥1 holdout sample whenever n ≥ 2; n == 1
        # has no valid split: n_ft = 1 and an empty holdout, which weighs
        # the client zero in the summaries
        n_ft = torch.minimum(
            torch.clamp((n.float() * finetune_fraction).to(torch.int32),
                        min=1),
            torch.clamp(n - 1, min=1))
        if batch_stats is None:
            tuned, _ = local_train(params, images_u8, labels, n_ft, seed)
            tuned_stats = None
        else:
            tuned, _, extra = local_train(
                params, images_u8, labels, n_ft, seed,
                extra={"batch_stats": batch_stats})
            tuned_stats = extra["batch_stats"]
        g_loss, g_acc = holdout_metrics(params, images_u8, labels, n_ft, n,
                                        batch_stats)
        p_loss, p_acc = holdout_metrics(tuned, images_u8, labels, n_ft, n,
                                        tuned_stats)
        return {
            "global_loss": g_loss,
            "global_accuracy": g_acc,
            "personalized_loss": p_loss,
            "personalized_accuracy": p_acc,
            "n_holdout": (n - n_ft).to(torch.int32),
        }

    return personalize


def evaluate_personalization(engine, finetune_epochs: int = 1,
                             finetune_fraction: float = 0.8
                             ) -> Dict[str, object]:
    """Run the personalization protocol over every client of a
    :class:`~fl_tpu_torch.orchestration.round_engine.FederatedRoundEngine`
    at its current global model, the engine untouched. Returns per-client
    arrays plus means weighted by each client's holdout size (the accuracy
    over the pooled holdout set) and the mean gain."""
    run = make_personalization_fn(
        engine.model, engine.config.training,
        samples_per_client=engine.data.samples_per_client,
        mean=engine.data.mean, std=engine.data.std,
        finetune_epochs=finetune_epochs,
        finetune_fraction=finetune_fraction)

    C = engine.num_clients
    stacked = tree_map(lambda v: v[None].expand(C, *v.shape),
                       engine.global_variables)
    seed = prng.stream_seed(prng.round_seed(engine._root,
                                            engine.round_number),
                            prng.Stream.PERSONALIZE)
    out = run(stacked["params"], engine.data.images, engine.data.labels,
              engine.data.num_samples, seed, stacked.get("batch_stats"))
    out = {k: v.cpu().numpy() for k, v in out.items()}

    w = out["n_holdout"].astype(np.float64)
    w = w / max(w.sum(), 1.0)
    summary = {
        f"mean_{k}": float((out[k] * w).sum())
        for k in ("global_accuracy", "personalized_accuracy",
                  "global_loss", "personalized_loss")
    }
    summary["mean_personalization_gain"] = (
        summary["mean_personalized_accuracy"]
        - summary["mean_global_accuracy"])
    return {"per_client": out, **summary}
