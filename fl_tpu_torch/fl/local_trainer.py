"""Host-side LocalTrainer facade for single-client (deployment) training
(port of ``fl_tpu.fl.local_trainer``).

Parity target: ``LocalTrainer`` (src/shared/training.py:28-404): the
features the stacked population path leaves out because they need
data-dependent control flow: a per-client train/validation split, early
stopping on validation loss, epoch checkpoints, and a full evaluation with
per-class accuracy. In deployment mode (one client a process) these are
host-side concerns, so this facade drives the SAME local-training function
the round engines run over the stacked client axis
(``fl.local_training.make_local_train_fn``), at one client and one epoch a
call, with a Python epoch loop around it.

The reference's train/val ``random_split`` bug (independent overlapping
splits, data_loader.py:344-390) is not reproduced: one permutation defines
both splits. Each epoch's seed is fold(client 0 of round ``round_number``
of root ``seed``, epoch), the reference's key structure.
"""

from __future__ import annotations

import dataclasses
import io
import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from fl_tpu_torch.core import prng
from fl_tpu_torch.core.mesh import resolve_device
from fl_tpu_torch.core.pytree import tree_map
from fl_tpu_torch.core.types import to_numpy
from fl_tpu_torch.fl.local_training import (
    FederatedTrainingConfig,
    evaluate_u8_test_set,
    make_local_train_fn,
    train_variables,
)
from fl_tpu_torch.models.factory import get_model_weights, set_model_weights

logger = logging.getLogger(__name__)


class LocalTrainer:
    """ref: LocalTrainer, src/shared/training.py:28-404. ``device``: where
    the client trains; None is the card."""

    def __init__(
        self,
        model,
        config: Optional[FederatedTrainingConfig] = None,
        checkpoint_dir: Optional[str] = None,
        seed: int = 0,
        device=None,
    ):
        self.model = model
        self.config = config or FederatedTrainingConfig()
        self.checkpoint_dir = Path(checkpoint_dir) if checkpoint_dir else None
        self.seed = seed
        self.device = resolve_device("LocalTrainer", device, None)
        self._epoch_fns: Dict[int, Any] = {}  # keyed by shard length
        self.training_history: list = []

    # ------------------------------------------------------------------
    def _epoch_fn(self, n_pad: int, mean, std):
        if n_pad not in self._epoch_fns:
            one_epoch_cfg = dataclasses.replace(self.config, local_epochs=1)
            self._epoch_fns[n_pad] = make_local_train_fn(
                self.model, one_epoch_cfg, samples_per_client=n_pad,
                mean=self._stat(mean), std=self._stat(std))
        return self._epoch_fns[n_pad]

    def _stat(self, v) -> torch.Tensor:
        return torch.as_tensor(np.asarray(to_numpy(v), np.float32),
                               device=self.device)

    @staticmethod
    def _pad(images: np.ndarray, labels: np.ndarray, batch: int
             ) -> Tuple[np.ndarray, np.ndarray, int]:
        n = len(images)
        n_pad = max(batch, ((n + batch - 1) // batch) * batch)
        if n_pad != n:
            images = np.concatenate(
                [images, np.zeros((n_pad - n,) + images.shape[1:],
                                  images.dtype)])
            labels = np.concatenate(
                [labels, np.zeros((n_pad - n,), labels.dtype)])
        return images, labels, n

    # -- the main entry (ref: train_local_model, training.py:60-171) --------
    def train_local_model(
        self,
        variables,
        images_u8: np.ndarray,
        labels: np.ndarray,
        mean,
        std,
        epochs: Optional[int] = None,
        round_number: int = 0,
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Train with a held-out validation split and optional early
        stopping; returns (best_variables, metrics). ``variables`` is one
        model's unstacked variables dict on the trainer's device."""
        cfg = self.config
        epochs = epochs or cfg.local_epochs
        rng = np.random.default_rng(self.seed + round_number)

        # one permutation -> disjoint train/val (the reference's overlap
        # bug fixed)
        images_u8 = np.asarray(images_u8)
        labels = np.asarray(labels)
        perm = rng.permutation(len(images_u8))
        n_val = int(len(perm) * cfg.validation_split)
        val_idx, train_idx = perm[:n_val], perm[n_val:]
        xt, yt, n_train = self._pad(images_u8[train_idx], labels[train_idx],
                                    cfg.batch_size)

        epoch_fn = self._epoch_fn(len(xt), mean, std)
        xt = torch.as_tensor(xt, device=self.device)[None]
        yt = torch.as_tensor(yt.astype(np.int64), device=self.device)[None]
        n_valid = torch.tensor([n_train], device=self.device)
        cseed = prng.client_seed(
            prng.round_seed(prng.root_seed(self.seed), round_number), 0)

        best_vars = variables
        best_val = float("inf")
        stale = 0
        history = []
        t0 = time.time()
        for epoch in range(epochs):
            stacked = tree_map(lambda v: v[None], variables)
            new, metrics = train_variables(
                epoch_fn, stacked, xt, yt, n_valid,
                prng.fold(cseed, epoch))
            variables = tree_map(lambda v: v[0], new)
            entry = {
                "epoch": epoch,
                "train_loss": float(metrics["loss"][0]),
                "train_accuracy": float(metrics["accuracy"][0]),
            }
            if n_val > 0:
                ev = evaluate_u8_test_set(
                    self.model, variables, images_u8[val_idx],
                    labels[val_idx], mean, std, self.device)
                entry["val_loss"] = ev["loss"]
                entry["val_accuracy"] = ev["accuracy"]
                if entry["val_loss"] < best_val - 1e-6:
                    best_val = entry["val_loss"]
                    best_vars = variables
                    stale = 0
                else:
                    stale += 1
            history.append(entry)
            if cfg.save_checkpoints and self.checkpoint_dir:
                self._save_checkpoint(epoch, variables, entry)
            if (cfg.early_stopping_patience is not None and n_val > 0
                    and stale >= cfg.early_stopping_patience):
                logger.info("early stopping at epoch %d (no val improvement "
                            "for %d epochs)", epoch,
                            cfg.early_stopping_patience)
                break
        final_vars = best_vars if (n_val > 0 and cfg.early_stopping_patience
                                   is not None) else variables
        summary = {
            "epochs_completed": len(history),
            "training_time": time.time() - t0,
            "final_train_loss": history[-1]["train_loss"],
            "final_val_loss": history[-1].get("val_loss"),
            "best_val_loss": best_val if n_val > 0 else None,
            "history": history,
            "samples_processed": n_train * len(history),
        }
        self.training_history.append(summary)
        return final_vars, summary

    # -- evaluation (ref: evaluate_model, training.py:307-360) ---------------
    def evaluate_model(self, variables, images_u8, labels,
                       mean, std) -> Dict[str, Any]:
        return evaluate_u8_test_set(self.model, variables, images_u8,
                                    labels, mean, std, self.device,
                                    per_class=True)

    # -- checkpoints (ref: _save_checkpoint/load_checkpoint,
    #    training.py:257-305) ------------------------------------------------
    def _save_checkpoint(self, epoch: int, variables,
                         entry: Dict[str, Any]) -> None:
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        weights = {k: to_numpy(v)
                   for k, v in get_model_weights(variables).items()}
        buf = io.BytesIO()
        np.savez(buf, **weights)
        path = self.checkpoint_dir / f"checkpoint_epoch_{epoch}.npz"
        path.write_bytes(buf.getvalue())
        latest = self.checkpoint_dir / "latest_checkpoint.npz"
        latest.write_bytes(buf.getvalue())
        meta = {"epoch": epoch, **{k: v for k, v in entry.items()
                                   if isinstance(v, (int, float))}}
        (self.checkpoint_dir / "latest_checkpoint.json").write_text(
            json.dumps(meta))

    def load_checkpoint(self, variables, path: Optional[str] = None
                        ) -> Tuple[Dict[str, Any], Dict]:
        if path is None:
            if self.checkpoint_dir is None:
                raise FileNotFoundError("no checkpoint directory configured")
            path = str(self.checkpoint_dir / "latest_checkpoint.npz")
        with np.load(path, allow_pickle=False) as z:
            weights = {k: z[k] for k in z.files}
        restored = set_model_weights(variables, weights)
        meta_path = Path(path).with_suffix(".json")
        meta = (json.loads(meta_path.read_text())
                if meta_path.exists() else {})
        return restored, meta


def validate_training_data(images, labels, num_classes: int = 10
                           ) -> Dict[str, Any]:
    """Sanity-check a training shard (ref: validate_training_data,
    training.py:504-558)."""
    images = np.asarray(images)
    labels = np.asarray(labels)
    problems = []
    if len(images) != len(labels):
        problems.append("images/labels length mismatch")
    if len(images) == 0:
        problems.append("empty dataset")
    if labels.size and (labels.min() < 0 or labels.max() >= num_classes):
        problems.append("labels out of range")
    if not np.all(np.isfinite(images.astype(np.float32))):
        problems.append("non-finite pixel values")
    hist = np.bincount(labels, minlength=num_classes) if labels.size else []
    return {
        "valid": not problems,
        "problems": problems,
        "num_samples": int(len(images)),
        "class_distribution": np.asarray(hist).tolist(),
    }
