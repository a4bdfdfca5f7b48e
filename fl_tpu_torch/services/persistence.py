"""Coordinator-side global-model persistence and restart resume (port of
``fl_tpu.services.persistence``).

The reference designed this but never wired it: ``GlobalModelModel`` rows
store a ``model_path`` (weights on disk, metadata in the DB,
src/shared/database.py:190-219), yet no live code writes those rows and
the coordinator cannot resume a round after a restart. Here the
deployment coordinator persists every aggregated global model and restores
the newest one on startup:

- weights → ``<dir>/global_model_round_{N}.npz`` (the native npz codec of
  ``services.serialization``; device tensors are copied to the host);
- metadata → a ``global_models`` row through
  ``services.database.DatabaseRepository.save_global_model``;
- ``FederatedLearningServicer(persistence=...)`` restores
  ``(current_round, global_model)`` before serving, so clients joining a
  restarted coordinator continue from the last aggregated round.

The files and rows are the reference package's: a directory written by
either package restores in the other, bit for bit. Engine-side
checkpointing is separate (``orchestration.checkpoint``).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional, Tuple

from fl_tpu_torch.core.types import GlobalModel
from fl_tpu_torch.services.database import (
    DatabaseRepository,
    create_database_manager,
)
from fl_tpu_torch.services.serialization import ModelWeightSerializer

logger = logging.getLogger(__name__)


class CoordinatorPersistence:
    """Weights-on-disk + sqlite-metadata store for the coordinator."""

    def __init__(self, directory: str,
                 database_url: Optional[str] = None,
                 repository: Optional[DatabaseRepository] = None):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        if repository is None:
            if database_url is None:
                database_url = ("sqlite:///"
                                + os.path.join(directory, "coordinator.db"))
            manager = create_database_manager(database_url)
            manager.create_tables()
            repository = DatabaseRepository(manager)
        self.repository = repository
        self._serializer = ModelWeightSerializer()

    # ------------------------------------------------------------------
    def save_global_model(self, model: GlobalModel,
                          train_loss: Optional[float] = None) -> str:
        """Persist one aggregated global model; returns the weights path."""
        path = os.path.join(
            self.directory, f"global_model_round_{model.round_number}.npz"
        )
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(self._serializer.serialize_weights(model.model_weights))
        os.replace(tmp, path)  # atomic: a crash never leaves a torn file
        self.repository.save_global_model(
            model.round_number, path,
            accuracy_metrics=dict(model.accuracy_metrics),
            convergence_score=model.convergence_score,
        )
        acc = model.get_accuracy()
        if acc is None:
            acc = model.get_accuracy("train")
        self.repository.save_round(
            model.round_number, status="completed",
            completed_at=time.time(),
            participating_clients=len(model.participating_clients),
            avg_training_loss=train_loss,
            global_accuracy=acc,
            convergence_score=model.convergence_score,
        )
        return path

    def load_latest(self) -> Optional[Tuple[int, GlobalModel]]:
        """Newest persisted (round_number, GlobalModel), or None."""
        row = self.repository.get_latest_global_model()
        if row is None:
            return None
        path = row["model_path"]
        if not os.path.exists(path):
            logger.warning("global model row for round %s points at missing "
                           "file %s; ignoring", row["round_number"], path)
            return None
        with open(path, "rb") as f:
            weights = self._serializer.deserialize_weights(f.read())
        metrics = {}
        try:
            metrics = json.loads(row.get("accuracy_metrics_json") or "{}")
        except (TypeError, ValueError):
            pass
        model = GlobalModel(
            round_number=int(row["round_number"]),
            model_weights=weights,
            accuracy_metrics=metrics,
            convergence_score=float(row.get("convergence_score") or 0.0),
            created_at=float(row.get("created_at") or time.time()),
        )
        return int(row["round_number"]), model
