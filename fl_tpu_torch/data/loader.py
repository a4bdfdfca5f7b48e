"""Data-loader facade + factory.

A copy of ``fl_tpu.data.loader`` (numpy only): one object that owns the
dataset, the partition, per-client host views and the stacked arrays that
``FederatedRoundEngine`` puts on the device. The same arguments give the
same arrays as the reference's loader.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

from fl_tpu_torch.data.datasets import DatasetSplits, load_dataset
from fl_tpu_torch.data.federated import (
    FederatedArrays,
    FederatedDataset,
    analyze_data_distribution,
    make_federated_arrays,
)
from fl_tpu_torch.fl.partition import partition_indices

logger = logging.getLogger(__name__)


class FederatedDataLoader:
    """Owns dataset + federated partition; hands out host views and the
    device-ready stacked arrays."""

    def __init__(
        self,
        dataset: str = "mnist",
        num_clients: int = 10,
        partition_strategy: str = "iid",
        alpha: float = 0.5,
        min_samples_per_client: int = 10,
        samples_per_client: Optional[int] = None,
        seed: int = 0,
        n_train_synth: int = 20_000,
        n_test_synth: int = 4_000,
    ):
        self.splits: DatasetSplits = load_dataset(
            dataset, n_train_synth=n_train_synth, n_test_synth=n_test_synth,
            seed=seed,
        )
        self.num_clients = num_clients
        self.partition_strategy = partition_strategy
        self.alpha = alpha
        self.seed = seed
        self.partitions: List[np.ndarray] = partition_indices(
            self.splits.train_labels, num_clients, partition_strategy, alpha,
            min_samples_per_client, seed=seed,
        )
        self._arrays: Optional[FederatedArrays] = None
        self._samples_per_client = samples_per_client
        self._min_samples = min_samples_per_client

    # -- per-client host views ---------------------------------------------
    def get_client_dataset(self, client_id: int) -> FederatedDataset:
        return FederatedDataset(self.splits, self.partitions[client_id], client_id)

    def get_client_statistics(self) -> Dict[int, Dict[str, object]]:
        return {c: self.get_client_dataset(c).get_statistics()
                for c in range(self.num_clients)}

    # -- device layout ------------------------------------------------------
    def get_federated_arrays(self) -> FederatedArrays:
        if self._arrays is None:
            arrays = make_federated_arrays(
                self.splits, self.num_clients, self.partition_strategy,
                self.alpha, self._min_samples,
                samples_per_client=self._samples_per_client, seed=self.seed,
            )
            # reuse the already-computed partition for consistency
            self._arrays = arrays
        return self._arrays

    def get_test_set(self):
        """Normalized global test set (host numpy, float32)."""
        x = self.splits.normalized(self.splits.test_images)
        return x, self.splits.test_labels

    def analyze_distribution(self) -> Dict[str, object]:
        return analyze_data_distribution(self.splits, self.partitions)


def create_data_loader(
    dataset: str = "mnist",
    num_clients: int = 10,
    partition_strategy: str = "iid",
    **kwargs,
) -> FederatedDataLoader:
    """Build a :class:`FederatedDataLoader` and log what it holds."""
    loader = FederatedDataLoader(
        dataset=dataset, num_clients=num_clients,
        partition_strategy=partition_strategy, **kwargs,
    )
    logger.info(
        "Created %s loader: %d clients, %s partitioning%s",
        dataset, num_clients, partition_strategy,
        " (synthetic fallback)" if loader.splits.synthetic else "",
    )
    return loader
