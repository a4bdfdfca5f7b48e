"""Device-resident federated data: padded, stacked client shards.

The layout of ``fl_tpu.data.federated``: every client shard is padded to a
common ``samples_per_client`` and stacked into one ``(C, N, H, W, ch)``
uint8 tensor that goes to the device **once**; local steps gather their
batches on the device and normalize there (``fl_tpu_torch.fl.
local_training``), so device memory holds the 4x smaller uint8 form and
training moves no data across the host link.

``num_samples[c]`` is the true shard size; padded slots are remapped into
the valid region by the per-epoch shuffle and masked out of FedAvg
weighting.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fl_tpu_torch.core.mesh import shard_client_tree
from fl_tpu_torch.data.datasets import DatasetSplits
from fl_tpu_torch.fl.partition import partition_indices


@dataclasses.dataclass
class FederatedArrays:
    """Stacked client shards: numpy on construction, torch tensors after
    :meth:`to_device`."""

    images: object        # (C, N, H, W, ch) uint8
    labels: object        # (C, N) int32 (int64 on the device)
    num_samples: object   # (C,) int32 — true (unpadded) counts
    mean: object          # (ch,) float32
    std: object           # (ch,) float32
    num_classes: int

    @property
    def num_clients(self) -> int:
        return self.images.shape[0]

    @property
    def samples_per_client(self) -> int:
        return self.images.shape[1]

    def to_device(self, device=None, mesh=None) -> "FederatedArrays":
        """Copies of every array on ``device`` (labels as int64, the index
        type torch's losses take). With a client ``mesh``
        (``core.mesh.ClientMesh``) only this rank's rows of the client
        arrays go to the mesh's device (the reference's sharded upload)."""
        if mesh is not None:
            device = mesh.device

        def put(a, dtype=None, rows=False):
            a = np.asarray(a)
            t = (shard_client_tree(a, mesh) if rows and mesh is not None
                 else torch.as_tensor(a))
            return t.to(device=device, dtype=dtype or t.dtype)

        return dataclasses.replace(
            self,
            images=put(self.images, rows=True),
            labels=put(self.labels, torch.int64, rows=True),
            num_samples=put(self.num_samples, torch.int32, rows=True),
            mean=put(self.mean, torch.float32),
            std=put(self.std, torch.float32),
        )


class FederatedDataset:
    """Host-side view of one client's shard of the training set."""

    def __init__(self, splits: DatasetSplits, indices: np.ndarray, client_id: int):
        self.splits = splits
        self.indices = np.asarray(indices, np.int64)
        self.client_id = client_id

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        j = self.indices[i]
        return self.splits.train_images[j], int(self.splits.train_labels[j])

    def get_statistics(self) -> Dict[str, object]:
        """Class histogram and counts."""
        labels = self.splits.train_labels[self.indices]
        hist = np.bincount(labels, minlength=self.splits.num_classes)
        return {
            "client_id": self.client_id,
            "num_samples": int(len(self.indices)),
            "class_distribution": {int(c): int(n) for c, n in enumerate(hist)},
            "num_classes_present": int((hist > 0).sum()),
        }


def make_federated_arrays(
    splits: DatasetSplits,
    num_clients: int,
    strategy: str = "iid",
    alpha: float = 0.5,
    min_samples_per_client: int = 10,
    samples_per_client: Optional[int] = None,
    seed: int = 0,
) -> FederatedArrays:
    """Partition ``splits`` and build the stacked layout — the same arrays
    as ``fl_tpu.data.make_federated_arrays`` for the same arguments.

    ``samples_per_client`` pads/caps every shard to a fixed length
    (default: the largest shard rounded up to a multiple of 8). Capping
    keeps each shard's first indices; padding repeats index 0 and is
    masked out through ``num_samples``.
    """
    parts: List[np.ndarray] = partition_indices(
        splits.train_labels, num_clients, strategy, alpha,
        min_samples_per_client, seed=seed,
    )
    counts = np.asarray([len(p) for p in parts], np.int32)
    if samples_per_client is None:
        samples_per_client = int(max(8, ((counts.max() + 7) // 8) * 8))
    n = samples_per_client

    img_shape = splits.train_images.shape[1:]
    images = np.zeros((num_clients, n) + img_shape, dtype=np.uint8)
    labels = np.zeros((num_clients, n), dtype=np.int32)
    for c, idx in enumerate(parts):
        take = idx[:n]
        images[c, : len(take)] = splits.train_images[take]
        labels[c, : len(take)] = splits.train_labels[take]
    counts = np.minimum(counts, n).astype(np.int32)

    return FederatedArrays(
        images=images,
        labels=labels,
        num_samples=counts,
        mean=np.asarray(splits.mean, np.float32),
        std=np.asarray(splits.std, np.float32),
        num_classes=splits.num_classes,
    )


def analyze_data_distribution(
    splits: DatasetSplits, parts: Sequence[np.ndarray]
) -> Dict[str, object]:
    """Cross-client distribution statistics: shard sizes, class histograms
    and the mean pairwise total-variation distance between clients."""
    sizes = np.asarray([len(p) for p in parts], np.float64)
    hists = np.stack(
        [np.bincount(splits.train_labels[p], minlength=splits.num_classes)
         for p in parts]
    ).astype(np.float64)
    probs = hists / np.maximum(hists.sum(axis=1, keepdims=True), 1.0)
    # mean pairwise total-variation distance as a non-IID-ness score
    C = len(parts)
    tv = 0.0
    pairs = 0
    for i in range(C):
        for j in range(i + 1, C):
            tv += 0.5 * np.abs(probs[i] - probs[j]).sum()
            pairs += 1
    return {
        "num_clients": C,
        "overall_statistics": {
            "total_samples": int(sizes.sum()),
            "min_samples_per_client": int(sizes.min()) if C else 0,
            "max_samples_per_client": int(sizes.max()) if C else 0,
            "mean_samples_per_client": float(sizes.mean()) if C else 0.0,
            "std_samples_per_client": float(sizes.std()) if C else 0.0,
        },
        "class_distributions": hists.astype(int).tolist(),
        "mean_pairwise_tv_distance": float(tv / pairs) if pairs else 0.0,
    }
