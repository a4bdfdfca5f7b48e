"""Federated data partitioning: IID, Dirichlet non-IID, pathological.

A copy of ``fl_tpu.fl.partition`` (numpy only), so the port imports no JAX.

Parity target: ``DataPartitioner`` (src/shared/data_loader.py:65-265), with
the same three strategies and semantics:

- ``iid``: global shuffle, even split, last client takes the remainder
  (ref :118-137).
- ``non_iid``: per-class Dirichlet(α) proportions with a min-samples floor
  and renormalization (ref :139-177).
- ``pathological``: each client sees only ``classes_per_client`` classes
  (ref :179-240, default 1-2 classes).

Differences (deliberate): pure numpy index ops on a label array — no
iterating a Dataset object per sample (the reference walks the whole torch
dataset once per partitioner construction, ref :100-105); and randomness is
an explicit ``numpy.random.Generator`` so partitions are reproducible and
resume-safe (the reference uses global ``random``/``np.random`` state).
The reference's per-strategy quirks that are *bugs* are not reproduced (see
SURVEY.md appendix: overlapping train/val random_split).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _iid(labels: np.ndarray, num_clients: int, rng: np.random.Generator
         ) -> List[np.ndarray]:
    idx = rng.permutation(len(labels))
    per = len(labels) // num_clients
    parts = [idx[c * per: (c + 1) * per] for c in range(num_clients - 1)]
    parts.append(idx[(num_clients - 1) * per:])
    return parts


def _dirichlet(labels: np.ndarray, num_clients: int, alpha: float,
               min_samples: int, rng: np.random.Generator) -> List[np.ndarray]:
    parts: List[List[int]] = [[] for _ in range(num_clients)]
    for cls in np.unique(labels):
        cls_idx = np.flatnonzero(labels == cls)
        rng.shuffle(cls_idx)
        props = rng.dirichlet([alpha] * num_clients)
        # min-samples floor + renormalize (ref: data_loader.py:152-156)
        floor = min_samples / len(cls_idx)
        props = np.maximum(props, floor)
        props = props / props.sum()
        counts = (props * len(cls_idx)).astype(int)
        start = 0
        for c in range(num_clients):
            stop = len(cls_idx) if c == num_clients - 1 else start + counts[c]
            parts[c].extend(cls_idx[start:stop].tolist())
            start = stop
    out = []
    for c in range(num_clients):
        arr = np.asarray(parts[c], dtype=np.int64)
        rng.shuffle(arr)
        out.append(arr)
    return out


def _pathological(labels: np.ndarray, num_clients: int, num_classes: int,
                  classes_per_client: Optional[int],
                  rng: np.random.Generator) -> List[np.ndarray]:
    if classes_per_client is None:
        classes_per_client = max(1, num_classes // num_clients)
    class_order = rng.permutation(num_classes)
    # assign each client a contiguous window of the shuffled class list
    assignments = []
    for c in range(num_clients):
        start = (c * classes_per_client) % num_classes
        assignments.append(
            [int(class_order[(start + i) % num_classes])
             for i in range(classes_per_client)]
        )
    # how many clients share each class
    holders: Dict[int, int] = {}
    for cls_list in assignments:
        for cls in cls_list:
            holders[cls] = holders.get(cls, 0) + 1
    # split each class evenly among its holders
    cursors: Dict[int, int] = {}
    shuffled: Dict[int, np.ndarray] = {}
    for cls in holders:
        cls_idx = np.flatnonzero(labels == cls)
        rng.shuffle(cls_idx)
        shuffled[cls] = cls_idx
        cursors[cls] = 0
    parts: List[np.ndarray] = []
    for c in range(num_clients):
        chunks = []
        for cls in assignments[c]:
            cls_idx = shuffled[cls]
            per = len(cls_idx) // holders[cls]
            start = cursors[cls]
            chunks.append(cls_idx[start: start + per])
            cursors[cls] = start + per
        arr = np.concatenate(chunks) if chunks else np.zeros((0,), np.int64)
        rng.shuffle(arr)
        parts.append(arr)
    return parts


def partition_indices(
    labels: Sequence[int],
    num_clients: int,
    strategy: str = "iid",
    alpha: float = 0.5,
    min_samples_per_client: int = 10,
    classes_per_client: Optional[int] = None,
    seed: int = 0,
) -> List[np.ndarray]:
    """Partition sample indices across clients. Returns one int64 index array
    per client (ref: DataPartitioner._create_partitions,
    src/shared/data_loader.py:107-116)."""
    labels = np.asarray(labels, dtype=np.int64)
    if num_clients <= 0:
        raise ValueError("num_clients must be positive")
    rng = np.random.default_rng(seed)
    if strategy == "iid":
        return _iid(labels, num_clients, rng)
    if strategy in ("non_iid", "dirichlet"):
        return _dirichlet(labels, num_clients, alpha, min_samples_per_client, rng)
    if strategy == "pathological":
        num_classes = int(labels.max()) + 1 if len(labels) else 0
        return _pathological(labels, num_clients, num_classes,
                             classes_per_client, rng)
    raise ValueError(f"Unknown partition strategy: {strategy}")


class DataPartitioner:
    """Object facade over :func:`partition_indices`, mirroring the reference
    class surface (src/shared/data_loader.py:65-265)."""

    def __init__(
        self,
        labels: Sequence[int],
        num_clients: int,
        partition_strategy: str = "iid",
        alpha: float = 0.5,
        min_samples_per_client: int = 10,
        seed: int = 0,
    ):
        self.labels = np.asarray(labels, dtype=np.int64)
        self.num_clients = num_clients
        self.partition_strategy = partition_strategy
        self.alpha = alpha
        self.min_samples_per_client = min_samples_per_client
        self.num_classes = len(np.unique(self.labels))
        self.client_indices: Dict[int, np.ndarray] = dict(
            enumerate(
                partition_indices(
                    self.labels,
                    num_clients,
                    partition_strategy,
                    alpha,
                    min_samples_per_client,
                    seed=seed,
                )
            )
        )

    def get_client_indices(self, client_id: int) -> np.ndarray:
        return self.client_indices[client_id]

    def get_partition_statistics(self) -> Dict[str, object]:
        """Per-client sample counts and class histograms
        (ref: analyze_data_distribution, src/shared/data_loader.py:627-670)."""
        counts = {c: len(ix) for c, ix in self.client_indices.items()}
        hists = {
            c: np.bincount(self.labels[ix], minlength=self.num_classes).tolist()
            for c, ix in self.client_indices.items()
        }
        sizes = np.asarray(list(counts.values()), dtype=np.float64)
        return {
            "samples_per_client": counts,
            "class_histograms": hists,
            "min_samples_per_client": int(sizes.min()) if len(sizes) else 0,
            "max_samples_per_client": int(sizes.max()) if len(sizes) else 0,
            "mean_samples_per_client": float(sizes.mean()) if len(sizes) else 0.0,
            "std_samples_per_client": float(sizes.std()) if len(sizes) else 0.0,
        }
