"""Dataset loading: real MNIST/CIFAR-10 files when available, synthetic
fallback otherwise.

A copy of ``fl_tpu.data.datasets`` (numpy only): the same files, seeds and
arrays, without importing JAX.

Parity target: MNISTDataLoader / CIFAR10DataLoader
(src/shared/data_loader.py:267-579). Normalization constants match the
reference exactly: MNIST (0.1307, 0.3081) (ref :300), CIFAR-10
(0.4914, 0.4822, 0.4465) / (0.2023, 0.1994, 0.2010) (ref :458).
Augmentation (random crop with 4-px padding + horizontal flip for CIFAR,
ref :455-456) is applied on the device inside the training step
(``fl_tpu_torch.ops.preprocess.make_cifar_augment``, the engine's
``augment_fn``), not here.

Real-data discovery: set ``FL_TPU_DATA_DIR`` (or place files under
``~/.cache/fl_tpu``). MNIST: the four IDX files (optionally .gz);
CIFAR-10: the python-pickle batches directory ``cifar-10-batches-py``.
Zero-egress environments without these files get the deterministic
synthetic datasets from fl_tpu_torch.data.synthetic (clearly logged).
"""

from __future__ import annotations

import gzip
import logging
import os
import pickle
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from fl_tpu_torch.data import synthetic

logger = logging.getLogger(__name__)

MNIST_MEAN = (0.1307,)
MNIST_STD = (0.3081,)
CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2023, 0.1994, 0.2010)


@dataclass
class DatasetSplits:
    """Raw uint8 NHWC images + int labels, plus normalization constants."""

    name: str
    train_images: np.ndarray  # (N, H, W, C) uint8
    train_labels: np.ndarray  # (N,) int64
    test_images: np.ndarray
    test_labels: np.ndarray
    mean: Tuple[float, ...]
    std: Tuple[float, ...]
    num_classes: int
    synthetic: bool = False

    @property
    def input_shape(self) -> Tuple[int, int, int]:
        return tuple(self.train_images.shape[1:])  # type: ignore[return-value]

    def normalized(self, images: np.ndarray) -> np.ndarray:
        """uint8 -> float32 normalized (the transform pipeline of ref
        data_loader.py:296-306 / :452-464, minus augmentation)."""
        x = images.astype(np.float32) / 255.0
        mean = np.asarray(self.mean, np.float32)
        std = np.asarray(self.std, np.float32)
        return (x - mean) / std


def _data_dirs() -> list:
    dirs = []
    env = os.environ.get("FL_TPU_DATA_DIR")
    if env:
        dirs.append(Path(env))
    dirs.append(Path.home() / ".cache" / "fl_tpu")
    return dirs


# --- MNIST IDX parsing ------------------------------------------------------

def _open_maybe_gz(path: Path):
    return gzip.open(path, "rb") if path.suffix == ".gz" else open(path, "rb")


def _read_idx(path: Path) -> np.ndarray:
    """Parse an IDX-format file (images or labels)."""
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find(base: Path, stem: str) -> Optional[Path]:
    for cand in (base / stem, base / f"{stem}.gz", base / "MNIST" / "raw" / stem,
                 base / "MNIST" / "raw" / f"{stem}.gz"):
        if cand.exists():
            return cand
    return None


def _try_real_mnist() -> Optional[DatasetSplits]:
    for base in _data_dirs():
        files = {
            "xtr": _find(base, "train-images-idx3-ubyte"),
            "ytr": _find(base, "train-labels-idx1-ubyte"),
            "xte": _find(base, "t10k-images-idx3-ubyte"),
            "yte": _find(base, "t10k-labels-idx1-ubyte"),
        }
        if all(files.values()):
            logger.info("Loading real MNIST from %s", base)
            return DatasetSplits(
                name="mnist",
                train_images=_read_idx(files["xtr"])[..., None],
                train_labels=_read_idx(files["ytr"]).astype(np.int64),
                test_images=_read_idx(files["xte"])[..., None],
                test_labels=_read_idx(files["yte"]).astype(np.int64),
                mean=MNIST_MEAN, std=MNIST_STD, num_classes=10,
            )
    return None


# --- CIFAR-10 pickle batches -------------------------------------------------

def _try_real_cifar10() -> Optional[DatasetSplits]:
    for base in _data_dirs():
        d = base / "cifar-10-batches-py"
        if not (d / "test_batch").exists():
            continue
        logger.info("Loading real CIFAR-10 from %s", d)

        def read_batch(p: Path):
            with open(p, "rb") as f:
                raw = pickle.load(f, encoding="bytes")
            x = raw[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            y = np.asarray(raw[b"labels"], np.int64)
            return x, y

        xs, ys = [], []
        for i in range(1, 6):
            x, y = read_batch(d / f"data_batch_{i}")
            xs.append(x)
            ys.append(y)
        xte, yte = read_batch(d / "test_batch")
        return DatasetSplits(
            name="cifar10",
            train_images=np.concatenate(xs), train_labels=np.concatenate(ys),
            test_images=xte, test_labels=yte,
            mean=CIFAR10_MEAN, std=CIFAR10_STD, num_classes=10,
        )
    return None


def load_dataset(
    name: str,
    n_train_synth: int = 20_000,
    n_test_synth: int = 4_000,
    seed: int = 0,
) -> DatasetSplits:
    """Load a dataset by name (ref factory: create_data_loader,
    src/shared/data_loader.py:581-624)."""
    name = name.lower()
    if name == "mnist":
        real = _try_real_mnist()
        if real is not None:
            return real
        logger.warning("Real MNIST not found; using deterministic synthetic MNIST")
        xtr, ytr, xte, yte = synthetic.synthetic_mnist(n_train_synth, n_test_synth,
                                                       seed=1234 + seed)
        return DatasetSplits("mnist", xtr, ytr, xte, yte,
                             MNIST_MEAN, MNIST_STD, 10, synthetic=True)
    if name == "cifar10":
        real = _try_real_cifar10()
        if real is not None:
            return real
        logger.warning("Real CIFAR-10 not found; using synthetic CIFAR-10")
        xtr, ytr, xte, yte = synthetic.synthetic_cifar10(n_train_synth, n_test_synth,
                                                         seed=4321 + seed)
        return DatasetSplits("cifar10", xtr, ytr, xte, yte,
                             CIFAR10_MEAN, CIFAR10_STD, 10, synthetic=True)
    raise ValueError(f"Unsupported dataset: {name}. Supported: mnist, cifar10")
