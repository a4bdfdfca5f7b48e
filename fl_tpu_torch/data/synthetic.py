"""Deterministic synthetic datasets (MNIST-like digits, CIFAR-like textures).

A copy of ``fl_tpu.data.synthetic`` (numpy only), kept byte-for-byte equal in
its arithmetic so both packages draw identical datasets from one seed while
the port imports no JAX.

The build/test environment has no network egress and no torchvision, so real
MNIST/CIFAR archives may be absent. This module procedurally generates
class-structured image datasets that a CNN can actually *learn* (not random
noise): digits are rendered from a built-in 5×7 glyph font with random
translation, scale jitter, stroke-intensity variation, and pixel noise;
CIFAR-like images are class-keyed oriented gratings + color tints with
noise. Generation is fully vectorized numpy, keyed by seed.

When real dataset files are present (see fl_tpu_torch.data.datasets), they are
used instead — this is strictly the fallback, and every consumer logs which
source it got.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# 5x7 digit glyphs (classic LCD-style font), rows top->bottom.
_DIGIT_ROWS = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11111", "00010", "00100", "00010", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _glyph(digit: int) -> np.ndarray:
    rows = _DIGIT_ROWS[digit]
    return np.array([[int(ch) for ch in row] for row in rows], dtype=np.float32)


def synthetic_mnist(
    n_train: int = 10_000,
    n_test: int = 2_000,
    seed: int = 1234,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """MNIST-shaped synthetic digits: uint8 images (N, 28, 28, 1) + labels.

    Each sample renders its class glyph at a random integer position and
    scale with varying stroke intensity plus background noise, so a model
    must learn translation-tolerant shape features — qualitatively the same
    task family as MNIST, learnable to >95% by SimpleCNN.
    """
    rng = np.random.default_rng(seed)

    def gen(n: int) -> Tuple[np.ndarray, np.ndarray]:
        labels = rng.integers(0, 10, size=n).astype(np.int64)
        imgs = np.zeros((n, 28, 28), dtype=np.float32)
        scales = rng.integers(2, 4, size=n)  # glyph cell size 2 or 3 px
        intensities = rng.uniform(0.6, 1.0, size=n).astype(np.float32)
        for s in (2, 3):
            h, w = 7 * s, 5 * s
            sel = np.flatnonzero(scales == s)
            if len(sel) == 0:
                continue
            # upscale the 10 glyphs once per scale
            glyphs = np.stack(
                [np.kron(_glyph(d), np.ones((s, s), np.float32)) for d in range(10)]
            )  # (10, h, w)
            ys = rng.integers(0, 28 - h + 1, size=len(sel))
            xs = rng.integers(0, 28 - w + 1, size=len(sel))
            for i, y0, x0 in zip(sel, ys, xs):
                imgs[i, y0:y0 + h, x0:x0 + w] = glyphs[labels[i]] * intensities[i]
        imgs += rng.normal(0.0, 0.08, size=imgs.shape).astype(np.float32)
        imgs = np.clip(imgs, 0.0, 1.0)
        return (imgs * 255).astype(np.uint8)[..., None], labels

    xtr, ytr = gen(n_train)
    xte, yte = gen(n_test)
    return xtr, ytr, xte, yte


def synthetic_cifar10(
    n_train: int = 10_000,
    n_test: int = 2_000,
    seed: int = 4321,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """CIFAR-shaped synthetic textures: uint8 (N, 32, 32, 3) + labels.

    Class k gets an oriented sinusoidal grating (angle k·18°, frequency
    2+k/3 cycles) in a class-keyed color tint, with random phase, contrast,
    and additive noise — learnable but non-trivial."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    tints = np.stack(
        [np.array([np.cos(k), np.cos(k + 2.1), np.cos(k + 4.2)]) * 0.25 + 0.6
         for k in range(10)]
    ).astype(np.float32)  # (10, 3) in ~[0.35, 0.85]

    def gen(n: int) -> Tuple[np.ndarray, np.ndarray]:
        labels = rng.integers(0, 10, size=n).astype(np.int64)
        angle = labels * (np.pi / 10.0)
        freq = (2.0 + labels / 3.0) * (2 * np.pi / 32.0)
        phase = rng.uniform(0, 2 * np.pi, size=n)
        contrast = rng.uniform(0.4, 0.9, size=n)
        proj = (
            np.cos(angle)[:, None, None] * xx[None]
            + np.sin(angle)[:, None, None] * yy[None]
        )
        grating = 0.5 + 0.5 * np.sin(freq[:, None, None] * proj + phase[:, None, None])
        grating = (grating * contrast[:, None, None] + (1 - contrast[:, None, None]) / 2)
        imgs = grating[..., None] * tints[labels][:, None, None, :]
        imgs += rng.normal(0.0, 0.06, size=imgs.shape)
        imgs = np.clip(imgs, 0.0, 1.0).astype(np.float32)
        return (imgs * 255).astype(np.uint8), labels

    xtr, ytr = gen(n_train)
    xte, yte = gen(n_test)
    return xtr, ytr, xte, yte
