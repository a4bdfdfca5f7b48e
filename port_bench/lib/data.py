"""The clients' shards, made from the seed on the device.

A frozen copy of the repository's synthetic MNIST and CIFAR-10 generators
(glyph digits at a random cell size, position and stroke intensity over
pixel noise; class-keyed oriented gratings in class-keyed tints over
noise), vectorized and drawn from one ``torch.Generator`` on the device,
so that a run never reads dataset files that differ from machine to
machine and set-up makes 262,144 images in a few calls. Shards are IID:
image k of client c is draw c·N + k.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_DIGIT_ROWS = (
    ("01110", "10001", "10011", "10101", "11001", "10001", "01110"),
    ("00100", "01100", "00100", "00100", "00100", "00100", "01110"),
    ("01110", "10001", "00001", "00010", "00100", "01000", "11111"),
    ("11111", "00010", "00100", "00010", "00001", "10001", "01110"),
    ("00010", "00110", "01010", "10010", "11111", "00010", "00010"),
    ("11111", "10000", "11110", "00001", "00001", "10001", "01110"),
    ("00110", "01000", "10000", "11110", "10001", "10001", "01110"),
    ("11111", "00001", "00010", "00100", "01000", "01000", "01000"),
    ("01110", "10001", "10001", "01110", "10001", "10001", "01110"),
    ("01110", "10001", "10001", "01111", "00001", "00010", "01100"),
)


def _glyphs(device) -> torch.Tensor:
    return torch.tensor([[[int(ch) for ch in row] for row in rows]
                         for rows in _DIGIT_ROWS], dtype=torch.float32,
                        device=device)  # (10, 7, 5)


def mnist(n: int, g: torch.Generator, device) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """(n, 28, 28, 1) uint8 digits and (n,) int64 labels."""
    labels = torch.randint(0, 10, (n,), generator=g, device=device)
    scale = torch.randint(2, 4, (n,), generator=g, device=device)
    intensity = 0.6 + 0.4 * torch.rand((n,), generator=g, device=device)
    u = torch.rand((2, n), generator=g, device=device)
    y0 = (u[0] * (28 - 7 * scale + 1)).long()
    x0 = (u[1] * (28 - 5 * scale + 1)).long()
    ys = torch.arange(28, device=device)[None, :] - y0[:, None]  # (n, 28)
    xs = torch.arange(28, device=device)[None, :] - x0[:, None]
    gy = torch.div(ys, scale[:, None], rounding_mode="floor")
    gx = torch.div(xs, scale[:, None], rounding_mode="floor")
    in_y = (ys >= 0) & (gy < 7)
    in_x = (xs >= 0) & (gx < 5)
    glyph = _glyphs(device)[labels]  # (n, 7, 5)
    rows = glyph.gather(1, gy.clamp(0, 6)[:, :, None].expand(n, 28, 5))
    img = rows.gather(2, gx.clamp(0, 4)[:, None, :].expand(n, 28, 28))
    img = img * (in_y[:, :, None] & in_x[:, None, :]) * intensity[:, None,
                                                                   None]
    img = img + 0.08 * torch.randn((n, 28, 28), generator=g, device=device)
    img = (img.clamp(0.0, 1.0) * 255).to(torch.uint8)
    return img[..., None], labels


def cifar10(n: int, g: torch.Generator, device) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """(n, 32, 32, 3) uint8 textures and (n,) int64 labels."""
    k = torch.arange(10, device=device, dtype=torch.float32)
    tints = torch.stack([torch.cos(k), torch.cos(k + 2.1),
                         torch.cos(k + 4.2)], 1) * 0.25 + 0.6  # (10, 3)
    labels = torch.randint(0, 10, (n,), generator=g, device=device)
    lf = labels.float()
    angle = lf * (math.pi / 10.0)
    freq = (2.0 + lf / 3.0) * (2 * math.pi / 32.0)
    phase = 2 * math.pi * torch.rand((n,), generator=g, device=device)
    contrast = 0.4 + 0.5 * torch.rand((n,), generator=g, device=device)
    yy, xx = torch.meshgrid(torch.arange(32, device=device).float(),
                            torch.arange(32, device=device).float(),
                            indexing="ij")
    proj = (torch.cos(angle)[:, None, None] * xx
            + torch.sin(angle)[:, None, None] * yy)
    grating = 0.5 + 0.5 * torch.sin(freq[:, None, None] * proj
                                    + phase[:, None, None])
    grating = (grating * contrast[:, None, None]
               + (1 - contrast[:, None, None]) / 2)
    img = grating[..., None] * tints[labels][:, None, None, :]
    img = img + 0.06 * torch.randn((n, 32, 32, 3), generator=g,
                                   device=device)
    return (img.clamp(0.0, 1.0) * 255).to(torch.uint8), labels


DATASETS = {"mnist": mnist, "cifar10": cifar10}


def shards(dataset: str, clients: int, per_client: int, seed: int, device
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(clients, per_client, H, W, ch) uint8 images and (clients,
    per_client) int64 labels, IID, from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & ((1 << 63) - 1))
    images, labels = DATASETS[dataset](clients * per_client, g, device)
    return (images.reshape((clients, per_client) + images.shape[1:]),
            labels.reshape(clients, per_client))
