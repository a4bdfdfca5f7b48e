"""On-device input preprocessing: normalization and CIFAR augmentation, over
stacked clients (port of ``fl_tpu.ops.preprocess``).

The reference's torchvision pipeline (random crop with 4-px padding, then
a horizontal flip, then normalize) runs here on the already-normalized
batch inside the training step, as in ``fl_tpu``: the zero padding is
applied to the normalized images, not to the raw ones. The reference
draws one (dy, dx) crop offset per batch inside its ``vmap`` over clients,
so one offset per client per step, and one flip per sample at p = 0.5.

The offsets and flips are inputs of the pure function
:func:`crop_and_flip`, which builds the whole (C, B, H, W, ch) batch with
one gather from the zero-padded images; :func:`augment_draws` makes the
draws from a generator (the trainer's AUGMENT stream).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


def normalize_u8(x_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 NHWC -> normalized float32."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x_u8.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x_u8.device)
    return (x_u8.float() / 255.0 - mean) / std


def crop_and_flip(x: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                  flip: Optional[torch.Tensor], padding: int = 4
                  ) -> torch.Tensor:
    """x (C, B, H, W, ch) → the crop at (dy[c], dx[c]) of client c's
    images zero-padded by ``padding`` on each side, then mirrored along W
    where ``flip`` (C, B) is true (None: no flip). One gather."""
    C, B, H, W, _ = x.shape
    dev = x.device
    padded = F.pad(x, (0, 0, padding, padding, padding, padding))
    rows = dy.long().reshape(C, 1, 1, 1) + torch.arange(
        H, device=dev).reshape(1, 1, H, 1)
    cols = torch.arange(W, device=dev).reshape(1, 1, 1, W)
    if flip is not None:
        cols = torch.where(flip.reshape(C, B, 1, 1), W - 1 - cols, cols)
    cols = dx.long().reshape(C, 1, 1, 1) + cols
    ci = torch.arange(C, device=dev).reshape(C, 1, 1, 1)
    bi = torch.arange(B, device=dev).reshape(1, B, 1, 1)
    return padded[ci, bi, rows, cols]


def random_crop_with_padding(x: torch.Tensor, dy: torch.Tensor,
                             dx: torch.Tensor, padding: int = 4
                             ) -> torch.Tensor:
    """The crop alone (ref: ``random_crop_with_padding`` with its offset
    given): client c's batch cut at (dy[c], dx[c]) from the zero-padded
    images."""
    return crop_and_flip(x, dy, dx, None, padding)


def random_hflip(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """The flip alone (ref: ``random_hflip`` with its draws given): each
    sample whose ``flip`` (C, B) entry is true mirrored along W."""
    return torch.where(flip[:, :, None, None, None], x.flip(3), x)


def augment_draws(generator: Optional[torch.Generator], num_clients: int,
                  batch: int, padding: int = 4, device="cpu"
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step's draws for every client: (dy (C,), dx (C,)) uniform in
    0..2·padding and (C, B) flips at p = 0.5."""
    off = torch.randint(0, 2 * padding + 1, (2, num_clients),
                        generator=generator, device=device)
    flip = torch.rand((num_clients, batch), generator=generator,
                      device=device) < 0.5
    return off[0], off[1], flip


def make_cifar_augment(padding: int = 4) -> Callable:
    """The augment function of the trainer's ``augment_fn`` slot:
    ``augment(x, generator)`` crops every client's normalized (C, B, H, W,
    ch) batch at its own offset (``padding``-px zero padding) and flips
    each sample at p = 0.5, with the draws from ``generator``. With
    ``rows=(first, total)`` the batch holds clients first, … of ``total``
    (a shard of the client axis): the draws are made for all ``total``
    clients and these rows taken, so a client's crop and flips do not
    depend on the shard that holds it."""

    def augment(x: torch.Tensor, generator: Optional[torch.Generator],
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        C = x.shape[0]
        first, total = (0, C) if rows is None else rows
        dy, dx, flip = augment_draws(generator, total, x.shape[1],
                                     padding, x.device)
        sl = slice(first, first + C)
        return crop_and_flip(x, dy[sl], dx[sl], flip[sl], padding)

    return augment
