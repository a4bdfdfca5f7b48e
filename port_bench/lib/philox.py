"""The Gaussian noise streams of the measured program's DP release,
written out again in plain PyTorch.

On a card the program draws its DP noise with Philox4x32-10 (Salmon et
al., SC'11) keyed by a client's 64-bit seed (low word k0, high word k1) at
counter (offset, 0, 0, 0), one call for four elements; this is a frozen
copy of the repository's numpy Philox oracle as integer tensor arithmetic,
so that the reference draws the same normals on the device in a few large
calls. The element-to-(counter, word) map is the documented layout of the
release: element 4·BQ·p + q·BQ + i of a row takes word q of the call at
counter BQ·p + i (BQ = 512); words 0 and 1 make one Box–Muller pair
(quarter 0 its cosine, quarter 1 its sine), words 2 and 3 another; u1 =
(w >> 8)·2^-24 + 2^-25, u2 = (w >> 8)·2^-24, in float32.

On the CPU the program draws from one ``torch.Generator`` per client seed
instead (24-bit integers, two rows, the cosine only): :func:`cpu_normals`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BQ = 512
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF


def philox4x32(ctr: torch.Tensor, k0: torch.Tensor, k1: torch.Tensor):
    """Philox4x32-10 of counters (ctr, 0, 0, 0) under keys (k0, k1); int64
    tensors holding 32-bit values, broadcast together. Products of two
    32-bit values wrap in int64 as their uint64 bits do, so the high word
    is (p >> 32) & MASK whatever the sign."""
    c0 = ctr & MASK
    c1 = torch.zeros_like(c0)
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0 = k0 & MASK
    k1 = k1 & MASK
    for _ in range(10):
        p0 = c0 * M0
        p1 = c2 * M1
        c0, c1, c2, c3 = (((p1 >> 32) & MASK) ^ c1 ^ k0, p1 & MASK,
                          ((p0 >> 32) & MASK) ^ c3 ^ k1, p0 & MASK)
        k0 = (k0 + W0) & MASK
        k1 = (k1 + W1) & MASK
    return c0, c1, c2, c3


def _u32(w: torch.Tensor) -> torch.Tensor:
    return (w >> 8).to(torch.float32) * (1.0 / 16777216.0)


def card_normals(seeds: np.ndarray, width: int, device) -> torch.Tensor:
    """(len(seeds), width) float32 N(0, 1) draws of the card's release, one
    row a uint64 seed."""
    s = np.asarray(seeds, np.uint64)
    k0 = torch.as_tensor((s & np.uint64(MASK)).astype(np.int64),
                         device=device)[:, None, None]
    k1 = torch.as_tensor((s >> np.uint64(32)).astype(np.int64),
                         device=device)[:, None, None]
    programs = -(-width // (4 * BQ))
    ctr = (torch.arange(programs, device=device)[:, None] * BQ
           + torch.arange(BQ, device=device)[None, :])[None]
    w0, w1, w2, w3 = philox4x32(ctr, k0, k1)
    ra = torch.sqrt(-2.0 * torch.log(_u32(w0) + (1.0 / 33554432.0)))
    ta = 6.283185307179586 * _u32(w1)
    rb = torch.sqrt(-2.0 * torch.log(_u32(w2) + (1.0 / 33554432.0)))
    tb = 6.283185307179586 * _u32(w3)
    z = torch.stack([ra * torch.cos(ta), ra * torch.sin(ta),
                     rb * torch.cos(tb), rb * torch.sin(tb)], 2)
    return z.reshape(len(s), -1)[:, :width]


def cpu_normals(seeds: np.ndarray, width: int) -> torch.Tensor:
    """The CPU path's draws: for each seed a generator, two rows of 24-bit
    integers, r·cos(θ)."""
    rows = []
    for seed in np.asarray(seeds, np.uint64).view(np.int64).tolist():
        g = torch.Generator()
        g.manual_seed(seed & ((1 << 63) - 1))
        bits = torch.randint(0, 1 << 24, (2, width), generator=g,
                             dtype=torch.int32)
        u1 = bits[0].float() * (1.0 / (1 << 24)) + (1.0 / (1 << 25))
        u2 = bits[1].float() * (1.0 / (1 << 24))
        rows.append(torch.sqrt(-2.0 * torch.log(u1))
                    * torch.cos((2.0 * math.pi) * u2))
    return torch.stack(rows)


def normals(seeds: np.ndarray, width: int, device) -> torch.Tensor:
    """The program's N(0, 1) draws for these row seeds on ``device``."""
    if torch.device(device).type == "cuda":
        return card_normals(seeds, width, device)
    return cpu_normals(seeds, width)
