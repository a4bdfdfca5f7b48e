"""The seed derivations of the federated round, written out again.

A frozen copy of the arithmetic the measured program documents for its
random streams (a splitmix64 fold of a 64-bit seed and a tag): the plain
reference rebuilds every stream the program draws (the shuffle, dropout,
augmentation, the DP noise keys) from the engine seed with these, and the
harness derives its own input seeds with them. Nothing here is imported
from the program.
"""

from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1
GOLDEN = 0x9E3779B97F4A7C15

# purpose tags of the program's streams
SHUFFLE = 0
DROPOUT = 1
DP_NOISE = 2
AUGMENT = 5


def mix(z: int) -> int:
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & MASK64
    z = (z ^ (z >> 27)) * 0x94D049BB133111EB & MASK64
    return z ^ (z >> 31)


def fold(seed: int, data: int) -> int:
    return mix((seed + GOLDEN * (int(data) + 1)) & MASK64)


def root_seed(seed: int) -> int:
    return mix((int(seed) * GOLDEN + 0x632BE59BD9B4E019) & MASK64)


def fold_many(seeds, data) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = (np.asarray(seeds, np.uint64) + np.uint64(GOLDEN)
             * (np.asarray(data, np.uint64) + np.uint64(1)))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def client_stream_seeds(rseed: int, clients: int, stream: int,
                        group: int) -> np.ndarray:
    """fold(fold(fold(round, c), stream), group) for c = 0 .. clients-1."""
    c = fold_many(np.uint64(rseed), np.arange(clients, dtype=np.uint64))
    return fold_many(fold_many(c, stream), group)


def client_seeds_of(seed: int, clients: int) -> np.ndarray:
    """fold(seed, c) for c = 0 .. clients-1."""
    return fold_many(np.uint64(seed), np.arange(clients, dtype=np.uint64))


def torch_generator(seed: int, device):
    """A torch.Generator on ``device`` seeded as the program seeds its
    generators: the low 63 bits of the derived seed."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & ((1 << 63) - 1))
    return g
