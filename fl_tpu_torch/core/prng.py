"""Random-stream discipline for federated simulation.

The structure of ``fl_tpu.core.prng``: one experiment root; per-round
seed = fold(root, round); per-client seed = fold(round, client); per-purpose
seed = fold(client, stream tag). ``fold`` is a counter-based hash
(splitmix64 finalizer over the 64-bit sum), so any (round, client, stream)
seed is rebuilt from the root without replaying history, and streams that
differ in any coordinate are independent.

The bits differ from JAX's threefry by construction; tests compare
distributions, never draws.

Two places draw for all clients at once instead of one generator per
client, because one launch over the stacked client axis is what the device
wants:

- the per-epoch shuffle: one generator per (round, epoch) seeded from
  fold(fold(round, SHUFFLE), epoch), giving every client's permutation as
  ``argsort(rand(C, N))``;
- dropout: one generator per (round, local step) seeded from
  fold(fold(round, DROPOUT), step), drawing the whole (C, B, features)
  mask.

Per-client seeds come from :func:`client_stream_seeds` (delta DP's
noise, stochastic rounding) and :func:`client_seeds_of` (DP-SGD's noise,
distributed DP's rounding and shares), keyed by GLOBAL client id: under a
client mesh (``core.mesh``) a rank draws exactly its own clients' streams,
and the index-sized draws above (the shuffle, dropout masks, augmentation
offsets) are drawn whole on every rank and sliced to its rows.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


class Stream(enum.IntEnum):
    """Purpose tags folded into per-client seeds (same tags as fl_tpu)."""

    SHUFFLE = 0
    DROPOUT = 1
    DP_NOISE = 2
    INIT = 3
    PARTICIPATION = 4
    AUGMENT = 5
    EVAL = 6
    SECURE_AGG = 7
    PERSONALIZE = 8
    ROUNDING = 9
    UPLINK_Q = 10
    DISTRIBUTED_DP = 11
    SERVER = 12


def _mix(z: int) -> int:
    """splitmix64 finalizer: a bijection on 64-bit words with full
    avalanche."""
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    z = (z ^ (z >> 27)) * 0x94D049BB133111EB & _MASK64
    return z ^ (z >> 31)


def fold(seed: int, data: int) -> int:
    """Derive a child seed from ``seed`` and an integer tag."""
    return _mix((seed + _GOLDEN * (int(data) + 1)) & _MASK64)


def root_seed(seed: int) -> int:
    return _mix((int(seed) * _GOLDEN + 0x632BE59BD9B4E019) & _MASK64)


def root_seed_from_digest(digest: bytes) -> int:
    """A root seed carrying 128 bits of a hash digest: the first 8 bytes
    through :func:`root_seed`, the next 8 folded in (ref:
    ``root_key_from_digest``, which folds four 31-bit words, so that two
    clients' roots do not collide)."""
    if len(digest) < 16:
        raise ValueError("root_seed_from_digest needs >= 16 digest bytes")
    return fold(root_seed(int.from_bytes(digest[:8], "big")),
                int.from_bytes(digest[8:16], "big"))


def round_seed(root: int, round_number: int) -> int:
    return fold(root, round_number)


def client_seed(rseed: int, client_id: int) -> int:
    return fold(rseed, client_id)


def stream_seed(cseed: int, stream: Stream) -> int:
    return fold(cseed, int(stream))


def fold_many(seeds, data) -> np.ndarray:
    """:func:`fold` element by element over uint64 arrays (numpy's uint64
    products wrap mod 2^64 as the scalar form's masks do)."""
    z = (np.asarray(seeds, np.uint64)
         + np.uint64(_GOLDEN) * (np.asarray(data, np.uint64) + np.uint64(1)))
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def client_stream_seeds(rseed: int, num_clients: int, stream: Stream,
                        group: int = 0, first: int = 0) -> np.ndarray:
    """(C,) uint64 seeds fold(fold(fold(round, c), stream), group) for
    clients c = first, …, first + C − 1 of a round — the per-(client, leaf
    group) streams of the DP noise. ``first`` is a shard's first global
    client id, so a client draws the same stream whichever rank holds
    it."""
    ids = np.arange(first, first + num_clients, dtype=np.uint64)
    with np.errstate(over="ignore"):
        c = fold_many(np.uint64(rseed), ids)
        return fold_many(fold_many(c, int(stream)), group)


def client_seeds_of(seed: int, num_clients: int, first: int = 0
                    ) -> np.ndarray:
    """(C,) uint64 seeds fold(seed, c) for clients c = first, …, first +
    C − 1: one stream a global client id under a shared seed."""
    with np.errstate(over="ignore"):
        return fold_many(np.uint64(seed),
                         np.arange(first, first + num_clients,
                                   dtype=np.uint64))


def as_int64(seeds: np.ndarray) -> np.ndarray:
    """Reinterpret uint64 seeds as int64 (torch has no uint64 tensors)."""
    return np.asarray(seeds, np.uint64).view(np.int64)


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from a derived seed."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & ((1 << 63) - 1))
    return g
