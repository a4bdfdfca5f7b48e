"""A numpy Philox4x32-10 and the streams K3 and K6 draw from it.

Philox4x32-10 is Salmon et al.'s counter-based generator (SC'11, Random123):
a 128-bit counter (c0, c1, c2, c3) and a 64-bit key (k0, k1), ten rounds of
two 32x32 -> 64-bit products, XORs and a Weyl key bump. Triton's
``tl.randint4x(seed, offset)`` is this generator keyed by the 64-bit seed's
low and high words (k0, k1), at counter (offset, 0, 0, 0).

The streams use the port's pure maps from an element to its (counter,
word): ``fl_tpu_torch.ops.dp.noise_layout`` for K3 (one row of a client)
and ``fl_tpu_torch.ops.quantize.rounding_layout`` for K6.

Beside them, two tools the tests of those streams share:
:func:`word_index` arranges a row by the word that feeds each element, and
:func:`ks_normal` is a Kolmogorov–Smirnov test against N(0, 1).

Imports no JAX; the card's smoke run and kernel tests use it too.
"""

import numpy as np
import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57      # the round multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85      # the key bumps
MASK = 0xFFFFFFFF


def philox4x32(c0, c1, c2, c3, k0, k1, rounds=10):
    """Philox4x32-``rounds`` of counters (c0..c3) under key (k0, k1), each
    an array or a scalar of 32-bit unsigned values; returns four uint32
    arrays of the broadcast shape."""
    c = [np.asarray(v, dtype=np.uint64) & MASK for v in (c0, c1, c2, c3)]
    c = np.broadcast_arrays(*c)
    c0, c1, c2, c3 = (v.copy() for v in c)
    k0, k1 = np.uint64(int(k0) & MASK), np.uint64(int(k1) & MASK)
    for _ in range(rounds):
        p0 = np.uint64(M0) * c0
        p1 = np.uint64(M1) * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & MASK,
                          (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & MASK)
        k0 = (k0 + np.uint64(W0)) & MASK
        k1 = (k1 + np.uint64(W1)) & MASK
    return tuple(v.astype(np.uint32) for v in (c0, c1, c2, c3))


def randint4x(seed, offsets):
    """The four words of ``tl.randint4x(seed, offsets)``: the 64-bit seed's
    two's-complement low and high words as the key, counter (offset, 0, 0,
    0)."""
    s = int(seed) & ((1 << 64) - 1)
    return philox4x32(offsets, 0, 0, 0, s & MASK, s >> 32)


def words(seed, counters, word):
    """Word ``word[j]`` of the Philox call at counter ``counters[j]``."""
    counters, word = np.asarray(counters), np.asarray(word)
    w = np.stack(randint4x(seed, counters))
    return np.take_along_axis(w, word[None].astype(np.int64), 0)[0]


def box_muller(seed, counters, word):
    """K3's N(0, 1) draw of each element: words (0, 1) of a call make u1, u2
    for its quarters 0 (r cos 2 pi u2) and 1 (r sin 2 pi u2), words (2, 3)
    for quarters 2 and 3; u1 = (w >> 8) / 2^24 + 2^-25, u2 = (w >> 8) /
    2^24, r = sqrt(-2 ln u1). In float64."""
    counters, word = np.asarray(counters), np.asarray(word)
    w = np.stack(randint4x(seed, counters)).astype(np.int64)
    pair = (word // 2) * 2
    a = np.take_along_axis(w, pair[None], 0)[0] >> 8
    b = np.take_along_axis(w, (pair + 1)[None], 0)[0] >> 8
    u1 = a / 2.0 ** 24 + 2.0 ** -25
    theta = 2.0 * np.pi * (b / 2.0 ** 24)
    r = np.sqrt(-2.0 * np.log(u1))
    return np.where(word % 2 == 0, r * np.cos(theta), r * np.sin(theta))


def uniforms(seed, counters, word):
    """K6's stochastic-rounding uniform of each element, (w >> 8) / 2^24, as
    the float32 the kernel compares."""
    w = words(seed, counters, word)
    return ((w >> 8).astype(np.float32) * np.float32(2.0 ** -24))


def word_index(counter, word):
    """(4, n) indices into a row of len(counter) elements: [q, k] is the
    element that word q of the k-th Philox call feeds. Raises unless every
    call feeds four elements of the row."""
    counter, word = np.asarray(counter), np.asarray(word)
    idx = np.full((4, int(counter.max()) + 1), -1, np.int64)
    idx[word, counter] = np.arange(counter.size)
    if (idx < 0).any():
        raise ValueError("a Philox call feeds fewer than four elements of "
                         "this row")
    return idx


def ks_normal(z):
    """Kolmogorov–Smirnov distance of the sample z (a tensor, on any
    device) from N(0, 1), and its critical value at significance 1e-3 by
    Kolmogorov's limit, 1.949 / sqrt(n)."""
    x, _ = torch.sort(torch.as_tensor(z).double().flatten())
    n = x.numel()
    cdf = torch.special.ndtr(x)
    i = torch.arange(1, n + 1, device=x.device, dtype=torch.float64)
    d = max(float((i / n - cdf).max()), float((cdf - (i - 1) / n).max()))
    return d, 1.949 / np.sqrt(n)
