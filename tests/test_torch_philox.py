"""The numpy Philox4x32-10 oracle, and the counter maps of K3 and K6.

The oracle (``tests/philox_oracle.py``) is held to Random123's known-answer
vectors for philox4x32-10. The maps from an element to the (counter, word)
of the Philox call that feeds it (``fl_tpu_torch.ops.dp.noise_layout`` for
K3, ``fl_tpu_torch.ops.quantize.rounding_layout`` for K6) are pure
functions: here they must cover every element exactly once and use each
(counter, word) at most once, at ragged widths too. On the card the
kernels' outputs are held to the oracle through these maps
(``tests/test_torch_kernels.py``); here the oracle's own draws are held to
the distributions they feed, with tolerances of about 5 standard errors.
Imports no JAX.
"""

import numpy as np
import pytest
import torch

import philox_oracle as oracle
from fl_tpu_torch.core import prng
from fl_tpu_torch.ops import dp as dpo
from fl_tpu_torch.ops import quantize as qz

# Random123's kat_vectors for philox4x32-10: counter, key, result
KNOWN_ANSWERS = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
RAGGED_WIDTHS = (1, 3, 4097, 20234)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("counter, key, want", KNOWN_ANSWERS,
                         ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    got = oracle.philox4x32(*counter, *key)
    assert tuple(int(w) for w in got) == want


def test_philox_is_vectorised_over_counters():
    ctr = np.array([0, 0xFFFFFFFF, 0x243F6A88], np.uint64)
    got = np.stack(oracle.philox4x32(ctr, 0, 0, 0, 7, 9))
    for j, c in enumerate(ctr):
        assert tuple(got[:, j]) == oracle.philox4x32(int(c), 0, 0, 0, 7, 9)


def test_randint4x_keys_by_the_seeds_two_words():
    """A negative int64 seed keys Philox by its two's-complement words, as
    Triton's ``philox`` splits ``seed.to(uint64)``."""
    seed = int(prng.as_int64(np.array([0xDEADBEEF12345678], np.uint64))[0])
    assert seed < 0
    got = oracle.randint4x(seed, np.arange(3))
    want = oracle.philox4x32(np.arange(3), 0, 0, 0, 0x12345678, 0xDEADBEEF)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _pairs(counter, word):
    return counter.numpy().astype(np.int64) * 4 + word.numpy()


@pytest.mark.parametrize("D", RAGGED_WIDTHS + (401408,))
def test_noise_layout_feeds_each_element_once(D):
    counter, word = dpo.noise_layout(D)
    assert counter.shape == word.shape == (D,)
    keys = _pairs(counter, word)
    assert np.unique(keys).size == D             # no (counter, word) twice
    assert set(word.tolist()) <= {0, 1, 2, 3}
    assert int(counter.min()) >= 0
    # the counters a width uses are those of its programs, and no more
    n_prog = -(-D // (4 * dpo.BQ))
    assert int(counter.max()) < n_prog * dpo.BQ
    # each quarter is a contiguous run of BQ elements with one word and
    # consecutive counters
    j = torch.arange(D)
    q = (j % (4 * dpo.BQ)) // dpo.BQ
    assert torch.equal(word, q)
    same = (j[1:] % dpo.BQ) != 0
    assert bool((counter[1:][same] - counter[:-1][same] == 1).all())


@pytest.mark.parametrize("D", RAGGED_WIDTHS)
def test_noise_layout_pairs_cosine_and_sine_of_one_radius(D):
    """Words 0/1 and 2/3 of a call are two Box–Muller pairs: where both
    quarters of a pair lie inside the row, they share the counter."""
    counter, word = dpo.noise_layout(D)
    by_key = {k: j for j, k in enumerate(_pairs(counter, word).tolist())}
    for j in range(0, D, max(1, D // 257)):
        c, w = int(counter[j]), int(word[j])
        partner = by_key.get(c * 4 + (w ^ 1))
        if partner is not None:
            assert abs(partner - j) == dpo.BQ


@pytest.mark.parametrize("n_blocks", [1, 3, 7])
def test_rounding_layout_feeds_each_value_once(n_blocks):
    counter, word = qz.rounding_layout(n_blocks)
    D = n_blocks * qz.CHUNK
    assert counter.shape == (D,)
    keys = _pairs(counter, word)
    # every (counter, word) of the block's QW calls, each exactly once
    np.testing.assert_array_equal(np.sort(keys), np.arange(D))
    j = torch.arange(D)
    assert torch.equal(counter // qz.QW, j // qz.CHUNK)   # a block's own
    assert torch.equal(word, (j % qz.CHUNK) // qz.QW)


@pytest.mark.parametrize("layout", ["noise", "rounding"])
def test_word_index_refuses_a_row_that_leaves_calls_short(layout):
    """At a ragged width the last calls feed fewer than four elements, and
    the tools that pair a call's words refuse such a row."""
    counter, word = (dpo.noise_layout(4097) if layout == "noise"
                     else qz.rounding_layout(2))
    if layout == "rounding":
        counter, word = counter[:-1], word[:-1]
    with pytest.raises(ValueError, match="fewer than four"):
        oracle.word_index(counter.numpy(), word.numpy())


def test_rounding_layout_counters_fit_32_bits_at_the_largest_input():
    """The kernel's counters are 32-bit: the largest D the quantizer takes
    (under 2^31) keeps them there."""
    n_blocks = ((1 << 31) - 1) // qz.CHUNK
    assert (n_blocks - 1) * qz.QW + qz.QW - 1 < 1 << 31
    assert dpo.MAX_D + 4 * dpo.BQ < 1 << 31


def test_oracle_box_muller_is_the_plain_formula():
    """Quarter 0 of a call is ``dp.box_muller`` of words 0 and 1, in f32."""
    seed = 12345
    counters = np.arange(4096)
    w = oracle.randint4x(seed, counters)
    want = dpo.box_muller(torch.tensor((w[0] >> 8).astype(np.int64)),
                          torch.tensor((w[1] >> 8).astype(np.int64)))
    got = oracle.box_muller(seed, counters, np.zeros_like(counters))
    np.testing.assert_allclose(got, want.double().numpy(), atol=2e-5)


def test_oracle_noise_stream_is_standard_normal_and_unpaired():
    """K3's stream through its map: N(0, 1) by mean, variance, 3σ tail and
    Kolmogorov–Smirnov distance (significance 1e-3), and no correlation
    between cosine and sine of a radius or between a call's two pairs (z
    and z²) — 2^18 draws."""
    D = 1 << 16
    rseed = prng.round_seed(prng.root_seed(0), 0)
    seeds = prng.as_int64(prng.client_stream_seeds(rseed, 4,
                                                   prng.Stream.DP_NOISE, 0))
    counter, word = (t.numpy() for t in dpo.noise_layout(D))
    z = np.stack([oracle.box_muller(s, counter, word) for s in seeds])
    flat = z.ravel()
    n = flat.size
    assert abs(flat.mean()) < 5 / np.sqrt(n)
    assert abs(flat.var() - 1) < 5 * np.sqrt(2 / n)
    assert abs((np.abs(flat) > 3).mean() - 0.0027) < 6e-4
    ks, critical = oracle.ks_normal(flat)
    assert ks < critical
    q = z[:, oracle.word_index(counter, word)]   # [client, word, call]
    tol = 5 / np.sqrt(q[:, 0].size * 2)
    for p in (1, 2):
        cs = np.corrcoef(np.concatenate([q[:, 0], q[:, 2]]).ravel() ** p,
                         np.concatenate([q[:, 1], q[:, 3]]).ravel() ** p)
        pp = np.corrcoef(np.concatenate([q[:, 0], q[:, 1]]).ravel() ** p,
                         np.concatenate([q[:, 2], q[:, 3]]).ravel() ** p)
        assert abs(cs[0, 1]) < tol and abs(pp[0, 1]) < tol


def test_oracle_rounding_uniforms_are_uniform_and_unpaired():
    """K6's uniforms through its map: 24-bit values in [0, 1), mean 1/2,
    variance 1/12, and no correlation between a call's quarters (2^18)."""
    n_blocks = 128
    counter, word = (t.numpy() for t in qz.rounding_layout(n_blocks))
    u = oracle.uniforms(11, counter, word)
    assert u.dtype == np.float32 and u.min() >= 0 and u.max() < 1
    assert np.array_equal(u * 2 ** 24, np.floor(u * 2 ** 24))
    n = u.size
    assert abs(u.mean() - 0.5) < 5 * np.sqrt(1 / 12 / n)
    assert abs(u.var() - 1 / 12) < 5 * np.sqrt(1 / 180 / n)
    q = u[oracle.word_index(counter, word)]       # [word, call]
    for a in range(4):
        for b in range(a + 1, 4):
            r = np.corrcoef(q[a], q[b])[0, 1]
            assert abs(r) < 5 / np.sqrt(q[a].size)
