"""fl_tpu_torch.ops.quantize vs fl_tpu.ops.quantize.

The same numpy vectors go through the JAX functions and the port's. The
affine quantizers are plain array code on both sides: q must be equal and
the scale agree to 1e-6. The int8 block quantizer's TPU kernel runs in
interpret mode on the CPU, where it rounds half to even; the port's
deterministic mode (``stochastic=False``) is held to it: scales to 1e-6,
q equal except on exact halves of ``x * (1 / scale)``, where a last-bit
difference between the two reciprocals may flip the rounding by one — at
most 1e-4 of the elements. The stochastic mode draws other bits than any
reference, so it is held by its distribution. On a CPU tensor every
function here takes the plain PyTorch version; the Triton kernel K6 is held
to that version on the card in tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl_tpu.ops import quantize as jq
from fl_tpu_torch.ops import launch_counts, reset_launch_counts
from fl_tpu_torch.ops import quantize as qz


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vector(seed, d, sigma=3.0):
    return np.random.default_rng(seed).normal(0, sigma, d).astype(np.float32)


def test_chunk_matches_the_reference():
    assert qz.CHUNK == jq.CHUNK == 2048


@pytest.mark.parametrize("bits,symmetric", [(8, False), (8, True),
                                            (4, False), (4, True)])
def test_quantize_affine_matches_jax(bits, symmetric):
    x = _vector(5, 1000, 1.0)
    jq_q, j_scale, j_zp = jq.quantize_affine(jnp.asarray(x), bits, symmetric)
    q, scale, zp = qz.quantize_affine(torch.tensor(x), bits, symmetric)
    assert q.dtype == torch.int32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_q))
    np.testing.assert_allclose(scale.numpy(), np.asarray(j_scale), rtol=1e-6)
    np.testing.assert_allclose(zp.numpy(), np.asarray(j_zp), rtol=1e-6)
    back = qz.dequantize_affine(q, scale, zp, symmetric)
    j_back = jq.dequantize_affine(jq_q, j_scale, j_zp, symmetric)
    np.testing.assert_allclose(back.numpy(), np.asarray(j_back), rtol=1e-6,
                               atol=1e-7)
    # the quantization step bound of the reference's own test
    assert np.abs(back.numpy() - x).max() <= float(scale) * 0.51 + 1e-6


def test_deterministic_blocks_match_the_jax_kernel_in_interpret_mode():
    d = qz.CHUNK * 4
    x = _vector(6, d)
    j_q, j_scales = jq.quantize_int8(jnp.asarray(x), seed=jnp.int32(7),
                                     use_pallas=True, interpret=True)
    q, scales = qz.quantize_int8_blocks(torch.tensor(x), 7, stochastic=False)
    assert q.dtype == torch.int8 and tuple(scales.shape) == (4,)
    np.testing.assert_allclose(scales.numpy(), np.asarray(j_scales),
                               rtol=1e-6)
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(j_q, np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-4
    back = qz.dequantize_int8_blocks(q, scales)
    j_back = jq.dequantize_int8_blocks(j_q, j_scales)
    np.testing.assert_allclose(back.numpy(), np.asarray(j_back), rtol=1e-6,
                               atol=float(scales.max()) * 1.001)
    err = (back - torch.tensor(x)).reshape(4, -1).abs().amax(1)
    # half a step per block, with room for the rounding of x * (1 / scale)
    assert bool((err <= scales * 0.501).all())


def test_round_to_nearest_path_matches_jax():
    """``use_kernel=False`` is the reference's jnp path: a division by the
    scale and round-half-even, also for a vector shorter than one block."""
    for d in (qz.CHUNK * 2, 100):
        x = _vector(8, d)
        j_q, j_scales = jq.quantize_int8(jnp.asarray(x), use_pallas=False)
        q, scales = qz.quantize_int8(torch.tensor(x), use_kernel=False)
        np.testing.assert_allclose(scales.numpy(), np.asarray(j_scales),
                                   rtol=1e-6)
        diff = np.abs(q.numpy().astype(np.int32) - np.asarray(j_q, np.int32))
        assert diff.max() <= 1 and (diff != 0).mean() <= 1e-4


def test_stochastic_plain_version_by_its_distribution():
    n = 1 << 20
    x = torch.tensor(_vector(9, n, 1.0))
    q, scales = qz.quantize_int8_blocks(x, 11)
    scaled = (x.reshape(-1, qz.CHUNK) * (1.0 / scales)[:, None]).reshape(-1)
    lo, qf = torch.floor(scaled), q.float()
    assert bool(((qf == lo.clamp(-128, 127))
                 | (qf == (lo + 1).clamp(-128, 127))).all())
    # unbiased: the mean error is 0 to 4 standard errors (0.5 / sqrt(n))
    assert abs(float((qf.double() - scaled.double()).mean())) <= 2e-3
    # P(ceil) is the fractional part, in ten bins (about 10 se each)
    frac, up = scaled - lo, qf > lo
    for b in range(10):
        sel = (frac >= b / 10) & (frac < (b + 1) / 10)
        assert abs(float(up[sel].float().mean())
                   - float(frac[sel].mean())) <= 0.015
    err = (qz.dequantize_int8_blocks(q, scales) - x).reshape(
        -1, qz.CHUNK).abs().amax(1)
    assert bool((err < scales).all())             # under one step
    assert torch.equal(q, qz.quantize_int8_blocks(x, 11)[0])
    assert not torch.equal(q, qz.quantize_int8_blocks(x, 12)[0])


def test_saturates_and_survives_a_zero_block():
    x = torch.zeros(2 * qz.CHUNK)
    x[qz.CHUNK:] = torch.linspace(-1, 1, qz.CHUNK)
    for stochastic in (False, True):
        q, scales = qz.quantize_int8_blocks(x, 3, stochastic=stochastic)
        assert float(scales[0]) == pytest.approx(1e-12 / 127)
        assert int(q[:qz.CHUNK].abs().max()) == 0
        assert int(q.min()) >= -128 and int(q.max()) == 127


def test_front_door_chooses_by_device_and_flag():
    """``use_kernel=None`` means "on a CUDA tensor": a CPU tensor rounds to
    nearest; ``use_kernel=True`` takes the stochastic block quantizer, whose
    plain version runs here and launches nothing."""
    x = torch.tensor(_vector(10, qz.CHUNK * 2))
    reset_launch_counts()
    q_near, s_near = qz.quantize_int8(x)
    q_flag, _ = qz.quantize_int8(x, use_kernel=False)
    assert torch.equal(q_near, q_flag)
    q_st, s_st = qz.quantize_int8(x, seed=torch.tensor(4), use_kernel=True)
    assert torch.equal(q_st, qz.quantize_int8_blocks_plain(x, 4)[0])
    torch.testing.assert_close(s_st, s_near, rtol=1e-6, atol=0)
    assert not torch.equal(q_st, q_near)
    assert launch_counts()["quantize_int8_blocks"] == 0


@pytest.mark.parametrize("bad", ["ragged", "empty", "matrix", "float64"])
def test_block_quantizer_refuses_what_the_kernel_does_not_take(bad):
    x = {"ragged": torch.zeros(qz.CHUNK + 1),
         "empty": torch.zeros(0),
         "matrix": torch.zeros((2, qz.CHUNK)),
         "float64": torch.zeros(qz.CHUNK, dtype=torch.float64)}[bad]
    with pytest.raises(ValueError):
        qz.quantize_int8_blocks(x, 0)
    with pytest.raises(ValueError):
        qz.quantize_int8_blocks_plain(x, 0, stochastic=False)
