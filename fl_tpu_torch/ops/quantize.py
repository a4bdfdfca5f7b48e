"""Quantization of model updates (port of ``fl_tpu.ops.quantize``).

- ``quantize_affine`` / ``dequantize_affine``: N-bit affine or symmetric
  quantization with one scale per tensor, plain PyTorch (the reference's
  are plain jnp).
- ``quantize_int8_blocks`` / ``dequantize_int8_blocks``: int8 with one scale
  per block of ``CHUNK`` = 2048 values of a flat f32 vector and stochastic
  rounding, so that E[q · scale] = x. Per block: ``scale = max(max|x|,
  1e-12) / 127``, ``scaled = x * (1 / scale)`` (a multiply by the
  reciprocal, as the TPU kernel does), and q is floor(scaled) or
  ceil(scaled), the ceiling with probability equal to the fractional part,
  saturated to [-128, 127]. ``stochastic=False`` rounds half to even
  instead (what the TPU kernel computes in interpret mode).
- ``quantize_int8``: the reference's front door — the kernel on the
  accelerator, round-to-nearest elsewhere.

On a CUDA tensor ``quantize_int8_blocks`` launches kernel K6, a Triton
kernel that replaces ``_make_quantize_kernel`` (fl_tpu/ops/quantize.py). It
draws its uniforms with Philox4x32-10 (``tl.randint4x``) keyed by the seed:
one call gives four 32-bit words, and each word's top 24 bits round one
value, so a call serves four values (:func:`rounding_layout` is the map
from a value to its (counter, word)). The plain version, which a CPU
tensor takes, draws uniforms from one ``torch.Generator``. The two give
different bits by construction: the deterministic mode is held exactly,
the stochastic mode to a numpy Philox oracle through the map on the card
and by its distribution.

The least time for K6's work on the H100 is the bytes: it reads 4 bytes and
writes 1 per value (plus one scale per 2048), with a 2048-wide max and
about 10 f32 operations a value. The first design drew one whole Philox
call a value and used one of its four words: its compiled code cost 78
instructions a value, 56 of them integer, which at one instruction a clock
on each of an SM's 128 lanes take 0.50 ms for 216 M values at 1.98 GHz and
held it at 2.2x the bound. This design makes 512 calls a block, each
rounding one value in each of the block's four contiguous quarters; with
two warps a block (8 values a thread in each quarter) that cuts it to 39
instructions, 22 of them integer, and the loads and stores are the limit.
One program still owns one whole block, so it computes the block maximum
itself and reads x once, held in registers between the reduction and the
rounding (the TPU version computes the scales in a separate pass only
because of an output-tiling limit there; its 8-row sublane padding is TPU
tiling too and is not carried over). It is compiled without fused
multiply-adds, so a value rounds by the rounded product x * (1 / scale), as
in the plain version and the oracle. (Counts: ``tools/rng_kernels.py
isa``.)
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

CHUNK = 2048
# K6's quarter: a program's Philox calls, each rounding four values
QW = CHUNK // 4
# two warps a block, 8 values a thread in each quarter: faster than four
# (``tools/rng_kernels.py sweep``)
NUM_WARPS = 2
LAUNCHES = {"quantize_int8_blocks": 0}

Seed = Union[int, torch.Tensor]


# ---------------------------------------------------------------------------
# generic N-bit affine/symmetric quantization
# ---------------------------------------------------------------------------

def quantize_affine(x: torch.Tensor, bits: int = 8, symmetric: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize to ``bits`` levels. Returns (q int32, scale, zero_point).

    Symmetric: q = round(x/s), s = max|x|/(2^(b-1)-1), zp = 0.
    Asymmetric: q = round((x-min)/s), s = (max-min)/(2^b-1), zp = min.
    Rounding is half to even, as ``jnp.round``."""
    x = x.float()
    if symmetric:
        qmax = float(2 ** (bits - 1) - 1)
        amax = x.abs().max().clamp(min=1e-12)
        # a tensor divisor, as in _block_scales
        scale = amax / torch.full_like(amax, qmax)
        q = torch.round(x / scale).clamp(-qmax - 1, qmax)
        zp = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        lo, hi = x.min(), x.max()
        qmax = float(2 ** bits - 1)
        span = (hi - lo).clamp(min=1e-12)
        scale = span / torch.full_like(span, qmax)
        q = torch.round((x - lo) / scale).clamp(0, qmax)
        zp = lo
    return q.to(torch.int32), scale, zp


def dequantize_affine(q: torch.Tensor, scale: torch.Tensor,
                      zero_point: torch.Tensor, symmetric: bool = False
                      ) -> torch.Tensor:
    """Inverse of :func:`quantize_affine`."""
    if symmetric:
        return q.float() * scale
    return q.float() * scale + zero_point


# ---------------------------------------------------------------------------
# int8 blocks with stochastic rounding (K6)
# ---------------------------------------------------------------------------

def _check_blocks(x: torch.Tensor) -> int:
    if x.dim() != 1 or x.dtype != torch.float32:
        raise ValueError(f"x must be a flat float32 vector, got "
                         f"{tuple(x.shape)} {x.dtype}")
    d = x.shape[0]
    if d == 0 or d % CHUNK:
        raise ValueError(f"D={d} must be a positive multiple of {CHUNK}")
    if d >= 1 << 31:
        raise ValueError(f"D={d} must be below 2^31 (the random "
                         "stream's counters are 32-bit)")
    return d // CHUNK


def _block_scales(x2: torch.Tensor) -> torch.Tensor:
    amax = x2.abs().amax(1).clamp(min=1e-12)
    # a tensor divisor: by a Python scalar, PyTorch's CUDA kernel multiplies
    # by the rounded reciprocal, one ulp off the true quotient
    return amax / torch.full_like(amax, 127.0)


def quantize_int8_blocks_plain(x: torch.Tensor, seed: Seed, *,
                               stochastic: bool = True
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K6, on x's device."""
    n_blocks = _check_blocks(x)
    x2 = x.reshape(n_blocks, CHUNK)
    scales = _block_scales(x2)
    scaled = x2 * (1.0 / scales)[:, None]
    if stochastic:
        g = torch.Generator(device=x.device)
        g.manual_seed(int(seed) & ((1 << 63) - 1))
        u = torch.rand(scaled.shape, generator=g, device=x.device)
        lo = torch.floor(scaled)
        q = lo + (u < scaled - lo)
    else:
        q = torch.round(scaled)
    return q.clamp(-128, 127).to(torch.int8).reshape(-1), scales


def rounding_layout(n_blocks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counter, word) of each of n_blocks·CHUNK values, as K6 draws its
    stochastic-rounding uniforms: block b's values are four contiguous
    quarters of QW = CHUNK / 4, and value b·CHUNK + q·QW + i takes word q
    of the Philox call at counter b·QW + i."""
    j = torch.arange(n_blocks * CHUNK, dtype=torch.int64)
    b, r = j // CHUNK, j % CHUNK
    return b * QW + r % QW, r // QW


def _kernel():
    """K6, compiled at first use (Triton is imported only here)."""
    import triton
    import triton.language as tl

    @triton.jit
    def quantize_int8_kernel(x_ptr, q_ptr, scale_ptr, seed,
                             STOCHASTIC: tl.constexpr, QW: tl.constexpr):
        blk = tl.program_id(0)
        lane = tl.arange(0, QW)
        # the block's four quarters, at o0 + q·QW
        o0 = blk.to(tl.int64) * (4 * QW) + lane
        o1 = o0 + QW
        o2 = o1 + QW
        o3 = o2 + QW
        x0 = tl.load(x_ptr + o0)
        x1 = tl.load(x_ptr + o1)
        x2 = tl.load(x_ptr + o2)
        x3 = tl.load(x_ptr + o3)
        amax = tl.maximum(
            tl.maximum(tl.max(tl.abs(x0), axis=0), tl.max(tl.abs(x1), axis=0)),
            tl.maximum(tl.max(tl.abs(x2), axis=0), tl.max(tl.abs(x3), axis=0)))
        # IEEE divisions (`/` is an approximate one), so that the scales
        # equal the plain version's bit for bit
        scale = tl.div_rn(tl.maximum(amax, 1e-12), 127.0)
        rcp = tl.div_rn(1.0, scale)
        s0 = x0 * rcp
        s1 = x1 * rcp
        s2 = x2 * rcp
        s3 = x3 * rcp
        l0 = tl.floor(s0)
        l1 = tl.floor(s1)
        l2 = tl.floor(s2)
        l3 = tl.floor(s3)
        if STOCHASTIC:
            # one Philox4x32-10 call a lane; word q's top 24 bits are
            # quarter q's uniform in [0, 1), and it rounds up below frac(s)
            w0, w1, w2, w3 = tl.randint4x(seed, blk * QW + lane)
            up0 = (w0 >> 8).to(tl.float32) * (1.0 / 16777216.0) < s0 - l0
            up1 = (w1 >> 8).to(tl.float32) * (1.0 / 16777216.0) < s1 - l1
            up2 = (w2 >> 8).to(tl.float32) * (1.0 / 16777216.0) < s2 - l2
            up3 = (w3 >> 8).to(tl.float32) * (1.0 / 16777216.0) < s3 - l3
        else:
            # half to even: up past the half, and at it when lo is odd.
            # Compared, not subtracted: a product fused into a subtraction
            # would decide an exact half by the unrounded product.
            up0 = (s0 > l0 + 0.5) | ((s0 == l0 + 0.5)
                                     & (l0 - 2.0 * tl.floor(l0 * 0.5) == 1.0))
            up1 = (s1 > l1 + 0.5) | ((s1 == l1 + 0.5)
                                     & (l1 - 2.0 * tl.floor(l1 * 0.5) == 1.0))
            up2 = (s2 > l2 + 0.5) | ((s2 == l2 + 0.5)
                                     & (l2 - 2.0 * tl.floor(l2 * 0.5) == 1.0))
            up3 = (s3 > l3 + 0.5) | ((s3 == l3 + 0.5)
                                     & (l3 - 2.0 * tl.floor(l3 * 0.5) == 1.0))
        q0 = tl.where(up0, l0 + 1.0, l0)
        q1 = tl.where(up1, l1 + 1.0, l1)
        q2 = tl.where(up2, l2 + 1.0, l2)
        q3 = tl.where(up3, l3 + 1.0, l3)
        tl.store(q_ptr + o0, tl.minimum(tl.maximum(q0, -128.0), 127.0)
                 .to(tl.int8))
        tl.store(q_ptr + o1, tl.minimum(tl.maximum(q1, -128.0), 127.0)
                 .to(tl.int8))
        tl.store(q_ptr + o2, tl.minimum(tl.maximum(q2, -128.0), 127.0)
                 .to(tl.int8))
        tl.store(q_ptr + o3, tl.minimum(tl.maximum(q3, -128.0), 127.0)
                 .to(tl.int8))
        tl.store(scale_ptr + blk, scale)

    return quantize_int8_kernel


_compiled = None


def quantize_int8_blocks_cuda(x: torch.Tensor, seed: Seed, *,
                              stochastic: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K6 on x's device and the current stream."""
    global _compiled
    n_blocks = _check_blocks(x)
    if not (x.is_cuda and x.is_contiguous()):
        raise ValueError("quantize_int8_blocks_cuda needs a contiguous CUDA "
                         "tensor")
    if _compiled is None:
        _compiled = _kernel()
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((n_blocks,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        # no fused multiply-adds: the rounding decides by the rounded
        # product x * (1 / scale), as the plain version does
        _compiled[(n_blocks,)](x, q, scales, int(seed) & 0x7FFFFFFF,
                               STOCHASTIC=stochastic, QW=QW,
                               num_warps=NUM_WARPS, enable_fp_fusion=False)
    LAUNCHES["quantize_int8_blocks"] += 1
    return q, scales


def quantize_int8_blocks(x: torch.Tensor, seed: Seed, *,
                         stochastic: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-quantize a flat f32 (D,) vector, D a multiple of ``CHUNK``, to
    int8 with one scale per block. Returns (q int8 (D,), scales f32
    (D / CHUNK,)). CUDA tensors launch K6; CPU tensors take the plain
    version."""
    if x.is_cuda:
        return quantize_int8_blocks_cuda(x.contiguous(), seed,
                                         stochastic=stochastic)
    return quantize_int8_blocks_plain(x, seed, stochastic=stochastic)


def dequantize_int8_blocks(q: torch.Tensor, scales: torch.Tensor
                           ) -> torch.Tensor:
    n_blocks = scales.shape[0]
    return (q.reshape(n_blocks, -1).float() * scales[:, None]).reshape(-1)


def quantize_int8(x: torch.Tensor, seed: Optional[Seed] = None,
                  use_kernel: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 quantization of a flat vector: stochastic rounding through
    :func:`quantize_int8_blocks` where the kernel runs (``use_kernel=None``
    means on a CUDA tensor), round-to-nearest with a division by the scale
    elsewhere, as the reference's two paths. Returns (q, block scales)."""
    if use_kernel is None:
        use_kernel = x.is_cuda
    if use_kernel:
        return quantize_int8_blocks(x, 0 if seed is None else seed)
    if x.dim() != 1:
        raise ValueError(f"x must be a flat vector, got {tuple(x.shape)}")
    d = x.shape[0]
    n_blocks = max(1, d // CHUNK)
    if d % n_blocks:
        raise ValueError(f"D={d} does not split into {n_blocks} equal blocks")
    x2 = x.reshape(n_blocks, -1).float()
    scales = _block_scales(x2)
    q = torch.round(x2 / scales[:, None]).clamp(-128, 127).to(torch.int8)
    return q.reshape(d), scales
