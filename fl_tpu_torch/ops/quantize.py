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
draws its bits with Philox (``tl.randint``) keyed by the seed at counter =
element index; the plain version, which a CPU tensor takes, draws uniforms
from one ``torch.Generator``. The two give different bits by construction:
the deterministic mode is held exactly, the stochastic mode by its
distribution.

What bounds K6 on the H100: it reads 4 bytes and writes 1 per element (plus
one scale per 2048), with a 2048-wide max and ~30 integer and float
operations of Philox per element — far under the 295 flop/byte ridge, so it
is bound by memory bandwidth. One program owns one whole block, so it
computes the block maximum itself and reads x once, held in registers
between the reduction and the rounding (the TPU version computes the scales
in a separate pass only because of an output-tiling limit there; its 8-row
sublane padding is TPU tiling too and is not carried over).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

CHUNK = 2048
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
        scale = x.abs().max().clamp(min=1e-12) / qmax
        q = torch.round(x / scale).clamp(-qmax - 1, qmax)
        zp = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        lo, hi = x.min(), x.max()
        qmax = float(2 ** bits - 1)
        scale = (hi - lo).clamp(min=1e-12) / qmax
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
        raise ValueError(f"D={d} must be below 2^31 (the random stream is "
                         "keyed by a 32-bit element index)")
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


def _kernel():
    """K6, compiled at first use (Triton is imported only here)."""
    import triton
    import triton.language as tl

    @triton.jit
    def quantize_int8_kernel(x_ptr, q_ptr, scale_ptr, seed,
                             STOCHASTIC: tl.constexpr, CHUNK: tl.constexpr):
        blk = tl.program_id(0)
        idx = blk * CHUNK + tl.arange(0, CHUNK)     # < 2^31, the counter
        offs = blk.to(tl.int64) * CHUNK + tl.arange(0, CHUNK)
        x = tl.load(x_ptr + offs)
        amax = tl.max(tl.abs(x), axis=0)
        # IEEE divisions (`/` is an approximate one), so that the scales
        # equal the plain version's bit for bit
        scale = tl.div_rn(tl.maximum(amax, 1e-12), 127.0)
        scaled = x * tl.div_rn(1.0, scale)
        lo = tl.floor(scaled)
        if STOCHASTIC:
            u = (tl.randint(seed, idx) >> 8).to(tl.float32) \
                * (1.0 / 16777216.0)                # 24 bits, [0, 1)
            up = u < scaled - lo
        else:
            # half to even: up past the half, and at it when lo is odd.
            # Compared, not subtracted: a product fused into a subtraction
            # would decide an exact half by the unrounded product.
            half = lo + 0.5
            odd = (lo - 2.0 * tl.floor(lo * 0.5)) == 1.0
            up = (scaled > half) | ((scaled == half) & odd)
        q = tl.where(up, lo + 1.0, lo)
        q = tl.minimum(tl.maximum(q, -128.0), 127.0)
        tl.store(q_ptr + offs, q.to(tl.int8))
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
        _compiled[(n_blocks,)](x, q, scales, int(seed) & 0x7FFFFFFF,
                               STOCHASTIC=stochastic, CHUNK=CHUNK,
                               num_warps=4)
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
