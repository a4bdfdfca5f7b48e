"""Fused DP clip + Gaussian noise over a stacked (C, D) update matrix.

``clip_noise(x, scale, sigma, seeds)`` returns ``x[c] * scale[c] +
sigma[c] * z`` with z ~ N(0, 1) drawn element by element from client c's
seed — the counterpart of ``fl_tpu.ops.dp._clip_noise_pallas``. The
Gaussian is Box–Muller on two 24-bit uniforms exactly as the TPU kernel
builds them: u1 = (bits1 >> 8) / 2^24 + 2^-25 in [2^-25, 1), u2 =
(bits2 >> 8) / 2^24, z = sqrt(-2 ln u1) cos(2 pi u2).

On a CUDA tensor this launches kernel K3, a Triton kernel that draws its
bits with Philox (``tl.randint4x``) keyed by the client's 64-bit seed at
counter = element index, so every (seed, element) pair is its own stream.
On a CPU tensor it takes the plain PyTorch version, which draws the same
uniforms' distribution from one ``torch.Generator`` per client seed. The
two give different bits by construction; tests compare distributions.

K3 replaces ``_clip_noise_kernel`` (fl_tpu/ops/dp.py). What bounds it on
the H100: it reads each element once and writes it once (8 B/element,
about 1.7 GB a round at the 512-client bench), with ~40 flops of Philox and
Box–Muller per element — far under the 295 flop/byte ridge, so it is bound
by memory bandwidth. Its design streams each client row with masked
1024-element block loads and stores, and keeps every random draw in
registers, so nothing but x and the output touches device memory.
"""

from __future__ import annotations

import math

import torch

BLOCK = 1024
LAUNCHES = {"clip_noise": 0}


def gaussian_factor(epsilon: float, delta: float) -> float:
    """σ/sensitivity of the Gaussian mechanism (ref: privacy.py:209)."""
    return math.sqrt(2.0 * math.log(1.25 / delta)) / epsilon


def _check(x, scale, sigma, seeds):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be (C, D) float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    C = x.shape[0]
    for name, t, dt in (("scale", scale, torch.float32),
                        ("sigma", sigma, torch.float32),
                        ("seeds", seeds, torch.int64)):
        if tuple(t.shape) != (C,) or t.dtype != dt:
            raise ValueError(f"{name} must be ({C},) {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}")


def box_muller(bits1: torch.Tensor, bits2: torch.Tensor) -> torch.Tensor:
    """N(0, 1) from two tensors of 24-bit integers (the top 24 bits of two
    uniform 32-bit draws), as the TPU kernel forms them."""
    u1 = bits1.float() * (1.0 / (1 << 24)) + (1.0 / (1 << 25))
    u2 = bits2.float() * (1.0 / (1 << 24))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def clip_noise_plain(x, scale, sigma, seeds):
    """The plain PyTorch version: one generator per client seed."""
    _check(x, scale, sigma, seeds)
    out = torch.empty_like(x)
    for c, seed in enumerate(seeds.tolist()):
        g = torch.Generator(device=x.device)
        g.manual_seed(seed & ((1 << 63) - 1))
        bits = torch.randint(0, 1 << 24, (2, x.shape[1]), generator=g,
                             device=x.device, dtype=torch.int32)
        out[c] = x[c] * scale[c] + sigma[c] * box_muller(bits[0], bits[1])
    return out


def _kernel():
    """K3, compiled at first use (Triton is imported only here)."""
    import triton
    import triton.language as tl

    @triton.jit
    def clip_noise_kernel(x_ptr, out_ptr, scale_ptr, sigma_ptr, seed_ptr, D,
                          BLOCK: tl.constexpr):
        c = tl.program_id(1)
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < D
        row = c.to(tl.int64) * D
        x = tl.load(x_ptr + row + offs, mask=mask, other=0.0)
        scale = tl.load(scale_ptr + c)
        sigma = tl.load(sigma_ptr + c)
        seed = tl.load(seed_ptr + c)
        r1, r2, _, _ = tl.randint4x(seed, offs)
        u1 = (r1 >> 8).to(tl.float32) * (1.0 / 16777216.0) \
            + (1.0 / 33554432.0)
        u2 = (r2 >> 8).to(tl.float32) * (1.0 / 16777216.0)
        z = tl.sqrt(-2.0 * tl.log(u1)) * tl.cos(6.283185307179586 * u2)
        tl.store(out_ptr + row + offs, x * scale + sigma * z, mask=mask)

    return clip_noise_kernel


_compiled = None


def clip_noise_cuda(x, scale, sigma, seeds):
    """Launch K3 on x's device and the current stream."""
    global _compiled
    _check(x, scale, sigma, seeds)
    if not all(t.is_cuda and t.is_contiguous()
               for t in (x, scale, sigma, seeds)):
        raise ValueError("clip_noise_cuda needs contiguous CUDA tensors")
    if _compiled is None:
        _compiled = _kernel()
    C, D = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _compiled[(-(-D // BLOCK), C)](x, out, scale, sigma, seeds, D,
                                       BLOCK=BLOCK, num_warps=4)
    LAUNCHES["clip_noise"] += 1
    return out


def clip_noise(x: torch.Tensor, scale: torch.Tensor, sigma: torch.Tensor,
               seeds: torch.Tensor) -> torch.Tensor:
    """x (C, D) f32 * scale (C,) + sigma (C,) * N(0, 1) noise keyed by
    seeds (C,) int64. CUDA tensors launch K3; CPU tensors take the plain
    version."""
    if x.is_cuda:
        return clip_noise_cuda(x.contiguous(), scale, sigma, seeds)
    return clip_noise_plain(x, scale, sigma, seeds)
