"""Fused DP clip + Gaussian noise over a stacked (C, D) update matrix.

``clip_noise(x, scale, sigma, seeds)`` returns ``x[c] * scale[c] +
sigma[c] * z`` with z ~ N(0, 1) drawn element by element from client c's
seed — the counterpart of ``fl_tpu.ops.dp._clip_noise_pallas``. The
Gaussian is Box–Muller on two 24-bit uniforms exactly as the TPU kernel
builds them: u1 = (bits1 >> 8) / 2^24 + 2^-25 in [2^-25, 1), u2 =
(bits2 >> 8) / 2^24, r = sqrt(-2 ln u1), theta = 2 pi u2.

On a CUDA tensor this launches kernel K3, a Triton kernel that draws its
bits with Philox4x32-10 (``tl.randint4x``) keyed by the client's 64-bit
seed. One call gives four 32-bit words, and all four are used: words 0 and
1 make one Box–Muller pair, whose r cos(theta) and r sin(theta) are two
elements' noise, and words 2 and 3 make another. :func:`noise_layout` is
the map from an element to its (counter, word); no (seed, counter, word)
feeds two elements. On a CPU tensor it takes the plain PyTorch version,
which draws the same uniforms' distribution from one ``torch.Generator``
per client seed. The two give different bits by construction; the tests
hold K3 to a numpy Philox oracle through the map, and the plain version
by its distribution.

K3 replaces ``_clip_noise_kernel`` (fl_tpu/ops/dp.py). The least time for
its work on the H100 is the bytes: it reads each element once and writes it
once (8 B an element, 1.73 GB a round at the 512-client bench, 0.516 ms at
3.35 TB/s), with about 10 f32 operations an element. The first design drew
one whole Philox call an element and used two of its words, and that held
it at 2.2x the bound: in its compiled code an element cost 129 instructions
on the path it runs, 68 of them integer (Philox's ten rounds of 32-bit
products). At one instruction a clock on each of an SM's 128 lanes, 216 M
elements take 0.83 ms at 1.98 GHz for that alone, more than the bytes need.
This design makes one call for four elements, which cuts that to 70
instructions (0.45 ms), 28 of them integer, and leaves the loads and stores
as the limit. A program covers 4·BQ elements of one client row as four
contiguous quarters, each loaded and stored coalesced and masked on its own
(the small leaf group's width is no multiple of 4); lane i of program p
calls Philox at counter BQ·p + i, and x, the draws and the output never
leave registers. (Counts: ``tools/rng_kernels.py isa``.)
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Tuple

import numpy as np
import torch

# Philox calls (lanes) a program makes; it covers 4·BQ elements of a row
BQ = 512
NUM_WARPS = 4
MAX_D = (1 << 31) - 1 - 4 * BQ
LAUNCHES = {"clip_noise": 0}
# the deployment round's client threads launch K3 concurrently: the lazy
# compile and the count's read-modify-write are made under this lock
_lock = threading.Lock()


def gaussian_factor(epsilon: float, delta: float) -> float:
    """σ/sensitivity of the Gaussian mechanism (ref: privacy.py:209)."""
    return math.sqrt(2.0 * math.log(1.25 / delta)) / epsilon


def clip_factors(norms: torch.Tensor, max_norm
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's clip scale min(1, C / max(‖row‖, 1e-12)) and its clipped
    norm min(‖row‖, C), the release's sensitivity, from the (C,) norms."""
    scale = torch.clamp(max_norm / torch.clamp(norms, min=1e-12), max=1.0)
    return scale, torch.clamp(norms, max=max_norm)


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


def noise_layout(D: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counter, word) of each element of a client's row of width D, as K3
    draws them: program p covers elements [4·BQ·p, 4·BQ·(p+1)) as four
    contiguous quarters, and element 4·BQ·p + q·BQ + i takes word q of the
    Philox call at counter BQ·p + i. Words 0 and 1 are one Box–Muller pair
    (quarter 0 its cosine, quarter 1 its sine), words 2 and 3 the other."""
    j = torch.arange(D, dtype=torch.int64)
    p, r = j // (4 * BQ), j % (4 * BQ)
    return p * BQ + r % BQ, r // BQ


def _kernel():
    """K3, compiled at first use (Triton is imported only here)."""
    import triton
    import triton.language as tl

    @triton.jit
    def clip_noise_kernel(x_ptr, out_ptr, scale_ptr, sigma_ptr, seed_ptr, D,
                          BQ: tl.constexpr):
        c = tl.program_id(1)
        p = tl.program_id(0)
        lane = tl.arange(0, BQ)
        row = c.to(tl.int64) * D
        # the four quarters of this program's 4·BQ elements
        o0 = p * (4 * BQ) + lane
        o1 = o0 + BQ
        o2 = o1 + BQ
        o3 = o2 + BQ
        x0 = tl.load(x_ptr + row + o0, mask=o0 < D, other=0.0)
        x1 = tl.load(x_ptr + row + o1, mask=o1 < D, other=0.0)
        x2 = tl.load(x_ptr + row + o2, mask=o2 < D, other=0.0)
        x3 = tl.load(x_ptr + row + o3, mask=o3 < D, other=0.0)
        scale = tl.load(scale_ptr + c)
        sigma = tl.load(sigma_ptr + c)
        seed = tl.load(seed_ptr + c)
        # one Philox4x32-10 call a lane, two Box–Muller pairs from it
        w0, w1, w2, w3 = tl.randint4x(seed, p * BQ + lane)
        ra = tl.sqrt(-2.0 * tl.log((w0 >> 8).to(tl.float32)
                                   * (1.0 / 16777216.0)
                                   + (1.0 / 33554432.0)))
        ta = 6.283185307179586 * ((w1 >> 8).to(tl.float32)
                                  * (1.0 / 16777216.0))
        rb = tl.sqrt(-2.0 * tl.log((w2 >> 8).to(tl.float32)
                                   * (1.0 / 16777216.0)
                                   + (1.0 / 33554432.0)))
        tb = 6.283185307179586 * ((w3 >> 8).to(tl.float32)
                                  * (1.0 / 16777216.0))
        tl.store(out_ptr + row + o0, x0 * scale + sigma * (ra * tl.cos(ta)),
                 mask=o0 < D)
        tl.store(out_ptr + row + o1, x1 * scale + sigma * (ra * tl.sin(ta)),
                 mask=o1 < D)
        tl.store(out_ptr + row + o2, x2 * scale + sigma * (rb * tl.cos(tb)),
                 mask=o2 < D)
        tl.store(out_ptr + row + o3, x3 * scale + sigma * (rb * tl.sin(tb)),
                 mask=o3 < D)

    return clip_noise_kernel


_compiled = None


def clip_noise_cuda(x, scale, sigma, seeds):
    """Launch K3 on x's device and the current stream."""
    global _compiled
    _check(x, scale, sigma, seeds)
    if not all(t.is_cuda and t.is_contiguous()
               for t in (x, scale, sigma, seeds)):
        raise ValueError("clip_noise_cuda needs contiguous CUDA tensors")
    C, D = x.shape
    if D > MAX_D:
        raise ValueError(f"D={D} must be at most {MAX_D} (the kernel's "
                         "column offsets are 32-bit)")
    with _lock:
        if _compiled is None:
            _compiled = _kernel()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _compiled[(-(-D // (4 * BQ)), C)](x, out, scale, sigma, seeds, D,
                                          BQ=BQ, num_warps=NUM_WARPS)
    with _lock:
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


def clip_noise_route(use_pallas: Optional[bool]):
    """The clip+noise function ``use_pallas`` asks for: None is
    :func:`clip_noise` (K3 on a CUDA tensor, the plain version on a CPU
    one), True K3 (a CPU tensor raises), False the plain version."""
    return {None: clip_noise, True: clip_noise_cuda,
            False: clip_noise_plain}[use_pallas]


def clip_noise_matrix(x: torch.Tensor, seeds, epsilon: float, delta: float,
                      max_norm: float, d_valid: Optional[int] = None,
                      use_pallas: Optional[bool] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference-mode DP over a (C, D) flat update matrix, the port of
    ``fl_tpu.ops.dp.clip_noise_matrix``.

    Per client: clip the row's L2 norm to ``max_norm``, set σ =
    min(‖row‖, max_norm)·√(2·ln(1.25/δ))/ε (sensitivity = the clipped
    norm), add N(0, σ²) to every element. ``d_valid`` restricts the norm
    to the unpadded prefix. ``seeds`` are the clients' (C,) noise seeds
    (ints, a numpy array or an int64 tensor). ``use_pallas`` as
    :func:`clip_noise_route`.

    Returns (noisy matrix, sensitivity (C,), sigma (C,))."""
    if x.dim() != 2:
        raise ValueError(f"x must be (C, D), got {tuple(x.shape)}")
    C, D = x.shape
    x = x.float().contiguous()
    rows = x if d_valid is None or d_valid == D else x[:, :d_valid]
    scale, sens = clip_factors(rows.square().sum(1).sqrt(), max_norm)
    sigma = sens * gaussian_factor(epsilon, delta)
    if isinstance(seeds, torch.Tensor):
        seeds = seeds.to(device=x.device, dtype=torch.int64)
    else:
        seeds = torch.as_tensor(
            np.asarray(seeds, np.uint64).view(np.int64)).to(x.device)
    return (clip_noise_route(use_pallas)(x, scale.contiguous(),
                                         sigma.contiguous(), seeds),
            sens, sigma)
