"""The two probe kernels of the conv-formulations measurement.

``batched_gemm(a, b)`` and ``taploop_conv(x, w)`` are the counterparts of
``pallas_batched_gemm`` and ``pallas_taploop_conv`` in the reference's
``scripts/probe_pallas_pipelined.py``. The probe sets three costs side by
side: the library convolution, the bare product on a patch matrix that
already exists in device memory (``batched_gemm``), and the convolution as a
loop over the nine taps with no patch matrix (``taploop_conv``); the patch
GEMM that forms the matrix in fast memory is ``ops/conv_patch.py``. The
reference fixes the conv2 shapes of the bench in module constants; here they
are read off the arguments.

    batched_gemm   a (C, M, K) @ b (C, K, N) -> (C, M, N) in a's dtype
    taploop_conv   x (C, B, H, W, I), w (C, 3, 3, I, O) -> (C, B, H, W, O)
                   in x's dtype, the 3x3 stride-1 SAME conv

Both sum in f32 and round once. ``taploop_conv`` returns the true SAME
conv: the reference's wrapper reads its kernel's rows one pixel off (it
slices at (h + 1, w + 1) where output (h, w) lives at (h, w)), so its
result is the convolution shifted by one with a garbage last row and
column; the kernel body is right and is what is ported.

On a CUDA tensor they launch kernels K8a and K8b (``csrc/conv_probe.cu``);
on a CPU tensor the plain PyTorch versions below, which are also the
oracles the kernels are held to. Forward only, as in the reference.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fl_tpu_torch.ops import _build
from fl_tpu_torch.ops.conv import check_conv_shapes
from fl_tpu_torch.ops.conv_block import (IMAGES_PER_BLOCK, SMEM_LIMIT,
                                         _DTYPE_CODE, _check_cuda, _ptr)

MAX_THREADS = 512   # kMaxThreads of csrc/conv_probe.cu

# one count per kernel, raised where it is launched
LAUNCHES = {"probe_batched_gemm": 0, "probe_taploop_conv": 0}


def _check_gemm_shapes(a, b):
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or (
            a.shape[2] != b.shape[1]):
        raise ValueError(f"batched_gemm takes a (C, M, K) and b (C, K, N), "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def batched_gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One f32 product per client, rounded to a's dtype."""
    _check_gemm_shapes(a, b)
    return torch.bmm(a.float(), b.float()).to(a.dtype)


def taploop_conv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Nine shifted K = I products in f32, accumulated in tap order, then
    one rounding to x's dtype."""
    check_conv_shapes(x, w)
    C, B, H, W, I = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros((C, B * H * W, w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for dh in range(3):
        for dw in range(3):
            rows = xp[:, :, dh:dh + H, dw:dw + W, :].reshape(C, -1, I)
            acc += torch.bmm(rows, wf[:, dh, dw])
    return acc.reshape(C, B, H, W, -1).to(x.dtype)


# ---------------------------------------------------------------------------
# CUDA launchers (K8)
# ---------------------------------------------------------------------------

def _check_dtype(name, t):
    if t.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: compute dtype must be float32 or "
                         f"bfloat16, got {t.dtype}")


def batched_gemm_cuda(a, b):
    """Launch ``batched_gemm_kernel`` (K8a)."""
    name = "probe_batched_gemm"
    _check_gemm_shapes(a, b)
    _check_dtype(name, a)
    _check_cuda(name, (a, b), (a.dtype, a.dtype))
    C, M, K = a.shape
    N = b.shape[2]
    if -(-M // 64) > 65535 or C > 65535:
        raise ValueError(f"{name}: M={M} or C={C} is beyond the launch grid")
    lib = _build.load()
    out = torch.empty((C, M, N), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.fl_batched_gemm(_DTYPE_CODE[a.dtype], _ptr(a), _ptr(b),
                                 _ptr(out), C, M, K, N,
                                 ctypes.c_void_p(stream))
    _build.check(lib, rc, name)
    LAUNCHES[name] += 1
    return out


def _pick_band(lib, cdt, H, W, I, O) -> int:
    """Image rows a block stages at once: the whole image where it leaves
    room for two blocks on an SM, else the most rows that fit one block."""
    def need(th):
        return lib.fl_taploop_smem_bytes(_DTYPE_CODE[cdt], W, I, O, th)

    for limit in (SMEM_LIMIT // 2, SMEM_LIMIT):
        for th in range(H, 0, -1):
            if need(th) <= limit:
                return th
    raise ValueError(
        f"taploop_conv: rows of width {W} with I={I}, O={O} in {cdt} need "
        f"{need(1)} B of shared memory per block (limit {SMEM_LIMIT})")


def taploop_conv_cuda(x, w):
    """Launch ``taploop_conv_kernel`` (K8b): x (C, B, H, W, I) and
    w (C, 3, 3, I, O) in the compute dtype."""
    name = "probe_taploop_conv"
    check_conv_shapes(x, w)
    _check_dtype(name, x)
    _check_cuda(name, (x, w), (x.dtype, x.dtype))
    C, B, H, W, I = x.shape
    O = w.shape[-1]
    lib = _build.load()
    band = _pick_band(lib, x.dtype, H, W, I, O)
    # 4 positions x 4 channels a thread; as few sweeps over a band's tasks
    # as MAX_THREADS allows, then no more threads than they need
    tasks = -(-band * W // 4) * (-(-O // 4))
    sweeps = -(-tasks // MAX_THREADS)
    threads = min(MAX_THREADS, (-(-tasks // sweeps) + 31) // 32 * 32)
    y = torch.empty((C, B, H, W, O), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fl_taploop_conv(
            _DTYPE_CODE[x.dtype], _ptr(x), _ptr(w), _ptr(y), C, B, H, W, I,
            O, band, IMAGES_PER_BLOCK, threads, ctypes.c_void_p(stream))
    _build.check(lib, rc, name)
    LAUNCHES[name] += 1
    return y


# ---------------------------------------------------------------------------
# the public ops
# ---------------------------------------------------------------------------

def batched_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(C, M, K) @ (C, K, N) -> (C, M, N) in a's dtype, f32 sums; b is cast
    to a's dtype."""
    b = b.to(a.dtype)
    if a.is_cuda:
        return batched_gemm_cuda(a.contiguous(), b.contiguous())
    return batched_gemm_plain(a, b)


def taploop_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv forward over stacked clients as a loop over
    the nine taps: x (C, B, H, W, I), w (C, 3, 3, I, O) -> (C, B, H, W, O)
    in x's dtype, f32 sums; w is cast to x's dtype."""
    w = w.to(x.dtype)
    if x.is_cuda:
        return taploop_conv_cuda(x.contiguous(), w.contiguous())
    return taploop_conv_plain(x, w)
