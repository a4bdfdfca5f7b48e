"""The fused SimpleCNN conv segment over stacked clients.

``conv_stack_res(x, w1, b1, w2, b2)`` computes, for every client c with its
own weights,

    pool2(relu(conv2(pool2(relu(conv1(x[c]) + b1[c]))) + b2[c]))

with SAME 3x3 convolutions and 2x2 max pools, and is the counterpart of
``fl_tpu.ops.conv_block.conv_stack_res`` under the engine's client vmap.
Shapes: x (C, B, H, W, 1), w1 (C, 3, 3, 1, C1), b1 (C, C1),
w2 (C, 3, 3, C1, C2), b2 (C, C2) -> (C, B, H/4, W/4, C2), NHWC and HWIO as
in the reference.

Numerics (the TPU kernels' contract): the compute dtype is x's dtype;
weights and biases are rounded to it on entry and the biases are then
added in f32; every product accumulates in f32; y1 and a2 are rounded to
the compute dtype after their relu and the pool maxima stay in it; both
pools break ties by first match in row-major window order; the image
gradient is zero. Weight gradients come back in the weights' own dtype
without a rounding to the compute dtype, as the reference's custom VJP
returns f32 cotangents.

On a CUDA tensor the forward launches kernel K1 and the backward kernel K2
(``csrc/conv_block.cu``); on a CPU tensor both take the plain PyTorch
version below, which is also the oracle the kernels are held to.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from fl_tpu_torch.ops import _build

# Images per CUDA block: one block loads a client's weights once for this
# many images (and, in the backward, sums their gradients in one slot).
IMAGES_PER_BLOCK = 4
# CUDA threads per block. One backward block fills most of an SM's shared
# memory, so its thread count is its occupancy: at the bench shapes on an
# H100 (700 W) the backward ran 42 ms at 256 threads and 27 ms at 1024;
# the forward is flat from 256 to 1024 (PERF.md, Findings).
THREADS = {"fwd": 512, "bwd": 1024}
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use

LAUNCHES = {"conv_block_fwd": 0, "conv_block_bwd": 0}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(x, w1, b1, w2, b2=None):
    if x.dim() != 5 or x.shape[-1] != 1:
        raise ValueError(f"x must be (C, B, H, W, 1), got {tuple(x.shape)}")
    C, _, H, W, _ = x.shape
    if H % 2 or W % 2 or H < 4 or W < 4:
        raise ValueError(f"image sides must be even and >= 4, got {H}x{W}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"compute dtype must be float32 or bfloat16, "
                         f"got {x.dtype}")
    C1, C2 = w1.shape[-1], w2.shape[-1]
    want = {"w1": (C, 3, 3, 1, C1), "b1": (C, C1),
            "w2": (C, 3, 3, C1, C2)}
    got = {"w1": w1.shape, "b1": b1.shape, "w2": w2.shape}
    if b2 is not None:
        want["b2"], got["b2"] = (C, C2), b2.shape
    for k in want:
        if tuple(got[k]) != want[k]:
            raise ValueError(f"{k} must be {want[k]}, got {tuple(got[k])}")
    return C, H, W, C1, C2


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _r(t: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """Round to the compute dtype and return f32 (identity for f32)."""
    return t.to(cdt).float()


def _pool_first(t: torch.Tensor):
    """2x2/2 max pool with first-match window index (0..3, row-major) on an
    (N, ch, h, w) f32 plane; odd trailing rows/cols are dropped."""
    N, ch, h, w = t.shape
    ho, wo = h // 2, w // 2
    v = t[:, :, :2 * ho, :2 * wo].reshape(N, ch, ho, 2, wo, 2)
    a, b = v[:, :, :, 0, :, 0], v[:, :, :, 0, :, 1]
    c, d = v[:, :, :, 1, :, 0], v[:, :, :, 1, :, 1]
    m = torch.maximum(torch.maximum(a, b), torch.maximum(c, d))
    idx = torch.where(a == m, 0, torch.where(b == m, 1,
                                             torch.where(c == m, 2, 3)))
    return m, idx.to(torch.uint8)


def _unpool(g: torch.Tensor, idx: torch.Tensor, h: int, w: int):
    """Adjoint of :func:`_pool_first`: g (N, ch, ho, wo) placed on the
    indexed window member of an (N, ch, h, w) zero plane."""
    N, ch, ho, wo = g.shape
    onehot = F.one_hot(idx.long(), 4).to(g.dtype)          # (.., ho, wo, 4)
    onehot = onehot.reshape(N, ch, ho, wo, 2, 2).permute(0, 1, 2, 4, 3, 5)
    out = (g[:, :, :, None, :, None] * onehot).reshape(N, ch, 2 * ho, 2 * wo)
    return F.pad(out, (0, w - 2 * wo, 0, h - 2 * ho))


def _grouped(x, w1, w2):
    """Client-as-channel layouts for grouped convolutions: the image as
    (B, C, H, W) f32 and the weights as (C*Cout, Cin, 3, 3) f32."""
    C, B, H, W, _ = x.shape
    xf = x.float().reshape(C, B, H, W).permute(1, 0, 2, 3)
    w1g = w1.float().permute(0, 4, 3, 1, 2).reshape(-1, 1, 3, 3)
    w2g = w2.float().permute(0, 4, 3, 1, 2).reshape(
        -1, w2.shape[3], 3, 3)
    return xf, w1g, w2g


def _stem_plain(xf, w1g, b1, C, cdt):
    """conv1 -> +b1 (f32) -> relu -> round -> pool1: returns the pool1
    plane x2 and its first-match window index."""
    y1 = F.conv2d(xf, w1g, padding=1, groups=C) + b1.reshape(1, -1, 1, 1)
    return _pool_first(_r(torch.relu(y1), cdt))


def _a2_plain(x, w1, b1, w2, b2):
    """The conv2 -> +b2 -> relu -> round plane, (B, C*C2, H/2, W/2) f32."""
    C = x.shape[0]
    cdt = x.dtype
    xf, w1g, w2g = _grouped(x, w1, w2)
    x2, _ = _stem_plain(xf, w1g, b1, C, cdt)
    y2 = F.conv2d(x2, w2g, padding=1, groups=C) + b2.reshape(1, -1, 1, 1)
    return _r(torch.relu(y2), cdt)


def conv_stack_res_fwd_plain(x, w1, b1, w2, b2):
    """Plain forward: (pooled (C, B, H/4, W/4, C2) in x's dtype, idx uint8
    of the same shape). Weights in the compute dtype, biases f32."""
    C, _, _, _, C2 = _check_shapes(x, w1, b1, w2, b2)
    pooled, idx = _pool_first(_a2_plain(x, w1, b1, w2, b2))
    B, _, ho, wo = pooled.shape

    def to_nhwc(t):
        return t.reshape(B, C, C2, ho, wo).permute(1, 0, 3, 4, 2).contiguous()

    return to_nhwc(pooled).to(x.dtype), to_nhwc(idx)


def pool2_windows_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """The four pool2 window members of the plain version,
    (C, B, H/4, W/4, C2, 4) f32 in window order — to tell a kernel's
    index choice at a near-tie from a wrong one. Same argument types as
    :func:`conv_stack_res_fwd_plain`."""
    C, _, _, _, C2 = _check_shapes(x, w1, b1, w2, b2)
    a2 = _a2_plain(x, w1, b1, w2, b2)
    B, _, h, w = a2.shape
    v = a2[:, :, :h // 2 * 2, :w // 2 * 2].reshape(
        B, C, C2, h // 2, 2, w // 2, 2)
    return v.permute(1, 0, 3, 5, 2, 4, 6).reshape(
        C, B, h // 2, w // 2, C2, 4).contiguous()


def conv_stack_res_bwd_plain(g, idx, x, w1, b1, w2):
    """Plain backward: g (C, B, H/4, W/4, C2) already multiplied by
    relu2' = (pooled > 0) and in the compute dtype. Returns f32
    (dw1 (C,3,3,1,C1), db1 (C,C1), dw2 (C,3,3,C1,C2), db2 (C,C2))."""
    C, H, W, C1, C2 = _check_shapes(x, w1, b1, w2)
    cdt = x.dtype
    B = x.shape[1]
    xf, w1g, w2g = _grouped(x, w1, w2)
    x2, arg1 = _stem_plain(xf, w1g, b1, C, cdt)

    def to_planes(t):   # (C, B, ho, wo, C2) -> (B, C*C2, ho, wo)
        return t.permute(1, 0, 4, 2, 3).reshape(B, C * C2, *t.shape[2:4])

    conv_bwd = torch.ops.aten.convolution_backward
    dz2 = _unpool(to_planes(g.float()), to_planes(idx), H // 2, W // 2)
    db2 = dz2.sum((0, 2, 3)).reshape(C, C2)
    dx2, dw2g, _ = conv_bwd(dz2, x2, w2g, None, [1, 1], [1, 1], [1, 1],
                            False, [0, 0], C, [True, True, False])
    dx2 = dx2 * (x2 > 0)
    dz1 = _unpool(dx2, arg1, H, W)
    db1 = dz1.sum((0, 2, 3)).reshape(C, C1)
    _, dw1g, _ = conv_bwd(_r(dz1, cdt), xf, w1g, None, [1, 1], [1, 1],
                          [1, 1], False, [0, 0], C, [False, True, False])
    dw1 = dw1g.reshape(C, C1, 1, 3, 3).permute(0, 3, 4, 2, 1)
    dw2 = dw2g.reshape(C, C2, C1, 3, 3).permute(0, 3, 4, 2, 1)
    return dw1.contiguous(), db1, dw2.contiguous(), db2


# ---------------------------------------------------------------------------
# CUDA launchers (K1, K2)
# ---------------------------------------------------------------------------

def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check_cuda(name, tensors, dtypes):
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{name}: every tensor must be on {dev}")
        if t.dtype != dt:
            raise ValueError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _check_smem(lib, backward, cdt, H, W, C1, C2):
    need = lib.fl_conv_block_smem_bytes(int(backward), _DTYPE_CODE[cdt],
                                        H, W, C1, C2)
    if need > SMEM_LIMIT:
        raise ValueError(f"conv_block: {H}x{W} images with C1={C1}, "
                         f"C2={C2} need {need} B of shared memory per block "
                         f"(limit {SMEM_LIMIT})")


def conv_block_fwd_cuda(x, w1, b1, w2, b2):
    """Launch K1. x, w1, w2 in the compute dtype; b1, b2 f32."""
    C, H, W, C1, C2 = _check_shapes(x, w1, b1, w2, b2)
    cdt = x.dtype
    _check_cuda("conv_block_fwd", (x, w1, b1, w2, b2),
                (cdt, cdt, torch.float32, cdt, torch.float32))
    lib = _build.load()
    _check_smem(lib, False, cdt, H, W, C1, C2)
    B = x.shape[1]
    shape = (C, B, H // 4, W // 4, C2)
    pooled = torch.empty(shape, dtype=cdt, device=x.device)
    idx = torch.empty(shape, dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fl_conv_block_fwd(
            _DTYPE_CODE[cdt], _ptr(x), _ptr(w1), _ptr(b1), _ptr(w2),
            _ptr(b2), _ptr(pooled), _ptr(idx), C, B, H, W, C1, C2,
            IMAGES_PER_BLOCK, THREADS["fwd"], ctypes.c_void_p(stream))
    _build.check(lib, rc, "conv_block_fwd")
    LAUNCHES["conv_block_fwd"] += 1
    return pooled, idx


def conv_block_bwd_cuda(g, idx, x, w1, b1, w2):
    """Launch K2 (the per-block pass and its fixed-order reduction).
    g in the compute dtype, already multiplied by (pooled > 0)."""
    C, H, W, C1, C2 = _check_shapes(x, w1, b1, w2)
    cdt = x.dtype
    B = x.shape[1]
    if tuple(g.shape) != (C, B, H // 4, W // 4, C2) or g.shape != idx.shape:
        raise ValueError(f"g and idx must be {(C, B, H // 4, W // 4, C2)}")
    _check_cuda("conv_block_bwd", (g, idx, x, w1, b1, w2),
                (cdt, torch.uint8, cdt, cdt, torch.float32, cdt))
    lib = _build.load()
    _check_smem(lib, True, cdt, H, W, C1, C2)
    P = 9 * C1 + C1 + 9 * C1 * C2 + C2
    ng = -(-B // IMAGES_PER_BLOCK)
    partial = torch.empty((C, ng, P), dtype=torch.float32, device=x.device)
    out = torch.empty((C, P), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fl_conv_block_bwd(
            _DTYPE_CODE[cdt], _ptr(g), _ptr(idx), _ptr(x), _ptr(w1),
            _ptr(b1), _ptr(w2), _ptr(partial), _ptr(out), C, B, H, W, C1,
            C2, IMAGES_PER_BLOCK, THREADS["bwd"], ctypes.c_void_p(stream))
    _build.check(lib, rc, "conv_block_bwd")
    LAUNCHES["conv_block_bwd"] += 1
    dw1, db1, dw2, db2 = torch.split(out, [9 * C1, C1, 9 * C1 * C2, C2], 1)
    return (dw1.reshape(C, 3, 3, 1, C1), db1.contiguous(),
            dw2.reshape(C, 3, 3, C1, C2), db2.contiguous())


# ---------------------------------------------------------------------------
# the public op
# ---------------------------------------------------------------------------

class _ConvStackRes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        cdt = x.dtype
        w1c, w2c = w1.to(cdt).contiguous(), w2.to(cdt).contiguous()
        b1f = b1.to(cdt).float().contiguous()
        b2f = b2.to(cdt).float().contiguous()
        x = x.contiguous()
        if x.is_cuda:
            pooled, idx = conv_block_fwd_cuda(x, w1c, b1f, w2c, b2f)
        else:
            pooled, idx = conv_stack_res_fwd_plain(x, w1c, b1f, w2c, b2f)
        ctx.save_for_backward(x, w1c, b1f, w2c, pooled, idx)
        ctx.dtypes = (w1.dtype, b1.dtype, w2.dtype, b2.dtype)
        return pooled

    @staticmethod
    def backward(ctx, g):
        x, w1c, b1f, w2c, pooled, idx = ctx.saved_tensors
        # relu2' at the routed position: a2 there equals the window max
        g = (g * (pooled > 0)).to(x.dtype).contiguous()
        if x.is_cuda:
            grads = conv_block_bwd_cuda(g, idx, x, w1c, b1f, w2c)
        else:
            grads = conv_stack_res_bwd_plain(g, idx, x, w1c, b1f, w2c)
        return (None,) + tuple(t.to(dt) for t, dt in zip(grads, ctx.dtypes))


def conv_stack_res(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The fused conv segment over stacked clients (see the module
    docstring). Differentiable in the weights; the image gets no
    gradient."""
    _check_shapes(x, w1, b1, w2, b2)
    return _ConvStackRes.apply(x, w1, b1, w2, b2)


def conv_stack_res_plain(x, w1, b1, w2, b2) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The plain PyTorch forward on any device, with the same entry casts
    as :func:`conv_stack_res`: (pooled, idx)."""
    cdt = x.dtype
    return conv_stack_res_fwd_plain(
        x, w1.to(cdt), b1.to(cdt).float(), w2.to(cdt), b2.to(cdt).float())
