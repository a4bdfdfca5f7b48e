"""The fused SimpleCNN conv segment over stacked clients.

``conv_stack_res(x, w1, b1, w2, b2)`` and ``conv_stack(x, w1, b1, w2, b2)``
compute, for every client c with its own weights,

    pool2(relu(conv2(pool2(relu(conv1(x[c]) + b1[c]))) + b2[c]))

with SAME 3x3 convolutions and 2x2 max pools, and are the counterparts of
``fl_tpu.ops.conv_block.conv_stack_res`` and ``conv_stack`` under the
engine's client vmap. Shapes: x (C, B, H, W, 1), w1 (C, 3, 3, 1, C1),
b1 (C, C1), w2 (C, 3, 3, C1, C2), b2 (C, C2) -> (C, B, H/4, W/4, C2), NHWC
and HWIO as in the reference.

The two differ in what the forward keeps for the backward.
``conv_stack_res`` keeps the pooled output and the pool2 first-match window
index; ``conv_stack`` is residual-free: it keeps the image and the weights
only, and its backward recomputes the forward chain to find the pool2
routing and relu2' = (a2 > 0) itself. ``conv_stack_packed`` is the
reference's entry point for P clients at once; here the client dimension of
the launch grid does what packing clients onto the TPU's lanes did, so it
is ``conv_stack``'s kernels over the P axis behind the reference's
signature. The reference's block-diagonal weight packers (``pack_stem``,
``pack_conv2``, ``_eye_pack``, ``_pair_lifted``) and its space-to-depth stem
lift (``lift_stem``, ``_s2d_lift_matrix``) are TPU layout and have no
counterpart here.

Numerics (the TPU kernels' contract): the compute dtype is x's dtype;
weights and biases are rounded to it on entry and the biases are then
added in f32; every product accumulates in f32; y1 and a2 are rounded to
the compute dtype after their relu and the pool maxima stay in it; both
pools break ties by first match in row-major window order; the image
gradient is zero. Weight gradients come back in the weights' own dtype
without a rounding to the compute dtype, as the reference's custom VJP
returns f32 cotangents.

On a CUDA tensor ``conv_stack_res`` launches kernels K1 and K2, and
``conv_stack`` and ``conv_stack_packed`` the two K4 kernels
(``csrc/conv_block.cu``); on a CPU tensor they take the plain PyTorch
versions below, which are also the oracles the kernels are held to.

Every kernel of the segment takes one of two routes, which the dtype alone
fixes (``ROUTES``; ``launch_plan`` gives a launch's route, instruction,
threads and shared memory; ``ROUTE_LAUNCHES`` counts the launches by
kernel and route). In float32 all four run on the CUDA cores, and K4's
backward is K2's device functions after a recompute, bit for bit K2's
gradients (TF32 would break the f32 contract). In bfloat16 the stem stays
on the CUDA cores and conv2 runs on ``mma.sync``: in the forwards of K1
and K4 (``conv_block_fwd_tc_kernel``, ``conv_stack_fwd_tc_kernel``) and
in K4's backward recompute through one device function, so K1's index
and K4's masks are the same bits; the conv2 input and weight gradients of
K2 and K4 (``conv_block_bwd_tc_kernel``, ``conv_stack_bwd_tc_kernel``) run
one body, so K4's gradients equal K2's fed K1's residuals bit for bit.
The tensor cores sum in another order than the plain version, so bf16
values are held to it within one ulp, the index differs only at its
near-ties, and the gradients are held within K2's tolerance; every kernel
repeats bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from fl_tpu_torch.ops import _build

# Images per CUDA block: one block loads a client's weights once for this
# many images (and, in the backward, sums their gradients in one slot).
IMAGES_PER_BLOCK = 4
# CUDA threads per block, by kernel and route (``_tc``: bfloat16). One
# backward block fills most of an SM's shared memory, so its thread count is
# its occupancy: at the bench shapes on an H100 (700 W) K2 on the CUDA cores
# ran 42 ms at 256 threads and 27 ms at 1024; both CUDA-core forwards are
# flat from 256 to 1024, with their best at 512 (PERF.md, Findings;
# tools/profile_round.py sweep). The bf16 backwards run their CUDA-core stem,
# which wants many threads, and their tensor-core products in one block. The
# launchers take ``threads=`` to override an entry for one call.
THREADS = {"conv_block_fwd": 512, "conv_block_bwd": 1024,
           "conv_stack_fwd": 512, "conv_stack_bwd": 1024,
           "conv_block_fwd_tc": 512, "conv_block_bwd_tc": 1024,
           "conv_stack_fwd_tc": 512, "conv_stack_bwd_tc": 1024}
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
MAX_THREADS = 1024   # kMaxThreads of csrc/conv_block.cu
STEM_GROUPS = 24     # kStemGroups: the bf16 stem backward's partial sums
TC_SKEW = 8          # kSkew of csrc/common.cuh

# The route of every kernel is fixed by the dtype: bf16 runs conv2 and its
# gradients on mma.sync, f32 everything on the CUDA cores (TF32 would break
# the f32 contract).
ROUTES = {torch.float32: "cuda_core", torch.bfloat16: "tensor_core"}
INSTRUCTIONS = {"cuda_core": "fma", "tensor_core": "mma.sync"}

# one count per kernel, raised where it is launched; conv_stack_packed has
# no kernel of its own and shows in conv_stack_fwd / conv_stack_bwd
LAUNCHES = {"conv_block_fwd": 0, "conv_block_bwd": 0,
            "conv_stack_fwd": 0, "conv_stack_bwd": 0}
# the same launches once more, by (kernel, route)
ROUTE_LAUNCHES = {(k, r): 0 for k in LAUNCHES for r in ROUTES.values()}
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


def conv_stack_fwd_plain(x, w1, b1, w2, b2):
    """Plain residual-free forward: pooled (C, B, H/4, W/4, C2) in x's
    dtype. Weights in the compute dtype, biases f32."""
    return conv_stack_res_fwd_plain(x, w1, b1, w2, b2)[0]


def conv_stack_bwd_plain(g, x, w1, b1, w2, b2):
    """Plain residual-free backward: g (C, B, H/4, W/4, C2) is the raw
    cotangent in the compute dtype. The pool2 routing and relu2' are
    recomputed from the image and the weights; the rest is
    :func:`conv_stack_res_bwd_plain`. Returns the same f32 gradients."""
    pooled, idx = conv_stack_res_fwd_plain(x, w1, b1, w2, b2)
    g = (g * (pooled > 0)).to(x.dtype)
    return conv_stack_res_bwd_plain(g, idx, x, w1, b1, w2)


# ---------------------------------------------------------------------------
# launch plans (pure functions of the dtype and the shapes)
# ---------------------------------------------------------------------------

def _up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one launch of a kernel of the segment is cut: the kernel (its
    ``LAUNCHES`` name), the route and the multiply instruction of its conv2
    products, the threads a block, its shared memory, and the f32 sums a
    thread holds at once in those products (CUDA cores: the four window
    members of the forward, the nine taps of one dW2 element; tensor cores:
    the m16n8 tiles of a warp's unit)."""
    kernel: str
    route: str
    instruction: str
    threads: int
    smem_bytes: int
    acc_registers: int


# f32 sums a thread holds in the conv2 products, by (forward?, route)
_ACC_REGISTERS = {(True, "cuda_core"): 4, (False, "cuda_core"): 9,
                  (True, "tensor_core"): 16, (False, "tensor_core"): 8}


def smem_bytes(kernel: str, dtype, H: int, W: int, C1: int, C2: int) -> int:
    """Shared memory one block of `kernel` needs for H x W images with C1
    and C2 channels: the count ``fl_conv_block_smem_bytes`` of
    csrc/conv_block.cu makes. The two forwards take the same; K4's
    backward (``conv_stack_bwd``) adds b2 and, on the CUDA cores, its
    recompute's buffers to K2's."""
    if kernel not in LAUNCHES:
        raise ValueError(f"conv_block: no kernel {kernel!r}; the kernels are "
                         f"{sorted(LAUNCHES)}")
    fwd, rec = kernel.endswith("_fwd"), kernel == "conv_stack_bwd"
    H1, W1, Ho, Wo = H // 2, W // 2, H // 4, W // 4
    plane, n_x2, n_pool = (H1 + 2) * (W1 + 2), H1 * W1, Ho * Wo
    img = (H + 2) * (W + 2)
    if ROUTES[dtype] == "cuda_core":
        if fwd:
            return 4 * (9 * C1 + C1 + C2 + img + 9 * C1 * C2 + plane * C1)
        # f32 values, then the compute dtype's (f32 too), then bytes
        floats = 9 * C1 + C1 + img + n_x2 * C1 + rec * C2
        ts = 9 * C2 * (C1 + rec) + plane * (C1 + C2) + rec * n_pool * C2
        return 4 * (floats + ts) + n_x2 * C1 + rec * n_pool * C2
    C1P, C2P = _up(C1, 16), _up(C2, 16)
    XS, LW, DS = C1P + TC_SKEW, C2P + TC_SKEW, C2P + TC_SKEW
    if fwd:
        return _up(4 * (9 * C1 + C1 + C2 + img), 16) + 2 * (
            9 * C1P * LW + plane * XS)
    floats = (9 * C1 + C1 + img + n_x2 * C1 + rec * C2
              + min(STEM_GROUPS, n_x2) * 10 * C1 + n_x2)
    halves = 9 * C1P * LW + plane * XS + plane * DS + n_pool * C2
    return _up(4 * floats, 16) + 2 * halves + n_x2 * C1 + n_pool * C2


def launch_plan(kernel: str, dtype, H: int, W: int, C1: int, C2: int,
                threads=None) -> LaunchPlan:
    """The launch of `kernel` (a ``LAUNCHES`` name) for H x W images with
    C1 and C2 channels. A pure function: the route follows from the dtype
    alone (``ROUTES``; another dtype raises KeyError), the rest from the
    shapes; `threads` defaults to ``THREADS[kernel]`` (f32) or
    ``THREADS[kernel + "_tc"]`` (bf16). Raises where no block can hold
    it."""
    route = ROUTES[dtype]
    smem = smem_bytes(kernel, dtype, H, W, C1, C2)
    if threads is None:
        threads = THREADS[kernel + ("_tc" if route == "tensor_core" else "")]
    if threads % 32 or not 32 <= threads <= MAX_THREADS:
        raise ValueError(f"{kernel}: {threads} threads a block; it takes a "
                         f"multiple of 32 up to {MAX_THREADS}")
    if smem > SMEM_LIMIT:
        raise ValueError(f"conv_block: {H}x{W} images with C1={C1}, "
                         f"C2={C2} need {smem} B of shared memory per block "
                         f"(limit {SMEM_LIMIT})")
    return LaunchPlan(kernel, route, INSTRUCTIONS[route], threads, smem,
                      _ACC_REGISTERS[(kernel.endswith("_fwd"), route)])


# the `which` argument of fl_conv_block_smem_bytes
_SMEM_WHICH = {"conv_block_fwd": 0, "conv_stack_fwd": 0, "conv_block_bwd": 1,
               "conv_stack_bwd": 2}


def kernel_smem_bytes(kernel: str, dtype, H, W, C1, C2) -> int:
    """The kernel library's own count behind ``smem_bytes`` (needs the
    built library)."""
    return _build.load().fl_conv_block_smem_bytes(
        _SMEM_WHICH[kernel], _DTYPE_CODE[dtype], H, W, C1, C2)


# ---------------------------------------------------------------------------
# CUDA launchers (K1, K2, K4)
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


def _counted(plan: LaunchPlan) -> None:
    LAUNCHES[plan.kernel] += 1
    ROUTE_LAUNCHES[(plan.kernel, plan.route)] += 1


def _launch_fwd(name, x, w1, b1, w2, b2, threads=None):
    """K1 (``conv_block_fwd``, with the index) or K4's forward on checked
    CUDA tensors."""
    C, H, W, C1, C2 = _check_shapes(x, w1, b1, w2, b2)
    cdt = x.dtype
    _check_cuda(name, (x, w1, b1, w2, b2),
                (cdt, cdt, torch.float32, cdt, torch.float32))
    plan = launch_plan(name, cdt, H, W, C1, C2, threads)
    lib = _build.load()
    B = x.shape[1]
    shape = (C, B, H // 4, W // 4, C2)
    pooled = torch.empty(shape, dtype=cdt, device=x.device)
    with_idx = name == "conv_block_fwd"
    idx = (torch.empty(shape, dtype=torch.uint8, device=x.device)
           if with_idx else None)
    fn = lib.fl_conv_block_fwd if with_idx else lib.fl_conv_stack_fwd
    outs = (pooled, idx) if with_idx else (pooled,)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(_DTYPE_CODE[cdt], _ptr(x), _ptr(w1), _ptr(b1), _ptr(w2),
                _ptr(b2), *map(_ptr, outs), C, B, H, W, C1, C2,
                IMAGES_PER_BLOCK, plan.threads, ctypes.c_void_p(stream))
    _build.check(lib, rc, name)
    _counted(plan)
    return pooled, idx


def _launch_bwd(name, g, idx, x, w1, b1, w2, b2, threads=None):
    """K2 (given ``idx``) or K4's backward (given ``b2``): the per-block
    pass and its fixed-order reduction."""
    C, H, W, C1, C2 = _check_shapes(x, w1, b1, w2, b2)
    cdt = x.dtype
    B = x.shape[1]
    if tuple(g.shape) != (C, B, H // 4, W // 4, C2):
        raise ValueError(f"g must be {(C, B, H // 4, W // 4, C2)}, got "
                         f"{tuple(g.shape)}")
    if idx is not None:
        if idx.shape != g.shape:
            raise ValueError(f"idx must be {tuple(g.shape)}")
        ins, dtypes = (g, idx, x, w1, b1, w2), (
            cdt, torch.uint8, cdt, cdt, torch.float32, cdt)
    else:
        ins, dtypes = (g, x, w1, b1, w2, b2), (
            cdt, cdt, cdt, torch.float32, cdt, torch.float32)
    _check_cuda(name, ins, dtypes)
    plan = launch_plan(name, cdt, H, W, C1, C2, threads)
    lib = _build.load()
    P = 9 * C1 + C1 + 9 * C1 * C2 + C2
    ng = -(-B // IMAGES_PER_BLOCK)
    partial = torch.empty((C, ng, P), dtype=torch.float32, device=x.device)
    out = torch.empty((C, P), dtype=torch.float32, device=x.device)
    fn = lib.fl_conv_block_bwd if idx is not None else lib.fl_conv_stack_bwd
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(_DTYPE_CODE[cdt], *map(_ptr, ins), _ptr(partial), _ptr(out),
                C, B, H, W, C1, C2, IMAGES_PER_BLOCK, plan.threads,
                ctypes.c_void_p(stream))
    _build.check(lib, rc, name)
    _counted(plan)
    dw1, db1, dw2, db2 = torch.split(out, [9 * C1, C1, 9 * C1 * C2, C2], 1)
    return (dw1.reshape(C, 3, 3, 1, C1), db1.contiguous(),
            dw2.reshape(C, 3, 3, C1, C2), db2.contiguous())


def conv_block_fwd_cuda(x, w1, b1, w2, b2, threads=None):
    """Launch K1. x, w1, w2 in the compute dtype; b1, b2 f32. Returns
    (pooled, idx). ``threads`` overrides the block size of ``THREADS``."""
    return _launch_fwd("conv_block_fwd", x, w1, b1, w2, b2, threads)


def conv_block_bwd_cuda(g, idx, x, w1, b1, w2, threads=None):
    """Launch K2. g in the compute dtype, already multiplied by
    (pooled > 0)."""
    return _launch_bwd("conv_block_bwd", g, idx, x, w1, b1, w2, None,
                       threads)


def conv_stack_fwd_cuda(x, w1, b1, w2, b2, threads=None):
    """Launch K4's forward: K1 without the index output. Returns pooled."""
    return _launch_fwd("conv_stack_fwd", x, w1, b1, w2, b2, threads)[0]


def conv_stack_bwd_cuda(g, x, w1, b1, w2, b2, threads=None):
    """Launch K4's backward on the raw cotangent g in the compute dtype,
    the image and the weights: no index, no pooled output."""
    return _launch_bwd("conv_stack_bwd", g, None, x, w1, b1, w2, b2, threads)


# ---------------------------------------------------------------------------
# the public ops
# ---------------------------------------------------------------------------

def _entry_casts(x, w1, b1, w2, b2):
    """Weights to the compute dtype; biases rounded to it and kept f32."""
    cdt = x.dtype
    return (x.contiguous(), w1.to(cdt).contiguous(),
            b1.to(cdt).float().contiguous(), w2.to(cdt).contiguous(),
            b2.to(cdt).float().contiguous())


def _weight_grads(grads, dtypes):
    return (None,) + tuple(t.to(dt) for t, dt in zip(grads, dtypes))


class _ConvStackRes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        x, w1c, b1f, w2c, b2f = _entry_casts(x, w1, b1, w2, b2)
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
        return _weight_grads(grads, ctx.dtypes)


class _ConvStack(torch.autograd.Function):
    """Residual-free: the forward saves the image and the weights only."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        x, w1c, b1f, w2c, b2f = _entry_casts(x, w1, b1, w2, b2)
        if x.is_cuda:
            pooled = conv_stack_fwd_cuda(x, w1c, b1f, w2c, b2f)
        else:
            pooled = conv_stack_fwd_plain(x, w1c, b1f, w2c, b2f)
        ctx.save_for_backward(x, w1c, b1f, w2c, b2f)
        ctx.dtypes = (w1.dtype, b1.dtype, w2.dtype, b2.dtype)
        return pooled

    @staticmethod
    def backward(ctx, g):
        x, w1c, b1f, w2c, b2f = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        if x.is_cuda:
            grads = conv_stack_bwd_cuda(g, x, w1c, b1f, w2c, b2f)
        else:
            grads = conv_stack_bwd_plain(g, x, w1c, b1f, w2c, b2f)
        return _weight_grads(grads, ctx.dtypes)


def conv_stack_res(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The fused conv segment over stacked clients, keeping the pool2
    index for the backward (see the module docstring). Differentiable in
    the weights; the image gets no gradient."""
    _check_shapes(x, w1, b1, w2, b2)
    return _ConvStackRes.apply(x, w1, b1, w2, b2)


def conv_stack(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The fused conv segment over stacked clients, residual-free (see the
    module docstring). Differentiable in the weights; the image gets no
    gradient."""
    _check_shapes(x, w1, b1, w2, b2)
    return _ConvStack.apply(x, w1, b1, w2, b2)


def conv_stack_packed(x_imgs: torch.Tensor, w1: torch.Tensor,
                      b1: torch.Tensor, w2: torch.Tensor,
                      b2: torch.Tensor) -> torch.Tensor:
    """``conv_stack`` for P clients at once, with the reference's
    signature: x_imgs (P, B, 2H, 2W, 1), w1 (P, 3, 3, 1, C1), b1 (P, C1),
    w2 (P, 3, 3, C1, C2), b2 (P, C2) -> (P, B, H/2, W/2, C2). Equal to
    ``conv_stack`` client by client bit for bit, values and gradients: the
    same kernels run with P as the client dimension of the grid, and their
    launches count as ``conv_stack_fwd`` / ``conv_stack_bwd``."""
    if x_imgs.dim() != 5 or w1.dim() != 5 or w1.shape[0] != x_imgs.shape[0]:
        raise ValueError(
            "conv_stack_packed takes x_imgs (P, B, 2H, 2W, 1) and weights "
            f"with the same leading P, got x_imgs {tuple(x_imgs.shape)} and "
            f"w1 {tuple(w1.shape)}")
    return conv_stack(x_imgs, w1, b1, w2, b2)


def conv_stack_res_plain(x, w1, b1, w2, b2) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The plain PyTorch forward on any device, with the same entry casts
    as :func:`conv_stack_res`: (pooled, idx)."""
    return conv_stack_res_fwd_plain(*_entry_casts(x, w1, b1, w2, b2))
