"""3x3 SAME conv as an implicit GEMM over stacked clients, and the
space-to-depth stem built on it.

``conv3x3_patch(x, w)`` is the counterpart of
``fl_tpu.ops.conv_pallas.conv3x3_pallas`` under a client vmap, and
``conv_stem_s2d(x, w, b)`` of ``conv_stem_s2d`` there. The convolution is
ONE product with K = 9*I per direction on a patch matrix whose row r holds
the nine shifted pixels of output position r side by side (tap outer,
channel inner) and which never exists in device memory:

    forward   y  = patches(x) @ w2              w2 = w.reshape(9*I, O)
    wgrad     dW = patches(x).T @ dy            (9*I, O), f32
    dgrad     dx = patches(dy) @ wd             wd[(dh, dw, o), i]
                                                = w[2 - dh, 2 - dw, i, o]

Numerics (the TPU kernel's contract): w and the cotangent are cast to x's
dtype on entry; every product sums in f32 over all of K and is rounded
once, to x's dtype (y, dx); dW stays f32 until it is cast to w's dtype.
The weight gradient and the input gradient are two launches, and the input
gradient runs only when x needs one: the stem's never does.

Shapes: x (C, B, H, W, I), w (C, 3, 3, I, O) -> (C, B, H, W, O), any H, W,
I, O, float32 or bfloat16; a 4-D x with a 4-D w is the single-client case.

On a CUDA tensor the products are kernel K7 (``csrc/conv_patch.cu``), on a
route that the dtype alone fixes (``ROUTES``; ``ROUTE_LAUNCHES`` counts the
launches of each):

- bfloat16 goes to the tensor cores, f32 sums in registers:
  ``patch_gemm_wgmma_kernel`` for y and dx (``wgmma`` m64nNk16, the weights
  read by the tensor cores straight from shared memory),
  ``patch_wgrad_mma_kernel`` for dW (``mma.sync`` m16n8k16). By the card's
  numbers each direction is bound by bytes at the bench shapes, so the
  kernels read x, dy and w once in 16-byte pieces, stage a tile's pixels
  once with their halo instead of a nine-fold patch tile, find each tap's
  pixel through the per-lane row addresses of ``ldmatrix``, and keep every
  sum in registers until its one rounding.
- float32 stays on the CUDA cores (``patch_gemm_kernel``,
  ``patch_wgrad_kernel``): TF32 would break the f32 contract.

A CUDA tensor launches its kernel or the launcher raises; nothing falls back.
``launch_plan`` is the launch geometry of either route as a pure function of
the dtype and the shapes. On a CPU tensor the plain PyTorch versions below
run, which write the patch matrix out and are the oracles the kernels are
held to.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from fl_tpu_torch.ops import _build
from fl_tpu_torch.ops.conv import check_conv_shapes, with_client_axis
from fl_tpu_torch.ops.conv_block import (SMEM_LIMIT, _DTYPE_CODE, _check_cuda,
                                         _ptr)

MAX_THREADS = 512   # kMaxThreads of csrc/conv_patch.cu

# *_BLOCKS: thread blocks a launch aims for over all clients. A block of the
# patch GEMM walks several row tiles with one load of its client's weights,
# and a block of the weight gradient sums its tiles in registers into one
# slot.

# float32, the CUDA cores: a 4x4 register tile a thread
GEMM_BLOCKS = 4096
WGRAD_BLOCKS = 2048
GEMM_THREADS = 256
WGRAD_TASKS = 3     # kWgradTasks there: 4x4 blocks of dW a thread may own
ROW_TILES = (64, 32, 16, 8, 4)

# bfloat16, the tensor cores. The patch GEMM runs on wgmma: a warpgroup (four
# warps) owns 128 rows as two 64-row products, 64 columns a pass (8, 16 or 32
# where O stays under them); the weight gradient on mma.sync: a warp owns two
# (tap, 16 channels, 64 outputs) blocks of dW. 64 f32 sums a thread in both.
TC_WARP_ROWS = 32         # kTcRows
TC_COLS = 64              # kTcCols
TC_SKEW = 8               # kSkew of csrc/common.cuh
TC_WGRAD_ITEMS = 2        # kWgradItems
TC_ACC_REGISTERS = 64
TC_GEMM_WARPS = (8, 4)    # whole warpgroups
TC_GEMM_BLOCKS = 512      # few blocks: each loads its client's weights once
TC_WGRAD_ROWS = (256, 128, 64, 32, 16)
TC_WGRAD_MAX_WARPS = 9    # kWgradMaxThreads / 32: two thread blocks an SM
TC_WGRAD_BLOCKS = 512

ROUTES = {torch.float32: "cuda_core", torch.bfloat16: "tensor_core"}
# the multiply instruction of each route's kernels
INSTRUCTIONS = {("cuda_core", "gemm"): "fma", ("cuda_core", "wgrad"): "fma",
                ("tensor_core", "gemm"): "wgmma",
                ("tensor_core", "wgrad"): "mma.sync"}

# one count per kernel, raised where it is launched; the input gradient is
# a launch of the patch GEMM
LAUNCHES = {"conv3x3_patch_gemm": 0, "conv3x3_patch_wgrad": 0}
# the same launches by the route they took
ROUTE_LAUNCHES = dict.fromkeys(ROUTES.values(), 0)

_SMEM_WHICH = {"gemm": 0, "wgrad": 1}


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def patches(x: torch.Tensor) -> torch.Tensor:
    """The patch matrix written out: x (C, B, H, W, I) -> (C, B*H*W, 9*I)
    in f32, nine zero-padded shifted views side by side, tap (dh, dw)
    outer and channel inner."""
    C, B, H, W, I = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    views = [xp[:, :, dh:dh + H, dw:dw + W, :] for dh in range(3)
             for dw in range(3)]
    return torch.cat(views, dim=-1).reshape(C, B * H * W, 9 * I)


def conv3x3_patch_plain(x: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Plain forward: x (C, B, H, W, I) and w2 (C, 9*I, O), both in the
    compute dtype -> (C, B, H, W, O) in it; one f32 product, one rounding."""
    C, B, H, W, _ = x.shape
    y = torch.bmm(patches(x), w2.float())
    return y.reshape(C, B, H, W, -1).to(x.dtype)


def conv3x3_patch_wgrad_plain(x: torch.Tensor,
                              g: torch.Tensor) -> torch.Tensor:
    """Plain weight gradient: x (C, B, H, W, I), g (C, B, H, W, O) in the
    compute dtype -> (C, 9*I, O) f32."""
    C, O = g.shape[0], g.shape[-1]
    return torch.bmm(patches(x).transpose(1, 2), g.float().reshape(C, -1, O))


def dgrad_weights(w: torch.Tensor) -> torch.Tensor:
    """The input gradient's weights: w (C, 3, 3, I, O) -> (C, 9*O, I) with
    the taps mirrored and each tap transposed."""
    C, _, _, I, O = w.shape
    return w.flip(1, 2).transpose(3, 4).reshape(C, 9 * O, I).contiguous()


def conv3x3_patch_dgrad_plain(g: torch.Tensor,
                              w: torch.Tensor) -> torch.Tensor:
    """Plain input gradient: g (C, B, H, W, O), w (C, 3, 3, I, O) in the
    compute dtype -> (C, B, H, W, I) in it."""
    return conv3x3_patch_plain(g, dgrad_weights(w))


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one K7 launch is cut: the route and its multiply instruction;
    `rows` output rows (pixels, for the weight
    gradient) a tile; K and N as the kernel pads them in shared memory;
    `blocks` thread blocks a client along the rows (the weight gradient's
    `slots`), each walking `tiles_per_block` tiles, times `chunks` blocks
    that split dW; `stages` tile buffers; the f32 sums a thread holds."""
    kernel: str
    route: str
    instruction: str
    rows: int
    k_pad: int
    n_pad: int
    threads: int
    blocks: int
    tiles_per_block: int
    slots: int
    chunks: int
    stages: int
    smem_bytes: int
    acc_registers: int


def smem_bytes(kernel: str, dtype, W: int, I: int, O: int, rows: int,
               threads: int, stages: int) -> int:
    """Shared memory one block of `kernel` ("gemm" or "wgrad") needs: the
    count ``fl_conv_patch_smem_bytes`` of csrc/conv_patch.cu makes."""
    if ROUTES[dtype] == "cuda_core":
        IP, OP = _up(I, 4), _up(O, 4)
        patch = rows * (9 * IP + 4)
        return 4 * (patch + (9 * IP * OP if kernel == "gemm" else rows * OP))
    IP, XS = _up(I, 16), _up(I, 16) + TC_SKEW
    tile = (rows + 2 * W + 2) * XS          # the rows' pixels and their halo
    if kernel == "gemm":
        cols = gemm_pass_columns(O)
        return 2 * (9 * IP * _up(O, cols) + XS + stages * tile
                    + threads // 32 * 16 * (cols + TC_SKEW))
    return (2 * (XS + stages * (tile + rows * (_up(O, 16) + TC_SKEW)))
            + 2 * stages * rows)


def gemm_pass_columns(O: int) -> int:
    """Columns one pass of the wgmma patch GEMM covers: 64 where O reaches
    beyond 32, else the next of 8, 16, 32; the weights are padded to whole
    passes in shared memory."""
    return next((n for n in (8, 16, 32) if O <= n), TC_COLS)


def _first_fit(kernel, dtype, W, I, O, candidates):
    """The first (rows, threads, stages) that leaves room for two blocks on
    an SM, else the first that fits one block at all."""
    need = [smem_bytes(kernel, dtype, W, I, O, *cand) for cand in candidates]
    for limit in (SMEM_LIMIT // 2, SMEM_LIMIT):
        for cand, n in zip(candidates, need):
            if n <= limit:
                return cand, n
    raise ValueError(
        f"conv3x3_patch: W={W}, I={I}, O={O} in {dtype} need {min(need)} B of "
        f"shared memory per block in the smallest tile (limit {SMEM_LIMIT})")


def launch_plan(kernel: str, dtype, C: int, B: int, H: int, W: int, I: int,
                O: int) -> LaunchPlan:
    """The launch of `kernel` ("gemm": y or dx = patches @ w2 with w2
    (9*I, O); "wgrad": dW (9*I, O)) for C clients' (B, H, W, I) images. A
    pure function: the route follows from the dtype alone, the rest from
    the shapes."""
    route = ROUTES[dtype]
    R = B * H * W
    if route == "cuda_core":
        (rows, _, stages), smem = _first_fit(
            kernel, dtype, W, I, O, [(M, 0, 1) for M in ROW_TILES])
        k_pad, n_pad = 9 * _up(I, 4), _up(O, 4)
        n_tiles = -(-R // rows)
        if kernel == "gemm":
            threads = min(GEMM_THREADS, _up(rows // 4 * (n_pad // 4), 32))
            chunks, acc = 1, 16
        else:
            # 4x4 blocks of dW; a thread block holds WGRAD_TASKS a thread
            tasks = k_pad // 4 * (n_pad // 4)
            threads = next((_up(-(-tasks // k), 32)
                            for k in range(1, WGRAD_TASKS + 1)
                            if -(-tasks // k) <= MAX_THREADS), MAX_THREADS)
            chunks, acc = -(-tasks // (threads * WGRAD_TASKS)), 16 * WGRAD_TASKS
        gemm_blocks, wgrad_blocks = GEMM_BLOCKS, WGRAD_BLOCKS
    else:
        k_pad, n_pad, acc = 9 * _up(I, 16), _up(O, 8), TC_ACC_REGISTERS
        if kernel == "gemm":
            n_pad = _up(O, gemm_pass_columns(O))
            # no more warpgroups than twice what the rows fill
            warps = [w for w in TC_GEMM_WARPS
                     if w == TC_GEMM_WARPS[-1] or w // 2 * TC_WARP_ROWS < R]
            cands = [(w * TC_WARP_ROWS, w * 32, s)
                     for w in warps for s in (2, 1)]
            chunks = 1
        else:
            items = -(-n_pad // TC_COLS) * (k_pad // 16)
            warps = min(TC_WGRAD_MAX_WARPS, -(-items // TC_WGRAD_ITEMS))
            chunks = -(-items // (warps * TC_WGRAD_ITEMS))
            cands = [(M, warps * 32, s) for M in TC_WGRAD_ROWS
                     if M == TC_WGRAD_ROWS[-1] or M // 2 < R for s in (2, 1)]
        (rows, threads, stages), smem = _first_fit(kernel, dtype, W, I, O,
                                                   cands)
        n_tiles = -(-R // rows)
        gemm_blocks, wgrad_blocks = TC_GEMM_BLOCKS, TC_WGRAD_BLOCKS
    if kernel == "gemm":
        tiles_per_block = -(-n_tiles // max(1, min(n_tiles,
                                                   -(-gemm_blocks // C))))
        blocks, slots = -(-n_tiles // tiles_per_block), 1
    else:
        slots = max(1, min(n_tiles, -(-wgrad_blocks // (C * chunks))))
        blocks, tiles_per_block = slots, -(-n_tiles // slots)
    return LaunchPlan(kernel, route, INSTRUCTIONS[route, kernel], rows, k_pad,
                      n_pad, threads, blocks, tiles_per_block, slots, chunks,
                      stages, smem, acc)


# ---------------------------------------------------------------------------
# CUDA launchers (K7)
# ---------------------------------------------------------------------------

def _check_patch_inputs(name, x, other, other_shape, what):
    if x.dim() != 5 or tuple(other.shape) != other_shape:
        raise ValueError(f"{name}: x (C, B, H, W, I) needs {what} "
                         f"{other_shape}, got {tuple(x.shape)} and "
                         f"{tuple(other.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: compute dtype must be float32 or "
                         f"bfloat16, got {x.dtype}")
    _check_cuda(name, (x, other), (x.dtype, x.dtype))


def _launched(lib, rc, name, plan):
    _build.check(lib, rc, name)
    LAUNCHES[name] += 1
    ROUTE_LAUNCHES[plan.route] += 1


def patch_gemm_cuda(x, w2):
    """Launch the patch GEMM of x's dtype: x (C, B, H, W, I) and w2
    (C, 9*I, O) in the compute dtype -> (C, B, H, W, O) in it."""
    name = "conv3x3_patch_gemm"
    C, B, H, W, I = x.shape
    O = w2.shape[-1]
    _check_patch_inputs(name, x, w2, (C, 9 * I, O), "w2")
    plan = launch_plan("gemm", x.dtype, C, B, H, W, I, O)
    lib = _build.load()
    y = torch.empty((C, B, H, W, O), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fl_patch_gemm(
            _DTYPE_CODE[x.dtype], _ptr(x), _ptr(w2), _ptr(y), C, B, H, W, I,
            O, plan.rows, plan.tiles_per_block, plan.threads, plan.stages,
            ctypes.c_void_p(stream))
    _launched(lib, rc, name, plan)
    return y


def patch_wgrad_cuda(x, g):
    """Launch the weight gradient of x's dtype and, where a client has more
    than one slot, the fixed-order reduction of its slots: x (C, B, H, W,
    I), g (C, B, H, W, O) in the compute dtype -> (C, 9*I, O) f32."""
    name = "conv3x3_patch_wgrad"
    C, B, H, W, I = x.shape
    O = g.shape[-1]
    _check_patch_inputs(name, x, g, (C, B, H, W, O), "g")
    plan = launch_plan("wgrad", x.dtype, C, B, H, W, I, O)
    lib = _build.load()
    out = torch.empty((C, 9 * I, O), dtype=torch.float32, device=x.device)
    # the tensor-core kernel writes a single slot straight to dW
    partial = out if plan.route == "tensor_core" and plan.slots == 1 else (
        torch.empty((C, plan.slots, 9 * I * O), dtype=torch.float32,
                    device=x.device))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fl_patch_wgrad(
            _DTYPE_CODE[x.dtype], _ptr(x), _ptr(g), _ptr(partial), _ptr(out),
            C, B, H, W, I, O, plan.rows, plan.slots, plan.threads,
            plan.stages, ctypes.c_void_p(stream))
    _launched(lib, rc, name, plan)
    return out


def kernel_smem_bytes(plan: LaunchPlan, dtype, W: int, I: int, O: int) -> int:
    """The kernel library's own count of the shared memory `plan` needs, to
    hold ``smem_bytes`` to (needs the built library)."""
    return _build.load().fl_conv_patch_smem_bytes(
        _SMEM_WHICH[plan.kernel], _DTYPE_CODE[dtype], W, I, O, plan.rows,
        plan.threads, plan.stages)


# ---------------------------------------------------------------------------
# the public ops
# ---------------------------------------------------------------------------

class _Conv3x3Patch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        C, _, _, _, I = x.shape
        x, wc = x.contiguous(), w.to(x.dtype).contiguous()
        gemm = patch_gemm_cuda if x.is_cuda else conv3x3_patch_plain
        ctx.save_for_backward(x, wc)
        ctx.w_dtype = w.dtype
        return gemm(x, wc.reshape(C, 9 * I, -1))

    @staticmethod
    def backward(ctx, g):
        x, wc = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[1]:
            wgrad = (patch_wgrad_cuda if x.is_cuda
                     else conv3x3_patch_wgrad_plain)
            dw = wgrad(x, g).reshape(wc.shape).to(ctx.w_dtype)
        if ctx.needs_input_grad[0]:
            gemm = patch_gemm_cuda if x.is_cuda else conv3x3_patch_plain
            dx = gemm(g, dgrad_weights(wc))
        return dx, dw


def _conv3x3_patch(x, w):
    check_conv_shapes(x, w)
    return _Conv3x3Patch.apply(x, w)


def conv3x3_patch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv over stacked clients as one K = 9*I product
    per direction: x (C, B, H, W, I), w (C, 3, 3, I, O) -> (C, B, H, W, O)
    in x's dtype. Differentiable in x and w; the input gradient is computed
    only when x requires one."""
    return with_client_axis(_conv3x3_patch, x, w)


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """(..., 2H, 2W, 1) -> (..., H, W, 4); channel = row parity * 2 +
    column parity."""
    *lead, H2, W2, _ = x.shape
    n = len(lead)
    x = x.reshape(*lead, H2 // 2, 2, W2 // 2, 2)
    return x.permute(*range(n), n, n + 2, n + 1, n + 3).reshape(
        *lead, H2 // 2, W2 // 2, 4)


def _lift_index():
    """For each (th, tw, ch*2 + cw, a*2 + b) of the lifted kernel the tap
    dh*3 + dw of the 3x3 kernel it copies, or 9 (a zero) where
    dh = 2*th + ch - a - 1 or dw = 2*tw + cw - b - 1 leaves 0..2."""
    idx = [[[[9] * 4 for _ in range(4)] for _ in range(3)] for _ in range(3)]
    for th in range(3):
        for tw in range(3):
            for ch in range(2):
                for cw in range(2):
                    for a in range(2):
                        for b in range(2):
                            dh = 2 * th + ch - a - 1
                            dw = 2 * tw + cw - b - 1
                            if 0 <= dh <= 2 and 0 <= dw <= 2:
                                idx[th][tw][ch * 2 + cw][a * 2 + b] = (
                                    dh * 3 + dw)
    return idx


@functools.lru_cache(maxsize=None)
def _lift_index_on(device) -> torch.Tensor:
    return torch.tensor(_lift_index(), dtype=torch.long, device=device)


def s2d_stem_weights(w: torch.Tensor) -> torch.Tensor:
    """Lift w (..., 3, 3, 1, O) to the space-to-depth kernel
    (..., 3, 3, 4, 4*O): output channel (a*2 + b)*O + o of the lifted conv
    is the original conv's channel o at pixel parity (a, b),

        w2[th, tw, ch*2 + cw, (a*2 + b)*O + o]
            = w[2*th + ch - a - 1, 2*tw + cw - b - 1, 0, o]

    and zero where that index leaves the 3x3 kernel. A gather, so exact and
    differentiable."""
    *lead, _, _, _, O = w.shape
    taps = torch.cat([w.reshape(*lead, 9, O),
                      torch.zeros((*lead, 1, O), dtype=w.dtype,
                                  device=w.device)], dim=-2)
    lifted = taps[..., _lift_index_on(w.device), :]    # (..., 3, 3, 4, 4, O)
    return lifted.reshape(*lead, 3, 3, 4, 4 * O)


def _conv_stem_s2d(x, w, b):
    C, O = w.shape[0], w.shape[-1]
    y = conv3x3_patch(space_to_depth2(x), s2d_stem_weights(w))
    y = y + b.repeat(1, 4)[:, None, None, None, :]
    _, B, H, W, _ = y.shape
    # the 2x2 pool is the max over the four parity groups; amax shares a
    # tied maximum's gradient evenly, as the reference's max over an axis
    return torch.relu(y.reshape(C, B, H, W, 4, O).amax(dim=4))


def conv_stem_s2d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """maxpool2x2(relu(conv3x3_same(x, w) + b)) for one-channel images of
    even sides, as a 3x3 conv with I = 4, O = 4*O on the space-to-depth
    image: x (C, B, 2H, 2W, 1), w (C, 3, 3, 1, O), b (C, O) ->
    (C, B, H, W, O); 4-D x with 4-D w and 1-D b is the single-client case.
    Differentiable in w and b (and x)."""
    if x.shape[-1] != 1 or x.shape[-2] % 2 or x.shape[-3] % 2:
        raise ValueError("conv_stem_s2d takes one-channel images of even "
                         f"sides, got {tuple(x.shape)}")
    return with_client_axis(_conv_stem_s2d, x, w, b)
