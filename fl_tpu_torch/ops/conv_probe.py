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

K8a takes one of three routes (``ROUTES``), which ``launch_plan`` fixes from
the dtype and the shape alone, and ``ROUTE_LAUNCHES`` counts:

- ``tma``: bfloat16 where a row of K and of N is whole 16-byte pieces
  (K and N multiples of 8). A persistent block an SM; one producer warp
  streams A by TMA through a ring of shared-memory stages, two consumer
  warpgroups multiply on ``wgmma`` against the client's B held in shared
  memory, the rounded tile leaves by a TMA store. Bound by bytes at the
  bench shape: A is read once, by a warp that does nothing else.
- ``staged``: the other bfloat16 shapes, the same ``wgmma`` products on rows
  staged by ``cp.async``, stores masked to the ragged edges.
- ``cuda_core``: float32, a 4x4 register tile a thread; TF32 would break the
  f32 contract.

K8b takes one of two routes (``TAPLOOP_ROUTES``), which
``taploop_launch_plan`` fixes from the dtype and the shape alone, and
``TAPLOOP_ROUTE_LAUNCHES`` counts:

- ``tma``: bfloat16 where a pixel's channels and outputs are whole 16-byte
  pieces (I and O multiples of 8), the halo'd image is at most 256 pixels
  a side and a ring of the images two tiles read fits in shared memory. A
  persistent block an SM; one producer warp streams whole images with
  their one-pixel halo by TMA (the zeros come from TMA's out-of-bounds
  fill, no padded copy of x exists), two consumer warpgroups take 128-row
  tiles in turn, gather each tap's rows by ``ldmatrix`` from the staged
  images and multiply on ``wgmma`` against the client's nine taps in
  shared memory; the rounded tile leaves by a TMA store while the other
  warpgroup's products run.
- ``cuda_core``: float32 (TF32 would break the f32 contract) and the bf16
  shapes TMA cannot take (I = 3, 4 or 20, say): a block stages a band of an
  image and its weights, a 4x4 register tile a thread.

Nothing falls back: a CUDA tensor launches its route's kernel or the
launcher raises (an operand that the TMA route cannot address raises).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from fl_tpu_torch.ops import _build
from fl_tpu_torch.ops.conv import check_conv_shapes
from fl_tpu_torch.ops.conv_block import (IMAGES_PER_BLOCK, SMEM_LIMIT,
                                         _DTYPE_CODE, _check_cuda, _ptr)

MAX_THREADS = 512   # kMaxThreads of csrc/conv_probe.cu

# K8a's launch geometry (the constants of csrc/conv_probe.cu)
SMS = 132            # SMs of an H100 SXM: one persistent block each
TMA_ROWS = 128       # kTmaRows: two consumer warpgroups of 64 rows
TMA_THREADS = 384    # kTmaThreads: the producer's warpgroup and two consumers
K_BOX = 64           # kKBox: K columns of one TMA box (128 bytes, the swizzle)
STAGE_BYTES = TMA_ROWS * K_BOX * 2
MAX_STAGES = 8       # 128 KB of A in flight an SM: far beyond what hides latency
STAGED_ROWS = (128, 64)
SKEW = 8             # kSkew of csrc/common.cuh
F32_TILE, F32_K_CHUNK, F32_THREADS = 64, 32, 256

ROUTES = ("tma", "staged", "cuda_core")
INSTRUCTIONS = {"tma": "wgmma", "staged": "wgmma", "cuda_core": "fma"}
_ROUTE_CODE = {"cuda_core": 0, "tma": 1, "staged": 2}
TAPLOOP_ROUTES = ("tma", "cuda_core")
MAX_BOX_SIDE = 256   # TMA's largest box dimension

# one count per kernel, raised where it is launched
LAUNCHES = {"probe_batched_gemm": 0, "probe_taploop_conv": 0}
# K8a's and K8b's launches once more, by the route they took
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
TAPLOOP_ROUTE_LAUNCHES = dict.fromkeys(TAPLOOP_ROUTES, 0)


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


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


# ---------------------------------------------------------------------------
# K8a's launch plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """How one K8a launch is cut: the route and its multiply instruction;
    `rows` output rows a tile; K padded in shared memory to `k_pad`; N cut
    into `passes` column passes of `n_pass`; `stages` A buffers; `blocks`
    thread blocks of `threads`, each walking `items_per_block` (client,
    pass, tile) items (the float32 kernel: one tile a block); the f32 sums
    a consumer thread holds."""
    route: str
    instruction: str
    rows: int
    k_pad: int
    n_pass: int
    passes: int
    stages: int
    threads: int
    blocks: int
    items_per_block: int
    smem_bytes: int
    acc_registers: int


def gemm_pass_columns(N: int) -> int:
    """Columns a column pass of the tensor-core routes covers: 64 where N
    reaches beyond 32, else the next of 8, 16, 32."""
    return next((n for n in (8, 16, 32) if N <= n), 64)


def tma_takes(K: int, N: int) -> bool:
    """TMA needs the row strides of A and of the output, K * 2 and N * 2
    bytes, to be multiples of 16."""
    return (2 * K) % 16 == 0 and (2 * N) % 16 == 0


def gemm_smem_bytes(route: str, K: int, N: int, rows: int,
                    stages: int) -> int:
    """Shared memory one block of `route` needs: the count
    ``fl_batched_gemm_smem_bytes`` of csrc/conv_probe.cu makes."""
    if route == "cuda_core":
        return 4 * (F32_TILE * (F32_K_CHUNK + 4) + F32_K_CHUNK * F32_TILE)
    NP, KP = gemm_pass_columns(N), _up(K, 16)
    if route == "tma":
        # alignment slack, the stages, two output tiles, B, the barriers
        return (1024 + stages * STAGE_BYTES + 2 * 64 * NP * 2 + KP * NP * 2
                + 2 * 8 * stages)
    return 2 * (KP * NP + rows * (KP + SKEW) + rows * (NP + SKEW))


def launch_plan(dtype, C: int, M: int, K: int, N: int) -> GemmPlan:
    """The launch of K8a for (C, M, K) @ (C, K, N). A pure function: the
    route follows from the dtype and the shape alone (float32: the CUDA
    cores; bfloat16: TMA where ``tma_takes``, else staged; other dtypes
    raise), and so does the rest."""
    if dtype == torch.float32:
        tiles = -(-M // F32_TILE) * -(-N // F32_TILE)
        return GemmPlan("cuda_core", "fma", F32_TILE, _up(K, F32_K_CHUNK),
                        F32_TILE, -(-N // F32_TILE), 1, F32_THREADS,
                        C * tiles, 1, gemm_smem_bytes("cuda_core", K, N, 0, 1),
                        16)
    if dtype != torch.bfloat16:
        raise ValueError(f"batched_gemm: compute dtype must be float32 or "
                         f"bfloat16, got {dtype}")
    NP = gemm_pass_columns(N)
    if tma_takes(K, N):
        route, rows, threads = "tma", TMA_ROWS, TMA_THREADS
        fixed = gemm_smem_bytes(route, K, N, rows, 0)
        stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // (STAGE_BYTES + 16))
        smem = gemm_smem_bytes(route, K, N, rows, stages)
        if stages < 2:
            raise ValueError(
                f"batched_gemm: K={K}, N={N} need {gemm_smem_bytes(route, K, N, rows, 2)} "
                f"B of shared memory per block for two stages (limit "
                f"{SMEM_LIMIT})")
    else:
        route, stages = "staged", 1
        need = {r: gemm_smem_bytes(route, K, N, r, 1) for r in STAGED_ROWS}
        rows = next((r for r in STAGED_ROWS if need[r] <= SMEM_LIMIT), None)
        if rows is None:
            raise ValueError(
                f"batched_gemm: K={K}, N={N} need {min(need.values())} B of "
                f"shared memory per block (limit {SMEM_LIMIT})")
        threads, smem = 2 * rows, need[rows]
    passes = -(-N // NP)
    items = C * passes * -(-M // rows)
    per_block = -(-items // min(items, SMS))
    return GemmPlan(route, INSTRUCTIONS[route], rows, _up(K, 16), NP, passes,
                    stages, threads, -(-items // per_block), per_block, smem,
                    NP // 2)


def kernel_smem_bytes(plan: GemmPlan, K: int, N: int) -> int:
    """The kernel library's own count of the shared memory `plan` needs, to
    hold ``gemm_smem_bytes`` to (needs the built library)."""
    return _build.load().fl_batched_gemm_smem_bytes(
        _ROUTE_CODE[plan.route], K, N, plan.rows, plan.stages)


def batched_gemm_cuda(a, b):
    """Launch K8a on the route of ``launch_plan``."""
    name = "probe_batched_gemm"
    _check_gemm_shapes(a, b)
    _check_dtype(name, a)
    _check_cuda(name, (a, b), (a.dtype, a.dtype))
    C, M, K = a.shape
    N = b.shape[2]
    plan = launch_plan(a.dtype, C, M, K, N)
    if plan.route == "cuda_core" and (-(-M // F32_TILE) > 65535
                                      or C > 65535):
        raise ValueError(f"{name}: M={M} or C={C} is beyond the launch grid")
    if plan.route == "tma" and (a.data_ptr() % 16 or b.data_ptr() % 16):
        raise ValueError(f"{name}: the TMA route needs 16-byte aligned "
                         "operands")
    lib = _build.load()
    out = torch.empty((C, M, N), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.fl_batched_gemm(
            _DTYPE_CODE[a.dtype], _ROUTE_CODE[plan.route], _ptr(a), _ptr(b),
            _ptr(out), C, M, K, N, plan.rows, plan.stages, plan.blocks,
            plan.items_per_block, ctypes.c_void_p(stream))
    _build.check(lib, rc, name)
    LAUNCHES[name] += 1
    ROUTE_LAUNCHES[plan.route] += 1
    return out


# ---------------------------------------------------------------------------
# K8b's launch plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TaploopPlan:
    """How one K8b launch is cut. ``tma``: I padded to `k_pad` channels in
    boxes of `k_chunk` (a staged pixel row of 2 * k_chunk bytes, the span of
    its swizzle), O cut into `passes` column passes of `n_pass`, `tiles`
    tiles of `rows` output rows a client, a ring of `stages` halo'd images,
    `blocks` persistent blocks of `threads`, each walking `items_per_block`
    (client, pass, tile) items. ``cuda_core``: bands of `band` image rows
    (`rows` output rows), `tiles` groups of `items_per_block` images a
    client, one block each."""
    route: str
    instruction: str
    k_chunk: int
    k_pad: int
    n_pass: int
    passes: int
    rows: int
    tiles: int
    stages: int
    band: int
    threads: int
    blocks: int
    items_per_block: int
    smem_bytes: int


def taploop_chunk(I: int) -> int:
    """Channels of one TMA box of the ``tma`` route: 16, 32 or 64."""
    return 16 if I <= 16 else 32 if I <= 32 else 64


def taploop_span(B: int, H: int, W: int) -> int:
    """Images two tiles, 256 consecutive output rows, can touch: what the
    two consumer warpgroups of the ``tma`` route hold at once."""
    return min(B, (2 * TMA_ROWS - 2) // (H * W) + 2)


def swizzle_span(off: int, span: int) -> int:
    """Host twin of ``swizzle_span`` in csrc/common.cuh: where TMA puts
    byte `off` (from a 1024-aligned base) of rows of `span` bytes under
    CU_TENSOR_MAP_SWIZZLE_<span>B."""
    return off ^ (((off >> 7) & (span // 16 - 1)) << 4)


def taploop_smem_bytes(route: str, dtype, H: int, W: int, I: int, O: int,
                       band: int, stages: int) -> int:
    """Shared memory one block of `route` needs: the count
    ``fl_taploop_smem_bytes`` of csrc/conv_probe.cu makes."""
    if route == "cuda_core":
        size = 4 if dtype == torch.float32 else 2
        IP, OP = _up(I, 4), _up(O, 4)
        return (9 * IP * OP + (band + 2) * (W + 2) * IP) * size
    KC = taploop_chunk(I)
    KP, NP = _up(I, KC), gemm_pass_columns(O)
    box = _up((H + 2) * (W + 2) * KC * 2, 1024)
    # alignment slack, the ring, two output tiles, the nine taps, the
    # barriers
    return (1024 + stages * (KP // KC) * box + 2 * TMA_ROWS * NP * 2
            + 9 * KP * NP * 2 + 2 * 8 * stages)


def _tma_stages(H, W, I, O) -> int:
    """Stages of the ``tma`` route's ring: the largest power of two that
    fits, at most MAX_STAGES (0 where not even one fits)."""
    fixed = taploop_smem_bytes("tma", torch.bfloat16, H, W, I, O, 0, 0)
    per = taploop_smem_bytes("tma", torch.bfloat16, H, W, I, O, 0, 1) - fixed
    fit = min(MAX_STAGES, max(0, SMEM_LIMIT - fixed) // per)
    return 1 << (fit.bit_length() - 1) if fit else 0


def taploop_tma_takes(B, H, W, I, O) -> bool:
    """TMA addresses the pixels and outputs (I * 2 and O * 2 multiples of
    16), a halo'd image is one box (W + 2 and H + 2 at most 256), the ring
    holds the images of two tiles, and a client's rows stay below 2^24 (the
    kernel divides them through a float reciprocal)."""
    return (tma_takes(I, O) and max(H, W) + 2 <= MAX_BOX_SIDE
            and B * H * W + TMA_ROWS < 1 << 24
            and _tma_stages(H, W, I, O) >= max(2, taploop_span(B, H, W)))


def taploop_launch_plan(dtype, C: int, B: int, H: int, W: int, I: int,
                        O: int) -> TaploopPlan:
    """The launch of K8b for x (C, B, H, W, I) and w (C, 3, 3, I, O). A
    pure function: the route follows from the dtype and the shape alone
    (float32: the CUDA cores; bfloat16: TMA where ``taploop_tma_takes``,
    else the CUDA cores; other dtypes raise), and so does the rest."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"taploop_conv: compute dtype must be float32 or "
                         f"bfloat16, got {dtype}")
    if dtype == torch.bfloat16 and taploop_tma_takes(B, H, W, I, O):
        KC, NP = taploop_chunk(I), gemm_pass_columns(O)
        stages = _tma_stages(H, W, I, O)
        tiles, passes = -(-B * H * W // TMA_ROWS), -(-O // NP)
        items = C * passes * tiles
        per_block = -(-items // min(items, SMS))
        return TaploopPlan(
            "tma", "wgmma", KC, _up(I, KC), NP, passes, TMA_ROWS, tiles,
            stages, H, TMA_THREADS, -(-items // per_block), per_block,
            taploop_smem_bytes("tma", dtype, H, W, I, O, 0, stages))

    def need(th):
        return taploop_smem_bytes("cuda_core", dtype, H, W, I, O, th, 1)

    # the whole image where it leaves room for two blocks on an SM, else
    # the most rows that fit one block
    band = next((th for limit in (SMEM_LIMIT // 2, SMEM_LIMIT)
                 for th in range(H, 0, -1) if need(th) <= limit), None)
    if band is None:
        raise ValueError(
            f"taploop_conv: rows of width {W} with I={I}, O={O} in {dtype} "
            f"need {need(1)} B of shared memory per block (limit "
            f"{SMEM_LIMIT})")
    # 4 positions x 4 channels a thread; as few sweeps over a band's tasks
    # as MAX_THREADS allows, then no more threads than they need
    tasks = -(-band * W // 4) * (-(-O // 4))
    sweeps = -(-tasks // MAX_THREADS)
    threads = min(MAX_THREADS, (-(-tasks // sweeps) + 31) // 32 * 32)
    groups = -(-B // IMAGES_PER_BLOCK)
    return TaploopPlan("cuda_core", "fma", 4, _up(I, 4), _up(O, 4), 1,
                       band * W, groups, 1, band, threads, C * groups,
                       IMAGES_PER_BLOCK, need(band))


def taploop_walk(plan: TaploopPlan, C: int, B: int, H: int, W: int,
                 block: int):
    """Host twin of the ``tma`` kernel's schedule for one block, its sides
    walked apart as on the card. Returns the images the producer streams,
    as (client, pass, image) in ring order; for each of the block's items
    its (client, pass, tile), the ring positions of the images it reads and
    whether it reloads the taps; and for each consumer warpgroup (items 0,
    2, ... and 1, 3, ...) the ring positions it hands back after each of its
    items."""
    M, HW = B * H * W, H * W
    first = block * plan.items_per_block
    last = min(C * plan.passes * plan.tiles, first + plan.items_per_block)
    walk = [divmod(it, plan.tiles) for it in range(first, last)]

    def images(t):
        return t * plan.rows // HW, (min(M, (t + 1) * plan.rows) - 1) // HW

    loads, next_b = [], 0                      # the producer
    for n, (key, t) in enumerate(walk):
        b_lo, b_hi = images(t)
        if n == 0 or t == 0:
            next_b = b_lo
        loads += [(*divmod(key, plan.passes), b)
                  for b in range(next_b, b_hi + 1)]
        next_b = max(next_b, b_hi + 1)

    def ring_steps():
        """(first, last) ring position of each item, as TapRing counts."""
        u_key = b0_key = u_end = 0
        for n, (_, t) in enumerate(walk):
            b_lo, b_hi = images(t)
            if n == 0 or t == 0:
                u_key, b0_key = u_end, b_lo
            u_end = u_key + b_hi - b0_key + 1
            yield u_key + b_lo - b0_key, u_end - 1

    spans = list(ring_steps())
    items = [((*divmod(key, plan.passes), t), list(range(f, l + 1)),
              n == 0 or t == 0)
             for n, ((key, t), (f, l)) in enumerate(zip(walk, spans))]
    releases = ([], [])                        # the consumers
    u_rel = [0, 0]
    for n in range(len(walk)):
        cw = n & 1
        keep = spans[n + 2][0] if n + 2 < len(walk) else spans[-1][1] + 1
        releases[cw].append(list(range(u_rel[cw], keep)))
        u_rel[cw] = max(u_rel[cw], keep)
    return loads, items, releases


def taploop_kernel_smem_bytes(plan: TaploopPlan, dtype, H: int, W: int,
                              I: int, O: int) -> int:
    """The kernel library's own count of the shared memory `plan` needs, to
    hold ``taploop_smem_bytes`` to (needs the built library)."""
    return _build.load().fl_taploop_smem_bytes(
        _ROUTE_CODE[plan.route], _DTYPE_CODE[dtype], H, W, I, O, plan.band,
        plan.stages)


def taploop_conv_cuda(x, w):
    """Launch K8b on the route of ``taploop_launch_plan``: x (C, B, H, W, I)
    and w (C, 3, 3, I, O) in the compute dtype."""
    name = "probe_taploop_conv"
    check_conv_shapes(x, w)
    _check_dtype(name, x)
    _check_cuda(name, (x, w), (x.dtype, x.dtype))
    C, B, H, W, I = x.shape
    O = w.shape[-1]
    plan = taploop_launch_plan(x.dtype, C, B, H, W, I, O)
    if plan.route == "tma" and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError(f"{name}: the TMA route needs 16-byte aligned "
                         "operands")
    lib = _build.load()
    y = torch.empty((C, B, H, W, O), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fl_taploop_conv(
            _DTYPE_CODE[x.dtype], _ROUTE_CODE[plan.route], _ptr(x), _ptr(w),
            _ptr(y), C, B, H, W, I, O, plan.band, plan.items_per_block,
            plan.threads, plan.stages, plan.blocks, plan.items_per_block,
            ctypes.c_void_p(stream))
    _build.check(lib, rc, name)
    LAUNCHES[name] += 1
    TAPLOOP_ROUTE_LAUNCHES[plan.route] += 1
    return y


# ---------------------------------------------------------------------------
# the public ops
# ---------------------------------------------------------------------------

def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and starting on a 16-byte boundary: a view that starts
    elsewhere is copied into a fresh allocation."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def batched_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(C, M, K) @ (C, K, N) -> (C, M, N) in a's dtype, f32 sums; b is cast
    to a's dtype. Any strides and any offset are taken: the TMA route reads
    the operands from 16-byte boundaries, so a view that starts elsewhere is
    copied first (the route stays a function of dtype and shape)."""
    b = b.to(a.dtype)
    if a.is_cuda:
        return batched_gemm_cuda(_aligned16(a), _aligned16(b))
    return batched_gemm_plain(a, b)


def taploop_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv forward over stacked clients as a loop over
    the nine taps: x (C, B, H, W, I), w (C, 3, 3, I, O) -> (C, B, H, W, O)
    in x's dtype, f32 sums; w is cast to x's dtype. The TMA route reads the
    operands from 16-byte boundaries, so a view that starts elsewhere is
    copied first, as in ``batched_gemm``."""
    w = w.to(x.dtype)
    if x.is_cuda:
        return taploop_conv_cuda(_aligned16(x), _aligned16(w))
    return taploop_conv_plain(x, w)
