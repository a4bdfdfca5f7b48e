"""The launch plans of K8a (``batched_gemm``) and of K4's backward
(``conv_stack`` / ``conv_stack_packed``) held to the card's limits, on the
CPU.

Both plans are pure functions of the dtype and the shapes
(``fl_tpu_torch.ops.conv_probe.launch_plan``,
``fl_tpu_torch.ops.conv_block.backward_plan``), so what a CUDA launch would
ask of an H100 can be checked without one: at most 232,448 bytes of shared
memory a block, whole warps and at most 1024 threads, at most 255 registers'
worth of f32 sums a thread, and the route: float32 always on the CUDA cores,
bfloat16 never; K8a's TMA route only where a row of K and of N is whole
16-byte pieces, with at least two stages in its ring. This file imports no
JAX and needs no GPU.
"""

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fl_tpu_torch.ops import conv_block as cb
from fl_tpu_torch.ops import conv_probe as probe

SMEM_LIMIT = 232448      # bytes of shared memory one block may use
MAX_THREADS = 1024
MAX_REGISTERS = 255
SMS = 132                # SMs of an H100 SXM

DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["f32", "bf16"]

# (C, M, K, N): the bench's bare GEMM and the smoke run's cases
GEMM_SHAPES = {
    "bench": (512, 8192, 288, 64),
    "whole_tiles": (2, 128, 288, 64),
    "ragged": (3, 70, 50, 37),
    "two_clients_of_the_bench": (2, 8192, 288, 64),
    "n_over_64": (1, 300, 64, 136),
}
# (H, W, C1, C2): the bench widths and the 16x16 geometry of the CPU
# parity tests
BWD_GEOMETRIES = {"bench_28x28": (28, 28, 32, 64), "small_16x16": (16, 16, 8, 16)}


def _check_gemm_plan(plan, dtype, C, M, K, N):
    assert 0 < plan.smem_bytes <= SMEM_LIMIT
    assert plan.smem_bytes == probe.gemm_smem_bytes(plan.route, K, N, plan.rows,
                                                    plan.stages)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= MAX_THREADS
    assert 0 < plan.acc_registers <= MAX_REGISTERS
    assert plan.instruction == probe.INSTRUCTIONS[plan.route]
    if dtype == torch.float32:
        assert plan.route == "cuda_core"
        return
    # bfloat16: never on the CUDA cores; TMA exactly where it can address
    # the rows, with a ring of at least two stages
    assert plan.route != "cuda_core" and plan.instruction == "wgmma"
    tma = (2 * K) % 16 == 0 and (2 * N) % 16 == 0
    assert plan.route == ("tma" if tma else "staged")
    if plan.route == "tma":
        assert plan.stages >= 2 and plan.rows == probe.TMA_ROWS
        assert plan.threads == probe.TMA_THREADS == 3 * 128
    else:
        assert plan.stages == 1 and plan.threads == 2 * plan.rows
        assert plan.threads % 128 == 0      # whole warpgroups
    assert plan.k_pad % 16 == 0 and K <= plan.k_pad < K + 16
    assert plan.n_pass in (8, 16, 32, 64)
    assert plan.passes * plan.n_pass >= N > (plan.passes - 1) * plan.n_pass
    # a persistent grid of at most one block an SM; every (client, pass,
    # tile) item has a block and no block is idle
    items = C * plan.passes * -(-M // plan.rows)
    assert 1 <= plan.blocks <= SMS
    assert plan.blocks * plan.items_per_block >= items
    assert (plan.blocks - 1) * plan.items_per_block < items


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("name", sorted(GEMM_SHAPES))
def test_gemm_plan_fits_the_card(name, dtype):
    shape = GEMM_SHAPES[name]
    _check_gemm_plan(probe.launch_plan(dtype, *shape), dtype, *shape)


def test_gemm_bench_plan_streams_a_through_tma():
    """At the bench shape: one block an SM over the 32,768 (client, tile)
    items, B (288 x 64) held per client, K as five 64-wide swizzle boxes
    (the fifth half past K), eight stages of A in flight."""
    plan = probe.launch_plan(torch.bfloat16, *GEMM_SHAPES["bench"])
    assert (plan.route, plan.rows, plan.k_pad, plan.n_pass) == (
        "tma", 128, 288, 64)
    assert (plan.blocks, plan.items_per_block, plan.stages) == (132, 249, 8)
    assert -(-288 // probe.K_BOX) == 5
    assert plan.smem_bytes == (1024 + 8 * 16384 + 2 * 64 * 64 * 2
                               + 288 * 64 * 2 + 16 * 8)


def test_gemm_route_follows_dtype_and_shape_alone():
    routes = {name: probe.launch_plan(torch.bfloat16, *shape).route
              for name, shape in GEMM_SHAPES.items()}
    assert routes == {"bench": "tma", "whole_tiles": "tma",
                      "ragged": "staged", "two_clients_of_the_bench": "tma",
                      "n_over_64": "tma"}
    assert probe.ROUTES == ("tma", "staged", "cuda_core")
    assert sorted(probe.ROUTE_LAUNCHES) == sorted(probe.ROUTES)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        probe.launch_plan(torch.float16, 1, 8, 8, 8)


@settings(max_examples=150, deadline=None)
@given(C=st.integers(1, 600), M=st.integers(1, 20000), K=st.integers(1, 2500),
       N=st.integers(1, 300), bf16=st.booleans())
def test_gemm_plan_fits_the_card_over_a_sweep_of_shapes(C, M, K, N, bf16):
    dtype = torch.bfloat16 if bf16 else torch.float32
    try:
        plan = probe.launch_plan(dtype, C, M, K, N)
    except ValueError as e:
        # refused in words, never planned beyond the card: even the
        # smallest tile of the route does not fit
        assert "shared memory" in str(e) and bf16
        tma = (2 * K) % 16 == 0 and (2 * N) % 16 == 0
        need = (probe.gemm_smem_bytes("tma", K, N, 128, 2) if tma
                else probe.gemm_smem_bytes("staged", K, N, 64, 1))
        assert need > SMEM_LIMIT
        return
    _check_gemm_plan(plan, dtype, C, M, K, N)


def _check_bwd_plan(plan, dtype, H, W, C1, C2):
    assert 0 < plan.smem_bytes <= SMEM_LIMIT
    assert plan.smem_bytes == cb.stack_bwd_smem_bytes(dtype, H, W, C1, C2)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= MAX_THREADS
    assert 0 < plan.acc_registers <= MAX_REGISTERS
    if dtype == torch.float32:
        assert (plan.route, plan.instruction) == ("cuda_core", "fma")
    else:
        assert (plan.route, plan.instruction) == ("tensor_core", "mma.sync")


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("name", sorted(BWD_GEOMETRIES))
def test_backward_plan_fits_the_card(name, dtype):
    geo = BWD_GEOMETRIES[name]
    _check_bwd_plan(cb.backward_plan(dtype, *geo), dtype, *geo)


def test_backward_plans_at_the_bench_widths():
    """f32 keeps the CUDA-core body and its 226,512 bytes; bf16 runs the
    conv2 gradients on mma.sync, with channels padded to 16 and skewed row
    strides in shared memory (w2, x2 and dz2 planes, the stem backward's
    partial sums, a pixel table)."""
    f32 = cb.backward_plan(torch.float32, 28, 28, 32, 64)
    bf16 = cb.backward_plan(torch.bfloat16, 28, 28, 32, 64)
    assert (f32.route, f32.threads, f32.smem_bytes) == (
        "cuda_core", 1024, 226512)
    assert (bf16.route, bf16.instruction) == ("tensor_core", "mma.sync")
    assert bf16.threads == cb.THREADS["conv_stack_bwd_tc"]
    floats = 9 * 32 + 32 + 30 * 30 + 196 * 32 + 64 + 24 * 10 * 32 + 196
    halves = 9 * 32 * 72 + 256 * 40 + 256 * 72 + 49 * 64
    assert bf16.smem_bytes == -(-4 * floats // 16) * 16 + 2 * halves + (
        196 * 32 + 49 * 64)
    assert cb.BWD_ROUTES == {torch.float32: "cuda_core",
                             torch.bfloat16: "tensor_core"}


def test_backward_plan_refuses_threads_the_kernel_cannot_take():
    for dtype in DTYPES:
        for threads in (16, 100, 1056):
            with pytest.raises(ValueError, match="threads a block"):
                cb.backward_plan(dtype, 28, 28, 32, 64, threads=threads)
        assert cb.backward_plan(dtype, 28, 28, 32, 64,
                                threads=256).threads == 256
    with pytest.raises(KeyError):
        cb.backward_plan(torch.float16, 28, 28, 32, 64)


@settings(max_examples=150, deadline=None)
@given(h=st.integers(2, 20), w=st.integers(2, 20), C1=st.integers(1, 64),
       C2=st.integers(1, 128), bf16=st.booleans())
def test_backward_plan_fits_the_card_over_a_sweep_of_shapes(h, w, C1, C2,
                                                            bf16):
    dtype = torch.bfloat16 if bf16 else torch.float32
    H, W = 2 * h, 2 * w
    try:
        plan = cb.backward_plan(dtype, H, W, C1, C2)
    except ValueError as e:
        # refused in words, never planned beyond the card
        assert "shared memory" in str(e)
        assert cb.stack_bwd_smem_bytes(dtype, H, W, C1, C2) > SMEM_LIMIT
        return
    _check_bwd_plan(plan, dtype, H, W, C1, C2)
