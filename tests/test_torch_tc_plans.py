"""The launch plans of K8a (``batched_gemm``) and of the fused conv
segment's four kernels (K1 and K4's forward, K2 and K4's backward, behind
``conv_stack_res`` / ``conv_stack`` / ``conv_stack_packed``) held to the
card's limits, on the CPU.

The plans are pure functions of the dtype and the shapes
(``fl_tpu_torch.ops.conv_probe.launch_plan``,
``fl_tpu_torch.ops.conv_block.launch_plan``), so what a CUDA launch would
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
# (H, W, C1, C2): the bench widths, the 16x16 geometry of the CPU parity
# tests, and the card's second geometry (widths that are no multiples of 16)
BWD_GEOMETRIES = {"bench_28x28": (28, 28, 32, 64), "small_16x16": (16, 16, 8, 16),
                  "g2_16x16": (16, 16, 12, 20)}
CONV_KERNELS = ("conv_block_fwd", "conv_block_bwd", "conv_stack_fwd",
                "conv_stack_bwd")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _check_conv_plan(plan, kernel, dtype, H, W, C1, C2):
    assert plan.kernel == kernel
    assert 0 < plan.smem_bytes <= SMEM_LIMIT
    assert plan.smem_bytes == cb.smem_bytes(kernel, dtype, H, W, C1, C2)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= MAX_THREADS
    assert 0 < plan.acc_registers <= MAX_REGISTERS
    if dtype == torch.float32:
        assert (plan.route, plan.instruction) == ("cuda_core", "fma")
        assert plan.threads == cb.THREADS[kernel]
    else:
        assert (plan.route, plan.instruction) == ("tensor_core", "mma.sync")
        assert plan.threads == cb.THREADS[kernel + "_tc"]


def _check_bwd_plan(plan, dtype, H, W, C1, C2):
    _check_conv_plan(plan, "conv_stack_bwd", dtype, H, W, C1, C2)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("name", sorted(BWD_GEOMETRIES))
def test_backward_plan_fits_the_card(name, dtype):
    geo = BWD_GEOMETRIES[name]
    _check_bwd_plan(cb.launch_plan("conv_stack_bwd", dtype, *geo), dtype,
                    *geo)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("kernel", ["conv_block_fwd", "conv_block_bwd",
                                    "conv_stack_fwd"])
@pytest.mark.parametrize("name", sorted(BWD_GEOMETRIES))
def test_forward_and_residual_backward_plans_fit_the_card(name, kernel,
                                                          dtype):
    geo = BWD_GEOMETRIES[name]
    _check_conv_plan(cb.launch_plan(kernel, dtype, *geo), kernel, dtype,
                     *geo)


def test_backward_plans_at_the_bench_widths():
    """f32 keeps the CUDA-core body and its 226,512 bytes; bf16 runs the
    conv2 gradients on mma.sync, with channels padded to 16 and skewed row
    strides in shared memory (w2, x2 and dz2 planes, the stem backward's
    partial sums, a pixel table)."""
    f32 = cb.launch_plan("conv_stack_bwd", torch.float32, 28, 28, 32, 64)
    bf16 = cb.launch_plan("conv_stack_bwd", torch.bfloat16, 28, 28, 32, 64)
    assert (f32.route, f32.threads, f32.smem_bytes) == (
        "cuda_core", 1024, 226512)
    assert (bf16.route, bf16.instruction) == ("tensor_core", "mma.sync")
    assert bf16.threads == cb.THREADS["conv_stack_bwd_tc"]
    floats = 9 * 32 + 32 + 30 * 30 + 196 * 32 + 64 + 24 * 10 * 32 + 196
    halves = 9 * 32 * 72 + 256 * 40 + 256 * 72 + 49 * 64
    assert bf16.smem_bytes == -(-4 * floats // 16) * 16 + 2 * halves + (
        196 * 32 + 49 * 64)
    assert cb.ROUTES == {torch.float32: "cuda_core",
                         torch.bfloat16: "tensor_core"}


def test_forward_and_residual_backward_plans_at_the_bench_widths():
    """K1 and K4's forward take one plan: in f32 the CUDA-core body's
    111,632 bytes, in bf16 the tensor-core body's w2 rows and x2 plane with
    padded, skewed strides (67,088 bytes: three blocks' worth of an SM's
    shared memory). K2 in bf16 is K4's backward body without b2; in f32
    without the recompute's buffers."""
    for kernel in ("conv_block_fwd", "conv_stack_fwd"):
        f32 = cb.launch_plan(kernel, torch.float32, 28, 28, 32, 64)
        bf16 = cb.launch_plan(kernel, torch.bfloat16, 28, 28, 32, 64)
        assert f32.smem_bytes == 4 * (9 * 32 + 32 + 64 + 900 + 9 * 32 * 64
                                      + 256 * 32) == 111632
        floats = 9 * 32 + 32 + 64 + 30 * 30
        assert bf16.smem_bytes == -(-4 * floats // 16) * 16 + 2 * (
            9 * 32 * 72 + 256 * 40) == 67088
        assert 3 * bf16.smem_bytes <= SMEM_LIMIT
        assert (bf16.acc_registers, f32.acc_registers) == (16, 4)
    k2 = {dt: cb.launch_plan("conv_block_bwd", dt, 28, 28, 32, 64)
          for dt in DTYPES}
    k4 = {dt: cb.launch_plan("conv_stack_bwd", dt, 28, 28, 32, 64)
          for dt in DTYPES}
    assert k4[torch.bfloat16].smem_bytes - k2[torch.bfloat16].smem_bytes == (
        4 * 64)
    assert k2[torch.float32].smem_bytes == 208272
    assert (k2[torch.bfloat16].route, k2[torch.bfloat16].threads) == (
        "tensor_core", cb.THREADS["conv_block_bwd_tc"])


def test_every_kernel_routes_by_dtype_alone():
    for kernel in CONV_KERNELS:
        for H, W, C1, C2 in BWD_GEOMETRIES.values():
            assert {cb.launch_plan(kernel, dt, H, W, C1, C2).route
                    for dt in DTYPES} == {"cuda_core", "tensor_core"}
            assert cb.launch_plan(kernel, torch.bfloat16, H, W, C1,
                                  C2).route == cb.ROUTES[torch.bfloat16]
    assert sorted(cb.LAUNCHES) == sorted(CONV_KERNELS)
    with pytest.raises(ValueError, match="no kernel"):
        cb.launch_plan("conv_block", torch.float32, 28, 28, 32, 64)


def test_backward_plan_refuses_threads_the_kernel_cannot_take():
    for dtype in DTYPES:
        for kernel in CONV_KERNELS:
            for threads in (16, 100, 1056):
                with pytest.raises(ValueError, match="threads a block"):
                    cb.launch_plan(kernel, dtype, 28, 28, 32, 64,
                                   threads=threads)
            assert cb.launch_plan(kernel, dtype, 28, 28, 32, 64,
                                  threads=256).threads == 256
    with pytest.raises(KeyError):
        cb.launch_plan("conv_stack_bwd", torch.float16, 28, 28, 32, 64)


def test_plans_refuse_shared_memory_beyond_the_limit():
    """56x56 images with C1=64, C2=128: no block holds any of the four, in
    either dtype; the refusal names the bytes."""
    for kernel in CONV_KERNELS:
        for dtype in DTYPES:
            need = cb.smem_bytes(kernel, dtype, 56, 56, 64, 128)
            assert need > SMEM_LIMIT
            with pytest.raises(ValueError, match=f"{need} B of shared memory"):
                cb.launch_plan(kernel, dtype, 56, 56, 64, 128)


@settings(max_examples=150, deadline=None)
@given(h=st.integers(2, 20), w=st.integers(2, 20), C1=st.integers(1, 64),
       C2=st.integers(1, 128), bf16=st.booleans())
def test_backward_plan_fits_the_card_over_a_sweep_of_shapes(h, w, C1, C2,
                                                            bf16):
    dtype = torch.bfloat16 if bf16 else torch.float32
    H, W = 2 * h, 2 * w
    try:
        plan = cb.launch_plan("conv_stack_bwd", dtype, H, W, C1, C2)
    except ValueError as e:
        # refused in words, never planned beyond the card
        assert "shared memory" in str(e)
        assert cb.smem_bytes("conv_stack_bwd", dtype, H, W, C1,
                             C2) > SMEM_LIMIT
        return
    _check_bwd_plan(plan, dtype, H, W, C1, C2)


@settings(max_examples=150, deadline=None)
@given(h=st.integers(2, 20), w=st.integers(2, 20), C1=st.integers(1, 64),
       C2=st.integers(1, 128), bf16=st.booleans(),
       kernel=st.sampled_from(["conv_block_fwd", "conv_block_bwd",
                               "conv_stack_fwd"]))
def test_forward_and_residual_backward_plans_over_a_sweep_of_shapes(
        h, w, C1, C2, bf16, kernel):
    dtype = torch.bfloat16 if bf16 else torch.float32
    H, W = 2 * h, 2 * w
    try:
        plan = cb.launch_plan(kernel, dtype, H, W, C1, C2)
    except ValueError as e:
        assert "shared memory" in str(e)
        assert cb.smem_bytes(kernel, dtype, H, W, C1, C2) > SMEM_LIMIT
        return
    _check_conv_plan(plan, kernel, dtype, H, W, C1, C2)
    # K2 never needs more than K4's backward, and the two forwards agree
    if kernel == "conv_block_bwd":
        assert plan.smem_bytes <= cb.smem_bytes("conv_stack_bwd", dtype, H,
                                                W, C1, C2)
    if kernel.endswith("_fwd"):
        assert plan.smem_bytes == cb.smem_bytes("conv_stack_fwd", dtype, H,
                                                W, C1, C2)
