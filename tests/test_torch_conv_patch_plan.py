"""K7's launch plan held to the card's limits, and ``conv3x3_patch`` held to
the reference's Pallas kernel, on the CPU.

The plan (``fl_tpu_torch.ops.conv_patch.launch_plan``) is a pure function of
the dtype and the shapes, so what the CUDA launch would ask of an H100 can be
checked without one: at most 232,448 bytes of shared memory a block, whole
warps and at most 1024 threads, at most 255 registers' worth of f32 sums a
thread, every row tile and every block of dW owned by some thread block, the
padding the tensor-core tile needs (K to 16, N to 8), and the route: float32
to the CUDA-core kernels, bfloat16 to the tensor-core ones (wgmma for the
patch GEMM, mma.sync for the weight gradient), by the dtype alone.

The parity tests make their inputs with numpy from a seed and send them
through ``fl_tpu.ops.conv_pallas.conv3x3_pallas`` (interpret mode on the CPU,
as ``tests/test_ops.py`` runs it) and through ``conv3x3_patch`` (its plain
PyTorch version, which a CPU tensor selects): forward, input gradient and
weight gradient. Tolerances: f32 rtol 1e-4 / atol 1e-4, weight gradient atol
2e-4 (the reference's own: f32 sums in another order); bf16 one bf16 ulp of
the larger value plus 1e-4 (both sides round one f32 sum once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fl_tpu.ops.conv_pallas import conv3x3_pallas
from fl_tpu_torch.ops import conv_patch as cp

SMEM_LIMIT = 232448      # bytes of shared memory one block may use
MAX_THREADS = 1024
MAX_REGISTERS = 255

CLIENTS, BATCH = 512, 32          # the bench: 512 clients x 32 images
DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["f32", "bf16"]
# (C, B, H, W, I, O) of a patch GEMM (y = patches(x) @ w2, w2 (9*I, O))
GEMM_SHAPES = {
    "conv2_fwd": (CLIENTS, BATCH, 14, 14, 32, 64),
    "conv2_dgrad": (CLIENTS, BATCH, 14, 14, 64, 32),
    "stem_fwd": (CLIENTS, BATCH, 14, 14, 4, 128),
    "ragged_3_6": (3, 3, 5, 7, 3, 6),
    "ragged_6_3": (3, 3, 5, 7, 6, 3),
    "ragged_20_12": (3, 3, 5, 7, 20, 12),
    "ragged_12_20": (3, 3, 5, 7, 12, 20),
    "ragged_48_40": (3, 2, 14, 14, 48, 40),
    "one_client_28x28": (1, 1, 28, 28, 4, 8),
}
WGRAD_SHAPES = {k: v for k, v in GEMM_SHAPES.items()
                if k not in ("conv2_dgrad", "ragged_6_3", "ragged_12_20")}
WGRAD_SHAPES["conv2_wgrad"] = WGRAD_SHAPES.pop("conv2_fwd")
WGRAD_SHAPES["stem_wgrad"] = WGRAD_SHAPES.pop("stem_fwd")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _up(n, m):
    return -(-n // m) * m


def _check_plan(plan, kernel, dtype, C, B, H, W, I, O):
    R = B * H * W
    assert plan.kernel == kernel
    assert plan.route == ("cuda_core" if dtype == torch.float32
                          else "tensor_core")
    assert plan.instruction == cp.INSTRUCTIONS[plan.route, kernel]
    assert 0 < plan.smem_bytes <= SMEM_LIMIT
    assert plan.smem_bytes == cp.smem_bytes(kernel, dtype, W, I, O, plan.rows,
                                            plan.threads, plan.stages)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= cp.MAX_THREADS
    assert cp.MAX_THREADS <= MAX_THREADS
    assert 0 < plan.acc_registers <= MAX_REGISTERS
    assert plan.stages in (1, 2)
    assert plan.slots >= 1 and plan.chunks >= 1 and plan.blocks >= 1
    # every row tile belongs to a block
    n_tiles = -(-R // plan.rows)
    assert plan.blocks * plan.tiles_per_block >= n_tiles
    # no block of the patch GEMM is idle; a weight-gradient slot may be
    # (it writes zeros), but there are never more slots than tiles
    if kernel == "gemm":
        assert (plan.blocks - 1) * plan.tiles_per_block < n_tiles
    assert plan.blocks <= n_tiles
    # grid dimensions the card takes: x up to 2^31 - 1, y and z up to 65535
    assert C <= 65535 and plan.chunks <= 65535
    warps = plan.threads // 32
    if plan.route == "tensor_core":
        assert plan.k_pad % 16 == 0 and plan.k_pad >= 9 * I
        assert plan.n_pad % 8 == 0 and plan.n_pad >= O
        if kernel == "gemm":
            # wgmma: whole warpgroups of 32 rows a warp; N padded to whole
            # passes of 8, 16, 32 or 64 columns
            assert plan.instruction == "wgmma" and plan.threads % 128 == 0
            assert plan.rows == warps * cp.TC_WARP_ROWS
            assert (plan.slots, plan.chunks) == (1, 1)
            cols = cp.gemm_pass_columns(O)
            assert cols in (8, 16, 32, 64) and plan.n_pad % cols == 0
            assert plan.n_pad - O < cols and (cols == 8 or O > cols // 2)
        else:
            assert plan.instruction == "mma.sync"
            assert plan.n_pad < O + 8 and plan.rows % 16 == 0
            # every (64 outputs, tap, 16 channels) block of dW has its warp
            items = -(-plan.n_pad // cp.TC_COLS) * (plan.k_pad // 16)
            assert plan.chunks * warps * cp.TC_WGRAD_ITEMS >= items
            assert (plan.chunks - 1) * warps * cp.TC_WGRAD_ITEMS < items
            assert plan.blocks == plan.slots
    else:
        assert plan.stages == 1 and plan.rows % 4 == 0
        assert plan.k_pad == 9 * _up(I, 4) and plan.n_pad == _up(O, 4)
        if kernel == "wgrad":
            tasks = plan.k_pad // 4 * (plan.n_pad // 4)
            assert plan.chunks * plan.threads * cp.WGRAD_TASKS >= tasks


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("name", sorted(GEMM_SHAPES))
def test_gemm_plan_fits_the_card(name, dtype):
    shape = GEMM_SHAPES[name]
    _check_plan(cp.launch_plan("gemm", dtype, *shape), "gemm", dtype, *shape)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("name", sorted(WGRAD_SHAPES))
def test_wgrad_plan_fits_the_card(name, dtype):
    shape = WGRAD_SHAPES[name]
    _check_plan(cp.launch_plan("wgrad", dtype, *shape), "wgrad", dtype,
                *shape)


def test_bench_plans_leave_room_for_two_blocks_on_an_sm():
    """At the bench's conv2 shapes every tensor-core launch fits twice into
    an SM's shared memory, and the weight gradient needs no second pass: one
    slot a client, written straight to dW."""
    dt = torch.bfloat16
    fwd = cp.launch_plan("gemm", dt, *GEMM_SHAPES["conv2_fwd"])
    dgrad = cp.launch_plan("gemm", dt, *GEMM_SHAPES["conv2_dgrad"])
    wgrad = cp.launch_plan("wgrad", dt, *WGRAD_SHAPES["conv2_wgrad"])
    for plan in (fwd, dgrad, wgrad):
        assert 2 * plan.smem_bytes <= SMEM_LIMIT
    assert (fwd.k_pad, fwd.n_pad) == (288, 64)
    assert (dgrad.k_pad, dgrad.n_pad) == (576, 32)
    assert (wgrad.slots, wgrad.chunks, wgrad.threads) == (1, 1, 288)


def test_route_follows_the_dtype_alone():
    assert cp.ROUTES == {torch.float32: "cuda_core",
                         torch.bfloat16: "tensor_core"}
    for kernel in ("gemm", "wgrad"):
        for shape in GEMM_SHAPES.values():
            assert {dt: cp.launch_plan(kernel, dt, *shape).route
                    for dt in DTYPES} == cp.ROUTES
    with pytest.raises(KeyError):
        cp.launch_plan("gemm", torch.float16, 1, 1, 4, 4, 2, 2)


def test_plan_refuses_what_no_block_can_hold():
    with pytest.raises(ValueError, match="shared memory"):
        cp.launch_plan("gemm", torch.bfloat16, 1, 1, 8, 8, 512, 512)
    with pytest.raises(ValueError, match="shared memory"):
        cp.launch_plan("gemm", torch.float32, 1, 1, 8, 8, 256, 256)


@settings(max_examples=150, deadline=None)
@given(C=st.integers(1, 600), B=st.integers(1, 40), H=st.integers(1, 40),
       W=st.integers(1, 40), I=st.integers(1, 72), O=st.integers(1, 136),
       bf16=st.booleans(), wgrad=st.booleans())
def test_plan_fits_the_card_over_a_sweep_of_shapes(C, B, H, W, I, O, bf16,
                                                   wgrad):
    dtype = torch.bfloat16 if bf16 else torch.float32
    kernel = "wgrad" if wgrad else "gemm"
    try:
        plan = cp.launch_plan(kernel, dtype, C, B, H, W, I, O)
    except ValueError as e:
        # refused in words, never planned beyond the card
        assert "shared memory" in str(e)
        need = cp.smem_bytes(kernel, dtype, W, I, O,
                             16 if bf16 and wgrad else 128 if bf16 else 4,
                             128, 1)
        assert need > SMEM_LIMIT
        return
    _check_plan(plan, kernel, dtype, C, B, H, W, I, O)


# ---------------------------------------------------------------------------
# conv3x3_patch (plain path) against conv3x3_pallas in interpret mode
# ---------------------------------------------------------------------------

PARITY_SHAPES = [(2, 14, 14, 32, 64), (2, 14, 14, 4, 128), (3, 5, 7, 3, 6),
                 (3, 5, 7, 20, 12)]
PARITY_IDS = ["conv2_32_64", "stem_4_128", "ragged_3_6", "ragged_20_12"]


def _inputs(shape, seed):
    B, H, W, I, O = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, I)).astype(np.float32)
    w = (rng.standard_normal((3, 3, I, O)) * 0.1).astype(np.float32)
    g = rng.standard_normal((B, H, W, O)).astype(np.float32)
    return x, w, g


def _reference(x, w, g, dtype):
    xj, wj, gj = (jnp.asarray(t).astype(dtype) for t in (x, w, g))
    y = conv3x3_pallas(xj, wj)
    dx, dw = jax.grad(
        lambda a, b: jnp.sum(conv3x3_pallas(a, b).astype(jnp.float32)
                             * gj.astype(jnp.float32)), (0, 1))(xj, wj)
    return [np.asarray(t.astype(jnp.float32)) for t in (y, dx, dw)]


def _port(x, w, g, dtype):
    xt = torch.tensor(x).to(dtype).requires_grad_(True)
    wt = torch.tensor(w).to(dtype).requires_grad_(True)
    y = cp.conv3x3_patch(xt, wt)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.tensor(g).to(dtype))
    assert y.dtype == dx.dtype == dw.dtype == dtype
    return [t.detach().float().numpy() for t in (y, dx, dw)]


@pytest.mark.parametrize("shape", PARITY_SHAPES, ids=PARITY_IDS)
def test_conv3x3_patch_f32_matches_pallas(shape):
    x, w, g = _inputs(shape, seed=11)
    got = _port(x, w, g, torch.float32)
    want = _reference(x, w, g, jnp.float32)
    for a, b, atol in zip(got, want, (1e-4, 1e-4, 2e-4)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("shape", PARITY_SHAPES, ids=PARITY_IDS)
def test_conv3x3_patch_bf16_matches_pallas(shape):
    x, w, g = _inputs(shape, seed=12)
    got = _port(x, w, g, torch.bfloat16)
    want = _reference(x, w, g, jnp.bfloat16)
    for name, a, b in zip(("y", "dx", "dw"), got, want):
        mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0 ** -126)
        ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
        off = np.abs(a - b) > ulp + 1e-4
        assert not off.any(), (name, int(off.sum()), a[off][:4], b[off][:4])
