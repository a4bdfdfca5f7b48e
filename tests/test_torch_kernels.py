"""The port's kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs on the machine with the card:

    python3 -m pytest tests/test_torch_kernels.py -q -p no:fl_tpu_test_env \\
        --noconftest

The ``cuda``-marked tests need a GPU (the CUDA and Triton kernels have no
CPU mode) and skip without one; the others check the plain versions'
own invariants on the CPU. Tolerances: K1 forward 1e-5 in f32 and one
bf16 ulp (plus 1e-5 where a sum straddles zero before relu) in bf16; K2
gradients 2e-4 in f32 and a relative Frobenius error of 1e-2 in bf16 (the
kernel and the plain version round dz2/dz1 to bf16 at the same points but
sum in different orders); K3 at σ=0 exactly x·scale to 1e-6 relative, its
noise equal to the numpy Philox4x32-10 oracle (``philox_oracle.py``)
through its counter map to 1e-5 (the card's log, sqrt, sin and cos) at
ragged widths, by moments at about 6 standard errors, by a
Kolmogorov–Smirnov test at significance 1e-3, and uncorrelated (z and z²,
5e-3) between the cosine and sine of one radius and between the two pairs
of one Philox call; ``dp_noise_client_deltas`` through K3 at ε = 5 on
SimpleCNN's leaves, each residual N(0, 1) at 5 standard errors; K4 the
tolerances of K1/K2 against its plain version, its forward bit-equal to K1
and its backward bit-equal to K2 fed K1's residuals in both dtypes (one
body each: in bf16 conv2 and its gradients run on the tensor cores for all
of them), and to itself bit for bit across two runs; K1/K2/K4 also at a
second geometry whose widths are no multiples of 16 (H=16, C1=12, C2=20, 5
images a client); K5 bit-equal to ``conv_stack`` per client; K6 equal to
its plain version exactly in the deterministic mode (q and scales), in the
stochastic mode equal to the Philox oracle's decisions exactly and held by
floor/ceil, mean, P(ceil) and the correlation of one call's quarters
(5e-3); K7 and K8 (one f32 sum, one rounding) rtol 1e-4 / atol 1e-4 in f32,
weight gradients atol 2e-4, and one bf16 ulp of the larger value plus 1e-4
in bf16, whatever route K8a's or K8b's plan takes (K8b's TMA route also
at the edges of its design: a tile over two images, a ragged last tile,
three column passes, the 128-byte swizzle, two boxes a pixel, clients
changing inside a block, a ring of two images, a misaligned view).

DP-SGD's microbatch form folds a (C, m) chunk of examples into a (C·m, 1)
batch: K1/K2 (and K4) are held to their plain versions at that shape (one
image a client, a partial block of the four images a block takes), and on
the card the ghost form equals the microbatch form on the unfused model
and on K1/K2 at the reference's rtol 2e-4 / atol 2e-5 (f32).

The client mesh on the card: one NCCL rank (``core.mesh.make_mesh()``)
runs the bench configuration's round (K1, K2, K3) bit-equal to the
unsharded engine's, and DP-SGD's noise through K3 is keyed by global
client id (the halves of the client axis draw the whole axis's noise).

Two plain functions of the port's device path are held on the card too:
the stacked stochastic bf16 rounding equals the CPU's bit for bit, and
Krum's Gram product stays in full f32 with the TF32 switch on (equal to
itself with the switch off, within f32 of f64).
"""

import numpy as np
import pytest
import torch

import philox_oracle as oracle
from fl_tpu_torch import ops
from fl_tpu_torch.core import prng
from fl_tpu_torch.ops import _build
from fl_tpu_torch.ops import conv_block as cb
from fl_tpu_torch.ops import conv_patch as cp
from fl_tpu_torch.ops import conv_probe as probe
from fl_tpu_torch.ops import dp as dpo
from fl_tpu_torch.ops import quantize as qz
from fl_tpu_torch.ops import rounding


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conv_inputs(gen, C, B, H, C1, C2, dtype, device, ones=False):
    x = (torch.ones((C, B, H, H, 1), device=device) if ones else
         torch.randn((C, B, H, H, 1), generator=gen, device=device))
    w1 = torch.randn((C, 3, 3, 1, C1), generator=gen, device=device) * 0.5
    b1 = torch.randn((C, C1), generator=gen, device=device) * 0.1
    w2 = torch.randn((C, 3, 3, C1, C2), generator=gen, device=device) * 0.1
    b2 = torch.randn((C, C2), generator=gen, device=device) * 0.1
    return (x.to(dtype), w1.to(dtype), b1.to(dtype).float(), w2.to(dtype),
            b2.to(dtype).float())


# ---------------------------------------------------------------------------
# plain versions (CPU)
# ---------------------------------------------------------------------------

def test_unpool_is_the_adjoint_of_the_pool_gather():
    """<gather(t, idx), g> == <t, unpool(g, idx)> for the first-match
    index of t."""
    g = torch.Generator().manual_seed(0)
    t = torch.randn((2, 3, 6, 6), generator=g, dtype=torch.float64)
    m, idx = cb._pool_first(t)
    gy = torch.randn(m.shape, generator=g, dtype=torch.float64)
    lhs = (m * gy).sum()
    rhs = (t * cb._unpool(gy, idx, 6, 6)).sum()
    torch.testing.assert_close(lhs, rhs)


def test_pool2_windows_agree_with_the_pooled_output():
    g = torch.Generator().manual_seed(1)
    args = _conv_inputs(g, 2, 2, 16, 8, 16, torch.float32, "cpu")
    pooled, idx = cb.conv_stack_res_fwd_plain(*args)
    win = cb.pool2_windows_plain(*args)
    assert torch.equal(win.amax(-1), pooled)
    assert torch.equal(win.gather(-1, idx.long()[..., None])[..., 0], pooled)


def test_build_hash_covers_sources_and_flags():
    path = _build.library_path()
    assert path.parent.parent == _build.BUILD_DIR
    assert path == _build.library_path()
    assert [p.name for p in _build.sources()] == [
        "conv_block.cu", "conv_patch.cu", "conv_probe.cu"]


def test_launch_counts_cover_every_kernel():
    assert sorted(ops.launch_counts()) == sorted([
        "conv_block_fwd", "conv_block_bwd", "conv_stack_fwd",
        "conv_stack_bwd", "clip_noise", "quantize_int8_blocks",
        "conv3x3_patch_gemm", "conv3x3_patch_wgrad", "probe_batched_gemm",
        "probe_taploop_conv"])
    # K7's, K8a's, K8b's and K4's backward's launches once more, by the
    # route they took: reset with the counts
    assert sorted(cp.ROUTE_LAUNCHES) == ["cuda_core", "tensor_core"]
    assert sorted(probe.ROUTE_LAUNCHES) == ["cuda_core", "staged", "tma"]
    assert sorted(probe.TAPLOOP_ROUTE_LAUNCHES) == ["cuda_core", "tma"]
    assert sorted(cb.ROUTE_LAUNCHES) == sorted(
        (k, r) for k in cb.LAUNCHES for r in ("cuda_core", "tensor_core"))
    cp.ROUTE_LAUNCHES["tensor_core"] = 3
    probe.ROUTE_LAUNCHES["tma"] = 2
    probe.TAPLOOP_ROUTE_LAUNCHES["tma"] = 4
    cb.ROUTE_LAUNCHES[("conv_block_bwd", "tensor_core")] = 1
    ops.reset_launch_counts()
    for counts in (cp.ROUTE_LAUNCHES, probe.ROUTE_LAUNCHES,
                   probe.TAPLOOP_ROUTE_LAUNCHES, cb.ROUTE_LAUNCHES):
        assert set(counts.values()) == {0}


def test_patch_matrix_times_weights_is_the_convolution():
    """The plain versions' patch matrix against F.conv2d, and the input
    gradient's mirrored, transposed weights against autograd's."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn((2, 3, 6, 5, 4), generator=g, dtype=torch.float64)
    w = torch.randn((2, 3, 3, 4, 7), generator=g, dtype=torch.float64)
    x.requires_grad_(True)
    want = torch.stack([torch.nn.functional.conv2d(
        x[c].permute(0, 3, 1, 2), w[c].permute(3, 2, 0, 1),
        padding=1).permute(0, 2, 3, 1) for c in range(2)])
    got = torch.bmm(cp.patches(x.float()).double(), w.reshape(2, 36, 7))
    torch.testing.assert_close(got.reshape(want.shape), want.detach(),
                               rtol=1e-5, atol=1e-5)
    gy = torch.randn(want.shape, generator=g, dtype=torch.float64)
    dx, = torch.autograd.grad(want, x, gy)
    got_dx = cp.conv3x3_patch_dgrad_plain(gy.float(), w.float())
    torch.testing.assert_close(got_dx.double(), dx, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only there")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ones", [False, True], ids=["random", "all_ties"])
def test_conv_kernels_match_plain(cuda, dtype, ones):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, w1, b1, w2, b2 = _conv_inputs(gen, 4, 32, 28, 32, 64, dtype, cuda,
                                     ones)
    pooled, idx = cb.conv_block_fwd_cuda(x, w1, b1, w2, b2)
    want, want_idx = cb.conv_stack_res_fwd_plain(x, w1, b1, w2, b2)
    pk, pr = pooled.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(pk, pr, rtol=1e-5, atol=1e-5)
    else:
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.maximum(pk.abs(), pr.abs()).clamp(min=2.0 ** -126))) - 7)
        assert bool(((pk - pr).abs() <= ulp + 1e-5).all())
    gy = torch.randn(pooled.shape, generator=gen, device=cuda)
    gy = (gy * (want > 0)).to(dtype).contiguous()
    got = cb.conv_block_bwd_cuda(gy, want_idx, x, w1, b1, w2)
    ref = cb.conv_stack_res_bwd_plain(gy, want_idx, x, w1, b1, w2)
    for a, b in zip(got, ref):
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
        else:
            assert float((a - b).norm() / b.norm().clamp(min=1e-30)) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernels_at_the_dp_sgd_fold_shape(cuda, dtype):
    """512 clients x a DP-SGD chunk of 16 examples folded into 8192
    clients of one image each: K1, K2 and K4 against their plain versions,
    K4 bit-equal to K1 / K2 fed K1's residuals."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    args = _conv_inputs(gen, 8192, 1, 28, 32, 64, dtype, cuda)
    x, w1, b1, w2, b2 = args
    pooled, idx = cb.conv_block_fwd_cuda(*args)
    want, want_idx = cb.conv_stack_res_fwd_plain(*args)
    _assert_k1_close(pooled, want, dtype)
    assert torch.equal(cb.conv_stack_fwd_cuda(*args), pooled)
    gy = torch.randn(pooled.shape, generator=gen, device=cuda)
    gy = (gy * (want > 0)).to(dtype).contiguous()
    got = cb.conv_block_bwd_cuda(gy, want_idx, x, w1, b1, w2)
    ref = cb.conv_stack_res_bwd_plain(gy, want_idx, x, w1, b1, w2)
    for a, b in zip(got, ref):
        assert a.shape[0] == 8192
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
        else:
            assert float((a - b).norm() / b.norm().clamp(min=1e-30)) <= 1e-2
    g_k = (torch.randn(pooled.shape, generator=gen, device=cuda)
           * (pooled > 0)).to(dtype).contiguous()
    k2 = cb.conv_block_bwd_cuda(g_k, idx, x, w1, b1, w2)
    k4 = cb.conv_stack_bwd_cuda(g_k, *args)
    assert all(torch.equal(a, b) for a, b in zip(k2, k4))


@pytest.mark.cuda
def test_dp_sgd_ghost_equals_microbatch_on_the_card(cuda):
    """The two DP-SGD forms on the card, f32, z = 1.1, the same seeds: the
    ghost form on the unfused model against the microbatch fold on the
    unfused model and on ``"residual"`` (K1/K2 at the fold's shape, which
    must have been launched), leaf by leaf."""
    from fl_tpu_torch.fl import privacy as dp
    from fl_tpu_torch.models import create_model

    C, B = 3, 8
    gen = torch.Generator(device=cuda).manual_seed(4)
    xb = torch.randn((C, B, 28, 28, 1), generator=gen, device=cuda)
    yb = torch.randint(0, 10, (C, B), generator=gen, device=cuda)
    wmask = torch.ones((C, B), device=cuda)
    wmask[0, 2] = 0.0
    unfused = create_model("simple_cnn", dropout_rate=0.0)
    init = unfused.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    params = {l: {k: torch.stack([v * (1 + 0.1 * c) for c in range(C)])
                  for k, v in d.items()} for l, d in init.items()}
    args = (params, xb, yb, wmask, 1, 2)
    ghost = dp.make_ghost_dp_sgd_grad_fn(unfused, 0.7, 1.1)(*args)
    ops.reset_launch_counts()
    for fused in (False, "residual"):
        model = create_model("simple_cnn", dropout_rate=0.0,
                             fused_conv_block=fused)
        micro = dp.make_dp_sgd_grad_fn(model, 0.7, 1.1, 4)(*args)
        for l in ghost:
            for k in ghost[l]:
                torch.testing.assert_close(ghost[l][k], micro[l][k],
                                           rtol=2e-4, atol=2e-5)
    counts = ops.launch_counts()
    assert counts["conv_block_fwd"] == counts["conv_block_bwd"] == B // 4


def _assert_k1_close(pooled, want, dtype):
    pk, pr = pooled.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(pk, pr, rtol=1e-5, atol=1e-5)
    else:
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.maximum(pk.abs(), pr.abs()).clamp(min=2.0 ** -126))) - 7)
        assert bool(((pk - pr).abs() <= ulp + 1e-5).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_forward_launches_k1_alone_under_no_grad(cuda, dtype):
    """The evaluation path (federated evaluation, q-FFL's F_k(θ̂),
    personalization's holdout): ``conv_stack_res`` under ``torch.no_grad``
    at the eval shape (a whole 64-image shard a client) launches K1's
    forward once and nothing else, within K1's tolerance of the plain
    version."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x, w1, b1, w2, b2 = _conv_inputs(gen, 4, 64, 28, 32, 64, dtype, cuda)
    ops.reset_launch_counts()
    with torch.no_grad():
        pooled = cb.conv_stack_res(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["conv_block_fwd"] == 1 and sum(counts.values()) == 1
    assert not pooled.requires_grad
    want, _ = cb.conv_stack_res_plain(x, w1, b1, w2, b2)
    _assert_k1_close(pooled, want, dtype)


@pytest.mark.cuda
def test_federated_eval_launches_k1_once_a_chunk(cuda):
    """``make_federated_eval_fn`` over 4 clients' 64-image shards in chunks
    of 32: one K1 launch a chunk, no backward; per-client loss and
    accuracy equal to the same function on the CPU (the plain version) in
    f32 to 1e-5."""
    from fl_tpu_torch.fl.federated_eval import make_federated_eval_fn
    from fl_tpu_torch.models import create_model

    model = create_model("simple_cnn", fused_conv_block="residual")
    g = torch.Generator().manual_seed(6)
    params = {l: {k: v[None].expand(4, *v.shape).contiguous()
                  for k, v in d.items()}
              for l, d in model.init(g, "cpu").items()}
    images = torch.randint(0, 256, (4, 64, 28, 28, 1), generator=g,
                           dtype=torch.uint8)
    labels = torch.randint(0, 10, (4, 64), generator=g)
    n = torch.tensor([64, 50, 33, 1], dtype=torch.int32)
    mean, std = torch.tensor([0.1307]), torch.tensor([0.3081])
    want = make_federated_eval_fn(model, 64, mean, std, chunk_size=32)(
        params, images, labels, n)
    on = {l: {k: v.to(cuda) for k, v in d.items()}
          for l, d in params.items()}
    ops.reset_launch_counts()
    got = make_federated_eval_fn(model, 64, mean.to(cuda), std.to(cuda),
                                 chunk_size=32)(
        on, images.to(cuda), labels.to(cuda), n.to(cuda))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["conv_block_fwd"] == 2 and sum(counts.values()) == 2
    for k in ("loss", "accuracy"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ones", [False, True], ids=["random", "all_ties"])
def test_residual_free_kernels_equal_k1_k2_and_match_plain(cuda, dtype, ones):
    """K4 computes K1/K2's function with no residual: its forward bit-equal
    to K1 on the same inputs, its backward bit-equal to K2 fed K1's
    residuals in both dtypes (in bf16 the recompute is K1's tensor-core
    conv2 and the gradients K2's body), the same bits on a second run, and
    (on the same routing) within K2's tolerance of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    args = _conv_inputs(gen, 4, 32, 28, 32, 64, dtype, cuda, ones)
    x, w1, b1, w2, b2 = args
    pooled, idx = cb.conv_block_fwd_cuda(*args)
    assert torch.equal(cb.conv_stack_fwd_cuda(*args), pooled)
    gy = torch.randn(pooled.shape, generator=gen, device=cuda).to(dtype)
    ops.reset_launch_counts()
    got = cb.conv_stack_bwd_cuda(gy, *args)
    assert cb.ROUTE_LAUNCHES[("conv_stack_bwd", cb.ROUTES[dtype])] == 1
    masked = (gy * (pooled > 0)).to(dtype).contiguous()
    for a, b in zip(got, cb.conv_block_bwd_cuda(masked, idx, x, w1, b1, w2)):
        assert torch.equal(a, b)
    for a, b in zip(got, cb.conv_stack_bwd_cuda(gy, *args)):
        assert torch.equal(a, b)
    refs = [cb.conv_stack_res_bwd_plain(masked, idx, x, w1, b1, w2)]
    # the residual-free plain version finds its own routing: comparable
    # where no near-tie sent it elsewhere than the kernel
    p_ref, i_ref = cb.conv_stack_res_fwd_plain(*args)
    if torch.equal(i_ref, idx) and torch.equal(p_ref > 0, pooled > 0):
        refs.append(cb.conv_stack_bwd_plain(gy, *args))
    for ref in refs:
        for a, b in zip(got, ref):
            if dtype == torch.float32:
                torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
            else:
                assert float((a - b).norm()
                             / b.norm().clamp(min=1e-30)) <= 1e-2


def _assert_pooled_close(got, want, dtype):
    """K1's tolerance: 1e-5 in f32, one bf16 ulp of the larger value plus
    1e-5 in bf16."""
    pk, pr = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(pk, pr, rtol=1e-5, atol=1e-5)
    else:
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.maximum(pk.abs(), pr.abs()).clamp(min=2.0 ** -126))) - 7)
        assert bool(((pk - pr).abs() <= ulp + 1e-5).all())


def _assert_grads_close(got, want, dtype):
    """K2's tolerance: 2e-4 in f32, relative Frobenius 1e-2 in bf16."""
    for a, b in zip(got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
        else:
            assert float((a - b).norm() / b.norm().clamp(min=1e-30)) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_conv_kernels_at_a_second_geometry(cuda, dtype):
    """K1, K2 and K4 at widths that are no multiples of 16 (the bf16
    route pads C1 and C2 to 16 in shared memory) and 5 images a client (a
    block with one image): each held to its plain version with the
    tolerances above, K4 to K1/K2 bit for bit, every launch on its dtype's
    route."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    args = _conv_inputs(gen, 3, 5, 16, 12, 20, dtype, cuda)
    x, w1, b1, w2, b2 = args
    ops.reset_launch_counts()
    pooled, idx = cb.conv_block_fwd_cuda(*args)
    want, want_idx = cb.conv_stack_res_fwd_plain(*args)
    _assert_pooled_close(pooled, want, dtype)
    assert torch.equal(cb.conv_stack_fwd_cuda(*args), pooled)
    # the index differs from the plain version's only at its near-ties
    bad = idx != want_idx
    if bool(bad.any()):
        chosen = cb.pool2_windows_plain(*args).gather(
            -1, idx.long()[..., None])[..., 0]
        pr = want.float()
        tol = (1e-5 * (1 + pr.abs()) if dtype == torch.float32 else
               torch.exp2(torch.floor(torch.log2(
                   pr.abs().clamp(min=2.0 ** -126))) - 7) + 1e-5)
        assert bool(((chosen - pr).abs() <= tol)[bad].all())
    gy = torch.randn(pooled.shape, generator=gen, device=cuda).to(dtype)
    masked = (gy * (want > 0)).to(dtype).contiguous()
    _assert_grads_close(cb.conv_block_bwd_cuda(masked, want_idx, x, w1, b1,
                                               w2),
                        cb.conv_stack_res_bwd_plain(masked, want_idx, x, w1,
                                                    b1, w2), dtype)
    got4 = cb.conv_stack_bwd_cuda(gy, *args)
    own = (gy * (pooled > 0)).to(dtype).contiguous()
    for a, b in zip(got4, cb.conv_block_bwd_cuda(own, idx, x, w1, b1, w2)):
        assert torch.equal(a, b)
    _assert_grads_close(got4, cb.conv_stack_res_bwd_plain(own, idx, x, w1, b1,
                                                          w2), dtype)
    route = cb.ROUTES[dtype]
    assert {k: v for k, v in cb.ROUTE_LAUNCHES.items() if v} == {
        ("conv_block_fwd", route): 1, ("conv_stack_fwd", route): 1,
        ("conv_block_bwd", route): 2, ("conv_stack_bwd", route): 1}
    for kernel in cb.LAUNCHES:
        assert cb.launch_plan(kernel, dtype, 16, 16, 12, 20).smem_bytes == (
            cb.kernel_smem_bytes(kernel, dtype, 16, 16, 12, 20))


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 2, 4, 3])
def test_packed_equals_conv_stack_per_client(cuda, P):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x, *ws = _conv_inputs(gen, P, 8, 28, 32, 64, torch.bfloat16, cuda)
    r = torch.randn((P, 8, 7, 7, 64), generator=gen, device=cuda).bfloat16()
    wp = [t.clone().requires_grad_(True) for t in ws]
    ops.reset_launch_counts()
    out = cb.conv_stack_packed(x, *wp)
    grads = torch.autograd.grad(out, wp, r)
    counts = ops.launch_counts()
    # the entry point has no kernel of its own: K4's two, once each
    want = dict.fromkeys(counts, 0)
    want.update(conv_stack_fwd=1, conv_stack_bwd=1)
    assert counts == want
    for c in range(P):
        wc = [t[c:c + 1].clone().requires_grad_(True) for t in ws]
        out_c = cb.conv_stack(x[c:c + 1], *wc)
        assert torch.equal(out[c:c + 1], out_c)
        for a, b in zip(grads, torch.autograd.grad(out_c, wc, r[c:c + 1])):
            assert torch.equal(a[c:c + 1], b)


@pytest.mark.cuda
def test_conv_stack_refuses_cpu_weights_on_a_cuda_image(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x, w1, b1, w2, b2 = _conv_inputs(gen, 1, 2, 28, 32, 64, torch.float32,
                                     cuda)
    with pytest.raises(ValueError, match="conv_stack_fwd"):
        cb.conv_stack_fwd_cuda(x, w1.cpu(), b1, w2, b2)


def _assert_rounded_close(got, want, dtype, ulps=1):
    a, b = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    else:
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126))) - 7)
        assert bool(((a - b).abs() <= ulps * ulp + 1e-4).all())


def _patch_inputs(gen, C, B, H, W, I, O, dtype, device):
    x = torch.randn((C, B, H, W, I), generator=gen, device=device)
    w = torch.randn((C, 3, 3, I, O), generator=gen, device=device) * 0.1
    g = torch.randn((C, B, H, W, O), generator=gen, device=device)
    return x.to(dtype), w.to(dtype), g.to(dtype)


PATCH_SHAPES = [(2, 14, 14, 32, 64), (2, 8, 8, 16, 16), (1, 28, 28, 4, 8),
                (2, 14, 14, 4, 128), (3, 5, 7, 3, 6), (3, 5, 7, 20, 12),
                (2, 14, 14, 48, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", PATCH_SHAPES, ids=str)
def test_patch_gemm_kernels_match_plain(cuda, dtype, shape):
    """K7 through the op: forward, weight gradient and input gradient, and
    the launches the op makes for them."""
    B, H, W, I, O = shape
    gen = torch.Generator(device=cuda).manual_seed(6)
    x, w, g = _patch_inputs(gen, 3, B, H, W, I, O, dtype, cuda)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    ops.reset_launch_counts()
    y = cp.conv3x3_patch(xr, wr)
    dx, dw = torch.autograd.grad(y, (xr, wr), g)
    counts = ops.launch_counts()
    assert (counts["conv3x3_patch_gemm"], counts["conv3x3_patch_wgrad"]) == (
        2, 1)
    # the dtype alone fixes the route: f32 on the CUDA cores, bf16 on the
    # tensor cores
    mine, other = (("cuda_core", "tensor_core") if dtype == torch.float32
                   else ("tensor_core", "cuda_core"))
    assert cp.ROUTES[dtype] == mine
    assert (cp.ROUTE_LAUNCHES[mine], cp.ROUTE_LAUNCHES[other]) == (3, 0)
    w2 = w.reshape(3, 9 * I, O)
    _assert_rounded_close(y, cp.conv3x3_patch_plain(x, w2), dtype)
    _assert_rounded_close(dx, cp.conv3x3_patch_dgrad_plain(g, w), dtype)
    assert dw.dtype == dtype
    torch.testing.assert_close(
        cp.patch_wgrad_cuda(x, g),
        cp.conv3x3_patch_wgrad_plain(x, g), rtol=1e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_s2d_stem_kernels_match_plain_and_launch_no_input_gradient(cuda,
                                                                   dtype):
    gen = torch.Generator(device=cuda).manual_seed(7)
    C, B = 3, 4
    x = torch.randn((C, B, 28, 28, 1), generator=gen, device=cuda).to(dtype)
    w = (torch.randn((C, 3, 3, 1, 32), generator=gen, device=cuda)
         * 0.3).to(dtype)
    b = (torch.randn((C, 32), generator=gen, device=cuda) * 0.1).to(dtype)
    g = torch.randn((C, B, 14, 14, 32), generator=gen, device=cuda).to(dtype)

    def run(x, w, b, g):
        wr, br = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
        y = cp.conv_stem_s2d(x, wr, br)
        return (y.detach(),) + torch.autograd.grad(y, (wr, br), g)

    ops.reset_launch_counts()
    got = run(x, w, b, g)
    counts = ops.launch_counts()
    # one patch GEMM for the forward and none for an input gradient
    assert (counts["conv3x3_patch_gemm"], counts["conv3x3_patch_wgrad"]) == (
        1, 1)
    want = run(x.cpu(), w.cpu(), b.cpu(), g.cpu())   # the plain versions
    # two roundings after the product (the conv's, then the bias sum's)
    _assert_rounded_close(got[0].cpu(), want[0], dtype, ulps=2)
    for a, ref in zip(got[1:], want[1:]):
        if dtype == torch.float32:
            torch.testing.assert_close(a.cpu(), ref, rtol=1e-4, atol=2e-4)
        else:
            # a one-ulp difference in y can move a bf16 pool window's
            # maximum to another member
            assert float((a.cpu().float() - ref.float()).norm()
                         / ref.float().norm()) <= 2e-2


# K8b's bf16 route at each of PATCH_SHAPES: TMA where I and O are multiples
# of 8 (f32 always takes the CUDA cores)
TAPLOOP_ROUTES = dict(zip(PATCH_SHAPES, (
    "tma", "tma", "cuda_core", "cuda_core", "cuda_core", "cuda_core", "tma")))

# (C, M, K, N) of K8a and the route its plan takes in bf16 (f32 always
# takes the CUDA cores)
GEMM_SHAPES = [((2, 128, 288, 64), "tma"), ((3, 70, 50, 37), "staged"),
               ((2, 8192, 288, 64), "tma"), ((1, 300, 64, 136), "tma"),
               ((3, 200, 40, 8), "tma"), ((2, 33, 20, 12), "staged")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_probe_kernels_match_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(8)
    ops.reset_launch_counts()
    for (C, M, K, N), route in GEMM_SHAPES:
        a = torch.randn((C, M, K), generator=gen, device=cuda).to(dtype)
        b = torch.randn((C, K, N), generator=gen, device=cuda).to(dtype)
        before = dict(probe.ROUTE_LAUNCHES)
        _assert_rounded_close(probe.batched_gemm(a, b),
                              probe.batched_gemm_plain(a, b), dtype)
        want = route if dtype == torch.bfloat16 else "cuda_core"
        assert probe.launch_plan(dtype, C, M, K, N).route == want
        assert {k: v - before[k] for k, v in probe.ROUTE_LAUNCHES.items()
                if v != before[k]} == {want: 1}
    for shape in PATCH_SHAPES:
        x, w, _ = _patch_inputs(gen, 3, *shape, dtype, cuda)
        _assert_rounded_close(probe.taploop_conv(x, w),
                              probe.taploop_conv_plain(x, w), dtype)
        want = TAPLOOP_ROUTES[shape] if dtype == torch.bfloat16 else (
            "cuda_core")
        assert probe.taploop_launch_plan(dtype, 3, *shape).route == want
    counts = ops.launch_counts()
    assert (counts["probe_batched_gemm"], counts["probe_taploop_conv"]) == (
        len(GEMM_SHAPES), len(PATCH_SHAPES))
    took = [TAPLOOP_ROUTES[s] if dtype == torch.bfloat16 else "cuda_core"
            for s in PATCH_SHAPES]
    assert probe.TAPLOOP_ROUTE_LAUNCHES == {
        r: took.count(r) for r in probe.TAPLOOP_ROUTES}


# (C, B, H, W, I, O) of bf16 cases on K8b's TMA route at the edges of its
# design, and the bytes a misaligned view starts past its allocation
TAPLOOP_TMA_CASES = {
    "tile_spans_two_images": ((2, 3, 14, 14, 32, 64), 0),
    "ragged_last_tile": ((3, 3, 5, 7, 16, 8), 0),
    "three_column_passes": ((2, 2, 8, 8, 32, 136), 0),
    "swizzle_128B": ((2, 2, 14, 14, 64, 64), 0),
    "two_boxes_a_pixel": ((2, 2, 8, 8, 96, 32), 0),
    "clients_change_inside_a_block": ((8, 32, 14, 14, 32, 64), 0),
    "ring_of_two_28x28_images": ((4, 8, 28, 28, 32, 64), 0),
    "misaligned_view": ((2, 3, 14, 14, 32, 64), 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TAPLOOP_TMA_CASES))
def test_taploop_tma_route_at_the_design_edges(cuda, case):
    (C, B, H, W, I, O), offset = TAPLOOP_TMA_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(11)
    x, w, _ = _patch_inputs(gen, C, B, H, W, I, O, torch.bfloat16, cuda)
    if offset:
        buf = torch.empty(offset // 2 + x.numel(), dtype=x.dtype,
                          device=cuda)
        buf[offset // 2:] = x.flatten()
        x = buf[offset // 2:].view(x.shape)
        assert x.data_ptr() % 16 == offset
    assert probe.taploop_launch_plan(torch.bfloat16, C, B, H, W, I,
                                     O).route == "tma"
    ops.reset_launch_counts()
    got = probe.taploop_conv(x, w)
    assert probe.TAPLOOP_ROUTE_LAUNCHES == {"tma": 1, "cuda_core": 0}
    _assert_rounded_close(got, probe.taploop_conv_plain(x, w),
                          torch.bfloat16)


def test_aligned16_copies_only_a_view_off_a_16_byte_boundary():
    buf = torch.arange(1 + 2 * 8 * 16, dtype=torch.float32).bfloat16()
    view = buf[1:].view(2, 8, 16)
    assert view.data_ptr() % 16 != 0
    moved = probe._aligned16(view)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, view)
    whole = buf[:-1].view(2, 8, 16)
    assert probe._aligned16(whole) is whole


@pytest.mark.cuda
def test_batched_gemm_takes_a_misaligned_bf16_view(cuda):
    """A bf16 view that starts 2 bytes past its allocation, with K and N
    multiples of 8 (the TMA route): the op copies it and launches."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    C, M, K, N = 2, 128, 288, 64
    buf = torch.empty(1 + C * M * K, dtype=torch.bfloat16, device=cuda)
    buf[1:] = torch.randn(C * M * K, generator=gen, device=cuda)
    a = buf[1:].view(C, M, K)
    b = torch.randn((C, K, N), generator=gen, device=cuda).bfloat16()
    assert a.data_ptr() % 16 != 0
    assert probe.launch_plan(torch.bfloat16, C, M, K, N).route == "tma"
    _assert_rounded_close(probe.batched_gemm(a, b),
                          probe.batched_gemm_plain(a, b), torch.bfloat16)


@pytest.mark.cuda
def test_patch_and_probe_ops_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((1, 1, 4, 4, 2), device=cuda, dtype=torch.float16)
    w = torch.zeros((1, 3, 3, 2, 2), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cp.conv3x3_patch(x, w)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        probe.taploop_conv(x, w)
    with pytest.raises(ValueError, match="probe_batched_gemm"):
        probe.batched_gemm_cuda(torch.zeros((1, 4, 4), device=cuda),
                                torch.zeros((1, 4, 4)))


@pytest.mark.cuda
def test_quantize_kernel_deterministic_mode_is_exact(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((512 * qz.CHUNK,), generator=gen, device=cuda) * 1e-3
    x[:qz.CHUNK] = 0.0                                   # an all-zero block
    # a block of scale exactly 1 whose values are all the multiples of 0.5
    # in [-127, 127]: every other one is an exact half (ties to even)
    x[qz.CHUNK:2 * qz.CHUNK] = (torch.arange(qz.CHUNK, device=cuda) % 509
                                - 254).float() * 0.5
    q, s = qz.quantize_int8_blocks(x, 3, stochastic=False)
    q_ref, s_ref = qz.quantize_int8_blocks_plain(x, 3, stochastic=False)
    assert q.dtype == torch.int8 and torch.equal(s, s_ref)
    assert torch.equal(q, q_ref)
    err = (qz.dequantize_int8_blocks(q, s) - x).reshape(512, -1).abs().amax(1)
    # half a step, with room for the rounding of x * (1 / scale)
    assert bool((err <= s * 0.501).all())


@pytest.mark.cuda
def test_quantize_kernel_stochastic_mode(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((1 << 22,), generator=gen, device=cuda)
    ops.reset_launch_counts()
    q, s = qz.quantize_int8(x, seed=11)
    assert ops.launch_counts()["quantize_int8_blocks"] == 1
    scaled = (x.reshape(-1, qz.CHUNK) * (1.0 / s)[:, None]).reshape(-1)
    lo, qf = torch.floor(scaled), q.float()
    assert bool(((qf == lo.clamp(-128, 127))
                 | (qf == (lo + 1).clamp(-128, 127))).all())
    # 4M draws: the mean error is 0 to 4 standard errors (1e-3), and
    # P(ceil) follows the fractional part in every decile to 0.01
    assert abs(float((qf.double() - scaled.double()).mean())) <= 1e-3
    frac, up = scaled - lo, qf > lo
    for b in range(10):
        sel = (frac >= b / 10) & (frac < (b + 1) / 10)
        assert abs(float(up[sel].float().mean())
                   - float(frac[sel].mean())) <= 0.01
    assert torch.equal(q, qz.quantize_int8(x, seed=11)[0])
    assert not torch.equal(q, qz.quantize_int8(x, seed=12)[0])


@pytest.mark.cuda
def test_clip_noise_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    C, D = 4, 1 << 20
    x = torch.randn((C, D), generator=g, device=cuda)
    scale = torch.rand((C,), generator=g, device=cuda)
    seeds = torch.as_tensor(prng.as_int64(prng.client_stream_seeds(
        1, C, prng.Stream.DP_NOISE))).to(cuda)
    zero = torch.zeros(C, device=cuda)
    torch.testing.assert_close(dpo.clip_noise(x, scale, zero, seeds),
                               x * scale[:, None], rtol=1e-6, atol=0.0)
    z = dpo.clip_noise(torch.zeros_like(x), zero, torch.ones(C, device=cuda),
                       seeds).double()
    flat = z.flatten()
    # 4M draws: mean 3e-3 (6 se), variance 1%, 3σ tail 0.27% ± 0.05%,
    # correlation between clients 5e-3 (5 se at 1M)
    assert abs(float(flat.mean())) <= 3e-3
    assert abs(float(flat.var()) - 1.0) <= 0.01
    assert abs(float((flat.abs() > 3).double().mean()) - 0.0027) <= 5e-4
    assert abs(float(torch.corrcoef(z[:2])[0, 1])) <= 5e-3


@pytest.mark.cuda
def test_clip_noise_matrix_runs_k3_on_the_card(cuda):
    """The DP host API's (C, D) entry (``ops.dp.clip_noise_matrix``) at
    the privacy validator's (4, 65,536) shape, row i scaled by 10^i so
    that rows 1-3 lie above the clip norm: K3 by default and with
    ``use_pallas=True`` (one launch each), the plain version only with
    ``use_pallas=False``; bit-equal to it at σ = 0 (ε = inf), clipped
    rows included; the noise's std within 2% of σ (the one-client tree
    release goes through it too)."""
    from fl_tpu_torch.fl import privacy as tdp

    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((4, 65_536), generator=g, device=cuda) * 1e-3
    x *= 10.0 ** torch.arange(4, device=cuda)[:, None]
    norms = x.square().sum(1).sqrt()
    clipped = x * torch.clamp(1.0 / norms, max=1.0)[:, None]
    assert int((norms > 1.0).sum()) == 3
    seeds = [3, 4, 5, 6]
    ops.reset_launch_counts()
    got, sens, sig = dpo.clip_noise_matrix(x, seeds, float("inf"), 1e-5, 1.0)
    want, _, _ = dpo.clip_noise_matrix(x, seeds, float("inf"), 1e-5, 1.0,
                                       use_pallas=False)
    assert ops.launch_counts()["clip_noise"] == 1
    assert torch.equal(got, want) and float(sig.abs().max()) == 0.0
    torch.testing.assert_close(got, clipped, rtol=0, atol=1e-6)
    noisy, sens, sig = dpo.clip_noise_matrix(x, seeds, 1.0, 1e-5, 1.0,
                                             use_pallas=True)
    assert ops.launch_counts()["clip_noise"] == 2
    assert torch.all(((noisy - clipped).std(1) / sig - 1).abs() < 0.02)
    tree = {"a": {"w": x[0].reshape(256, 256)}, "b": x[1, :10]}
    released, norm, sigma = tdp.clip_and_noise_tree(tree, 9, 1.0, 1e-5, 1.0)
    assert ops.launch_counts()["clip_noise"] == 3
    assert released["a"]["w"].shape == (256, 256)
    assert float(sigma) == pytest.approx(
        float(norm) * tdp.gaussian_sigma(1.0, 1.0, 1e-5), rel=1e-6)


@pytest.mark.cuda
def test_privacy_engine_releases_numpy_gradients_through_k3(cuda):
    """``create_privacy_engine().add_noise`` on numpy gradients puts them
    on the card (the facades' default device) and releases them through
    K3: one launch, clipped to C = 1, noised at the clipped norm's σ."""
    from fl_tpu_torch.fl import privacy as tdp

    grads = {"w": np.full((4096,), 0.05, np.float32),
             "b": np.zeros((10,), np.float32)}
    eng = tdp.create_privacy_engine(2.0, 1e-5, seed=0)
    ops.reset_launch_counts()
    noisy = eng.add_noise(grads, 0.5, 1e-6)
    assert ops.launch_counts()["clip_noise"] == 1
    assert all(t.is_cuda for t in noisy.values())
    sigma = tdp.gaussian_sigma(1.0, 0.5, 1e-6)
    resid = noisy["w"].cpu() - 0.05 / np.sqrt(4096 * 0.05 ** 2)
    assert float(resid.std()) == pytest.approx(sigma, rel=0.05)


def _corr(a, b):
    return float(torch.corrcoef(torch.stack([a.flatten(), b.flatten()]))[0, 1])


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 3, 4097, 20234])
def test_clip_noise_kernel_is_the_philox_oracle(cuda, D):
    seeds = prng.as_int64(prng.client_stream_seeds(5, 3, prng.Stream.DP_NOISE,
                                                   1))
    z = dpo.clip_noise(torch.zeros((3, D), device=cuda),
                       torch.zeros(3, device=cuda), torch.ones(3, device=cuda),
                       torch.as_tensor(seeds).to(cuda)).cpu().numpy()
    counter, word = (t.numpy() for t in dpo.noise_layout(D))
    for c in range(3):
        np.testing.assert_allclose(
            z[c], oracle.box_muller(seeds[c], counter, word), rtol=0,
            atol=1e-5)


@pytest.mark.cuda
def test_clip_noise_kernel_pairs_and_normality(cuda):
    """4M draws: the cosine and sine of one radius, and the two pairs of one
    call, uncorrelated in z and z² (2M pairs, 5e-3 = 7 standard errors);
    Kolmogorov–Smirnov distance from N(0, 1) under its critical value at
    significance 1e-3."""
    C, D = 4, 1 << 20
    seeds = torch.as_tensor(prng.as_int64(prng.client_stream_seeds(
        2, C, prng.Stream.DP_NOISE))).to(cuda)
    z = dpo.clip_noise(torch.zeros((C, D), device=cuda),
                       torch.zeros(C, device=cuda), torch.ones(C, device=cuda),
                       seeds).double()
    w = z[:, torch.as_tensor(oracle.word_index(*dpo.noise_layout(D)))
          .to(cuda)]
    for p in (1, 2):
        assert abs(_corr(torch.cat([w[:, 0], w[:, 2]]) ** p,
                         torch.cat([w[:, 1], w[:, 3]]) ** p)) <= 5e-3
        assert abs(_corr(torch.cat([w[:, 0], w[:, 1]]) ** p,
                         torch.cat([w[:, 2], w[:, 3]]) ** p)) <= 5e-3
    ks, critical = oracle.ks_normal(z)
    assert ks <= critical


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks", [1, 3])
def test_quantize_kernel_is_the_philox_oracle(cuda, n_blocks):
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((n_blocks * qz.CHUNK,), generator=gen, device=cuda)
    q, s = qz.quantize_int8_blocks(x, 21)
    xn, sn = x.cpu().numpy(), s.cpu().numpy()
    scaled = (xn.reshape(n_blocks, -1)
              * (np.float32(1) / sn)[:, None]).reshape(-1)
    lo = np.floor(scaled)
    u = oracle.uniforms(21, *(t.numpy() for t in qz.rounding_layout(
        n_blocks)))
    want = np.clip(lo + (u < scaled - lo), -128, 127).astype(np.int8)
    np.testing.assert_array_equal(q.cpu().numpy(), want)


@pytest.mark.cuda
def test_quantize_kernel_quarters_are_uncorrelated(cuda):
    """The four values one Philox call rounds: their decisions less their
    expectations do not correlate (1M per quarter, 5e-3 = 5 standard
    errors)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((1 << 22,), generator=gen, device=cuda)
    q, s = qz.quantize_int8_blocks(x, 13)
    scaled = (x.reshape(-1, qz.CHUNK) * (1.0 / s)[:, None]).reshape(-1)
    lo = torch.floor(scaled)
    e = ((q.float() > lo).double() - (scaled - lo).double())[torch.as_tensor(
        oracle.word_index(*qz.rounding_layout(x.numel() // qz.CHUNK)))
        .to(cuda)]
    for a in range(4):
        for b in range(a + 1, 4):
            assert abs(_corr(e[a], e[b])) <= 5e-3


@pytest.mark.cuda
def test_dp_noise_client_deltas_through_the_kernel(cuda):
    """Delta DP at ε = 5 on SimpleCNN's real leaves for 8 clients, through
    K3 (one launch per leaf group): sensitivity and σ from the clipped
    norm; the residual (noisy − Δ·scale)/σ N(0, 1) per leaf and per client
    at 5 standard errors; no correlation across the two leaf groups."""
    from fl_tpu_torch.fl import privacy
    from fl_tpu_torch.models import create_model

    C, eps, delta = 8, 5.0, 1e-5
    gen = torch.Generator(device=cuda).manual_seed(8)
    mult = torch.logspace(-4, -2, C, device=cuda)
    tree = {l: {k: torch.randn((C,) + s, generator=gen, device=cuda)
                * mult.reshape((C,) + (1,) * len(s))
                for k, s in leaves.items()}
            for l, leaves in create_model("simple_cnn").param_shapes().items()}
    ops.reset_launch_counts()
    noisy, sens, sigma = privacy.dp_noise_client_deltas(
        tree, prng.round_seed(prng.root_seed(0), 0), eps, delta, 1.0)
    assert ops.launch_counts()["clip_noise"] == 2
    norm = privacy.client_norms(tree)
    scale = torch.clamp(1.0 / norm, max=1.0)
    assert bool((scale < 1).any()) and bool((scale == 1).any())
    torch.testing.assert_close(sens, torch.clamp(norm, max=1.0), rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(sigma, sens * dpo.gaussian_factor(eps, delta),
                               rtol=1e-6, atol=0)
    res = {}
    for l in tree:
        for k, t in tree[l].items():
            shape = (C,) + (1,) * (t.dim() - 1)
            res[(l, k)] = ((noisy[l][k].double() - t.double()
                            * scale.double().reshape(shape))
                           / sigma.double().reshape(shape)).reshape(C, -1)
    for what, z in list(res.items()) + [
            (f"client {c}", torch.cat([r[c] for r in res.values()]))
            for c in range(C)]:
        n = z.numel()
        assert abs(float(z.mean())) < 5 / n ** 0.5, what
        assert abs(float(z.var()) - 1) < 5 * (2 / n) ** 0.5, what
    groups = privacy.leaf_groups(tree)
    small = torch.cat([res[p] for p in groups[1]], 1)
    big = res[groups[0][0]][:, :small.shape[1]]
    assert abs(_corr(big, small)) < 5 / small.numel() ** 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("fused, conv_counts", [
    ("residual", ("conv_block_fwd", "conv_block_bwd")),
    (True, ("conv_stack_fwd", "conv_stack_bwd")),
    (False, ()),
], ids=["residual", "fused", "unfused"])
def test_engine_round_runs_through_the_kernels(cuda, fused, conv_counts):
    from fl_tpu_torch.core.types import PrivacyConfig
    from fl_tpu_torch.data import load_dataset, make_federated_arrays
    from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
    from fl_tpu_torch.models import create_model
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    arr = make_federated_arrays(load_dataset("mnist", n_train_synth=256,
                                             n_test_synth=64), 4, "iid",
                                samples_per_client=32)
    eng = FederatedRoundEngine(
        create_model("simple_cnn", dtype=torch.bfloat16,
                     fused_conv_block=fused), arr,
        RoundEngineConfig(
            training=FederatedTrainingConfig(local_epochs=2, batch_size=16),
            dp_mode="delta", privacy=PrivacyConfig(epsilon=8.0, delta=1e-5),
            epsilon_per_round=1.0, delta_per_round=1e-7), device=cuda)
    ops.reset_launch_counts()
    res = eng.run_rounds_pipelined(2)
    want = dict.fromkeys(ops.launch_counts(), 0)
    want.update(dict.fromkeys(conv_counts, 8), clip_noise=4)
    assert ops.launch_counts() == want
    assert all(torch.isfinite(torch.tensor(r.train_loss)) for r in res)


# ---------------------------------------------------------------------------
# plain functions of the slice's device path
# ---------------------------------------------------------------------------

def _krum_matrix(device):
    gen = torch.Generator().manual_seed(12)
    # a common part much larger than the spread: sq_i + sq_j − 2<x_i, x_j>
    # cancels, which TF32's 10-bit products would not survive; row i's
    # spread grows with i, so the Krum scores stand apart by more than
    # the f32 cancellation error
    spread = 0.01 * (1.0 + torch.arange(48.0) / 4.0)[:, None]
    mat = 1.0 + spread * torch.randn((48, 4096), generator=gen)
    return mat.to(device)


def test_krum_gram_product_leaves_the_tf32_switch_as_it_was():
    from fl_tpu_torch.fl import robust_agg as ra

    before = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            ra.pairwise_sq_distances(_krum_matrix("cpu"))
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.cuda
def test_krum_gram_product_is_off_tf32(cuda):
    from fl_tpu_torch.fl import robust_agg as ra

    mat = _krum_matrix(cuda)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        on = ra.pairwise_sq_distances(mat)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(on, ra.pairwise_sq_distances(mat))
    m64 = mat.double()
    want = ((m64[:, None] - m64[None]) ** 2).sum(-1)
    torch.testing.assert_close(on.double(), want, rtol=0, atol=2e-2)
    # the selection is the one f64 scores make
    d2 = want.clone()
    d2.fill_diagonal_(float("inf"))
    scores = torch.sort(d2, 1).values[:, :48 - 1 - 2].sum(1)
    picked = ra.krum_select(mat, torch.ones(48, device=cuda), 1, 8)
    assert picked.tolist() == torch.argsort(scores)[:8].tolist()


@pytest.mark.cuda
def test_stacked_rounding_on_the_card_equals_the_cpu(cuda):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((6, 3, 1001), generator=gen) * 10.0 ** torch.randint(
        -30, 30, (6, 3, 1001), generator=gen).float()
    x.view(-1)[:5] = torch.tensor([float("nan"), float("inf"),
                                   -float("inf"), -0.0, 3.0e38])
    seeds = torch.randint(0, 1 << 32, (6,), generator=gen, dtype=torch.int64)
    cpu = rounding.stochastic_round_bf16(x, seeds)
    card = rounding.stochastic_round_bf16(x.to(cuda), seeds.to(cuda))
    assert torch.equal(card.cpu().view(torch.int16), cpu.view(torch.int16))
    one = rounding.stochastic_round_bf16(x[0].to(cuda), int(seeds[0]))
    assert torch.equal(one.cpu().view(torch.int16), card[0].cpu().view(
        torch.int16))


@pytest.mark.cuda
def test_dp_sgd_noise_through_k3_is_keyed_by_global_client(cuda):
    """DP-SGD's noise on the card (K3 at scale 1/B): the halves of the
    client axis, each with its first global client id, draw the whole
    axis's noise bit for bit."""
    from fl_tpu_torch.fl import privacy as tdp

    gen = torch.Generator(device=cuda).manual_seed(5)
    tree = {"w": {"kernel": torch.randn((4, 3000, 7), generator=gen,
                                        device=cuda)}}
    ops.reset_launch_counts()
    whole = tdp._noisy_mean(tree, 8, 0.3, 21)["w"]["kernel"]
    parts = torch.cat([tdp._noisy_mean(
        {"w": {"kernel": tree["w"]["kernel"][lo:lo + 2]}}, 8, 0.3, 21,
        first=lo)["w"]["kernel"] for lo in (0, 2)])
    assert ops.launch_counts()["clip_noise"] == 3
    assert torch.equal(whole, parts)


@pytest.mark.cuda
def test_one_nccl_rank_is_the_unsharded_round(cuda):
    """One NCCL rank (``core.mesh.make_mesh()``) runs the unsharded round's
    code with the identity sum: the bench configuration at 16 clients
    (bf16 ``"residual"``, delta DP: K1, K2, K3) gives the same weights bit
    for bit after a round and two pipelined ones, with two all-reduces a
    round."""
    import torch.distributed as dist

    import torch_mesh_jobs as jobs
    from fl_tpu_torch.core.mesh import make_mesh
    from fl_tpu_torch.models import create_model
    from fl_tpu_torch.orchestration import FederatedRoundEngine

    cfg = jobs.inventory_config()
    arrays = jobs.arrays(jobs.JAX_CLIENTS)

    def model():
        return create_model("simple_cnn", dtype=torch.bfloat16,
                            fused_conv_block="residual")

    plain = FederatedRoundEngine(model(), arrays, cfg, device="cuda")
    mesh = make_mesh()
    try:
        sharded = FederatedRoundEngine(model(), arrays, cfg, mesh=mesh)
        for engine in (plain, sharded):
            engine.run_round(evaluate=False)
            engine.run_rounds_pipelined(2)
        kinds = [c.kind for c in sharded.round_collectives]
    finally:
        dist.destroy_process_group()
    assert kinds == ["all_reduce", "all_reduce"]
    want = plain.get_model_weights()
    for k, v in sharded.get_model_weights().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.cuda
def test_k3_launch_count_is_exact_under_threads(cuda):
    """The deployment round's client threads launch K3 concurrently: 12
    threads x 40 launches, a 1 µs switch interval, count exactly 480."""
    import sys
    import threading

    x = torch.randn((1, 4096), device=cuda)
    dpo.clip_noise_matrix(x, [1], 1.0, 1e-5, 1.0)  # compiled before
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda i=i: [
            dpo.clip_noise_matrix(x, [i], 1.0, 1e-5, 1.0)
            for _ in range(40)]) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    assert ops.launch_counts()["clip_noise"] == 480


@pytest.mark.cuda
def test_client_fsm_release_runs_k3_once_a_round(cuda):
    """``FederatedTrainer._run_one_round`` on the card with an in-process
    client: one K3 launch (the (1, 421,642) release) and nothing else, an
    upload of numpy arrays, ε charged once."""
    from fl_tpu_torch.core.types import GlobalModel, PrivacyConfig, RoundConfig
    from fl_tpu_torch.models import create_model, init_variables
    from fl_tpu_torch.models.factory import get_model_weights
    from fl_tpu_torch.services.federated_trainer import FederatedTrainer

    init = {k: v.cpu().numpy() for k, v in get_model_weights(
        init_variables(create_model("simple_cnn"), seed=0)).items()}
    sent = []

    class Client:
        def join_training_round(self, r):
            return RoundConfig(round_number=r, local_epochs=1, batch_size=32)

        def get_global_model(self, r):
            return GlobalModel(r, dict(init))

        def submit_model_update(self, update):
            sent.append(update)
            return {"success": True, "message": "ok"}

    t = FederatedTrainer("card", privacy=PrivacyConfig(1.0, 1e-5),
                         n_train_synth=1024, n_test_synth=64, num_clients=4,
                         device=cuda)
    t.initialize()
    t.client = Client()
    ops.reset_launch_counts()
    t._run_one_round(0)
    got = ops.launch_counts()
    assert got["clip_noise"] == 1
    assert sum(got.values()) == 1
    assert all(isinstance(v, np.ndarray) and np.isfinite(v).all()
               for v in sent[0].model_weights.values())
    assert t.budget_tracker.consumed_epsilon == pytest.approx(1.0)
