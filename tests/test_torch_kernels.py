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
sum in different orders); K3 at σ=0 exactly x·scale to 1e-6 relative, and
its noise by moments at about 6 standard errors; K4 the tolerances of K1/K2
against its plain version and bit-equality against K1/K2 (the same device
functions); K5 bit-equal to ``conv_stack`` per client; K6 equal to its
plain version exactly in the deterministic mode (q and scales) and by
floor/ceil, mean and P(ceil) in the stochastic mode.
"""

import pytest
import torch

from fl_tpu_torch import ops
from fl_tpu_torch.core import prng
from fl_tpu_torch.ops import _build
from fl_tpu_torch.ops import conv_block as cb
from fl_tpu_torch.ops import dp as dpo
from fl_tpu_torch.ops import quantize as qz


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
    assert [p.name for p in _build.sources()] == ["conv_block.cu"]


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
@pytest.mark.parametrize("ones", [False, True], ids=["random", "all_ties"])
def test_residual_free_kernels_equal_k1_k2_and_match_plain(cuda, dtype, ones):
    """K4 computes K1/K2's function with no residual: bit-equal to them on
    the same inputs, and (on the same routing) within K2's tolerance of the
    plain version."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    args = _conv_inputs(gen, 4, 32, 28, 32, 64, dtype, cuda, ones)
    x, w1, b1, w2, b2 = args
    pooled, idx = cb.conv_block_fwd_cuda(*args)
    assert torch.equal(cb.conv_stack_fwd_cuda(*args), pooled)
    gy = torch.randn(pooled.shape, generator=gen, device=cuda).to(dtype)
    got = cb.conv_stack_bwd_cuda(gy, *args)
    masked = (gy * (pooled > 0)).to(dtype).contiguous()
    for a, b in zip(got, cb.conv_block_bwd_cuda(masked, idx, x, w1, b1, w2)):
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
