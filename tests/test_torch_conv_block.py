"""fl_tpu_torch.ops.conv_block vs fl_tpu.ops.conv_block.conv_stack_res.

The same numpy inputs go through the JAX op (its Pallas kernels run in
interpret mode on the CPU) vmapped over clients, and through the port's
op, which on a CPU tensor takes its plain PyTorch version. Tolerances are
the reference's own for the fused segment in f32 (tests/test_conv_block.py):
forward 1e-5, gradients 2e-4 — the two sides accumulate f32 sums in
different orders. The kernels themselves (CUDA tensors) are held to the
plain version in tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl_tpu.ops.conv_block import conv_stack_res as jax_conv_stack_res
from fl_tpu_torch.ops import conv_block as cb
from fl_tpu_torch.ops import launch_counts, reset_launch_counts


def _inputs(seed, C, B, H, C1, C2, ones=False):
    rng = np.random.default_rng(seed)
    x = (np.ones((C, B, H, H, 1), np.float32) if ones
         else rng.standard_normal((C, B, H, H, 1)).astype(np.float32))
    w1 = (rng.standard_normal((C, 3, 3, 1, C1)) * 0.5).astype(np.float32)
    b1 = (rng.standard_normal((C, C1)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((C, 3, 3, C1, C2)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal((C, C2)) * 0.1).astype(np.float32)
    r = rng.standard_normal((C, B, H // 4, H // 4, C2)).astype(np.float32)
    return x, (w1, b1, w2, b2), r


def _jax_side(x, params, r):
    def loss(p):
        out = jax.vmap(jax_conv_stack_res)(jnp.asarray(x), *p)
        return jnp.sum(out * r), out

    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(
        tuple(map(jnp.asarray, params)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_side(x, params, r):
    tp = [torch.tensor(a, requires_grad=True) for a in params]
    out = cb.conv_stack_res(torch.tensor(x), *tp)
    grads = torch.autograd.grad((out * torch.tensor(r)).sum(), tp)
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("case", [
    # (seed, C, B, H, C1, C2, all-ties image): the bench widths, the
    # 16x16 geometry, and a constant image that ties every pool window
    (0, 2, 2, 28, 32, 64, False),
    (1, 2, 2, 16, 8, 16, False),
    (2, 2, 2, 28, 32, 64, True),
], ids=["28x28_c32_c64", "16x16_c8_c16", "all_ties"])
def test_matches_jax_f32(case):
    seed, C, B, H, C1, C2, ones = case
    x, params, r = _inputs(seed, C, B, H, C1, C2, ones)
    want_out, want_grads = _jax_side(x, params, r)
    got_out, got_grads = _torch_side(x, params, r)
    assert got_out.shape == (C, B, H // 4, H // 4, C2)
    # forward to 1e-5 (f32 accumulation order differs)
    np.testing.assert_allclose(got_out, want_out, rtol=1e-5, atol=1e-5)
    for name, got, want in zip(("dw1", "db1", "dw2", "db2"), got_grads,
                               want_grads):
        # gradients to 2e-4, as the reference's own fused-segment tests
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_clients_are_independent():
    """Client c's output depends only on client c's weights: the stacked
    op equals running each client alone (exactly — same plain math)."""
    x, params, _ = _inputs(3, 3, 2, 16, 8, 16)
    full = cb.conv_stack_res(torch.tensor(x), *map(torch.tensor, params))
    for c in range(3):
        one = cb.conv_stack_res(torch.tensor(x[c:c + 1]),
                                *(torch.tensor(p[c:c + 1]) for p in params))
        assert torch.equal(full[c:c + 1], one)


def test_bf16_entry_casts_and_f32_grads():
    """bf16 compute: the output is bf16 and equals the plain version fed
    the bf16-rounded weights; weight grads come back f32 (the reference's
    custom VJP returns f32 cotangents for bf16 primals)."""
    x, params, r = _inputs(4, 2, 2, 16, 8, 16)
    tp = [torch.tensor(a, requires_grad=True) for a in params]
    xb = torch.tensor(x).bfloat16()
    out = cb.conv_stack_res(xb, *tp)
    assert out.dtype == torch.bfloat16
    want, _ = cb.conv_stack_res_plain(xb, *map(torch.tensor, params))
    assert torch.equal(out, want)
    grads = torch.autograd.grad((out.float() * torch.tensor(r)).sum(), tp)
    assert all(g.dtype == torch.float32 for g in grads)


def test_pool_index_is_first_match():
    x = np.zeros((1, 1, 4, 4, 1), np.float32)
    w1 = np.zeros((1, 3, 3, 1, 1), np.float32)
    b1 = np.ones((1, 1), np.float32)    # y1 == 1 everywhere: all tied
    w2 = np.zeros((1, 3, 3, 1, 1), np.float32)
    b2 = np.ones((1, 1), np.float32)
    pooled, idx = cb.conv_stack_res_plain(
        *map(torch.tensor, (x, w1, b1, w2, b2)))
    assert pooled.item() == 1.0 and idx.item() == 0


def test_cpu_tensors_take_the_plain_version():
    reset_launch_counts()
    x, params, r = _inputs(5, 1, 1, 16, 8, 16)
    tp = [torch.tensor(a, requires_grad=True) for a in params]
    out = cb.conv_stack_res(torch.tensor(x), *tp)
    torch.autograd.grad((out * torch.tensor(r)).sum(), tp)
    assert launch_counts()["conv_block_fwd"] == 0
    assert launch_counts()["conv_block_bwd"] == 0


@pytest.mark.parametrize("bad", ["odd_side", "two_channels", "w2_width"])
def test_rejects_bad_shapes(bad):
    x, (w1, b1, w2, b2), _ = _inputs(6, 1, 1, 16, 8, 16)
    if bad == "odd_side":
        x = x[:, :, :15, :15]
    elif bad == "two_channels":
        x = np.concatenate([x, x], -1)
    else:
        w2 = w2[..., :1, :]
    with pytest.raises(ValueError):
        cb.conv_stack_res(*map(torch.tensor, (x, w1, b1, w2, b2)))
