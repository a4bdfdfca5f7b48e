"""fl_tpu_torch.ops.conv_block vs fl_tpu.ops.conv_block: conv_stack_res,
conv_stack and conv_stack_packed.

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

from fl_tpu.ops import conv_block as jcb
from fl_tpu_torch.ops import conv_block as cb
from fl_tpu_torch.ops import launch_counts, reset_launch_counts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _jax_side(x, params, r, op="conv_stack_res"):
    fn = (jcb.conv_stack_packed if op == "conv_stack_packed"
          else jax.vmap(getattr(jcb, op)))

    def loss(p):
        out = fn(jnp.asarray(x), *p)
        return jnp.sum(out * r), out

    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(
        tuple(map(jnp.asarray, params)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_side(x, params, r, op="conv_stack_res"):
    tp = [torch.tensor(a, requires_grad=True) for a in params]
    out = getattr(cb, op)(torch.tensor(x), *tp)
    grads = torch.autograd.grad((out * torch.tensor(r)).sum(), tp)
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("case", [
    # (seed, C, B, H, C1, C2, all-ties image): the bench widths, the
    # 16x16 geometry, and a constant image that ties every pool window
    (0, 2, 2, 28, 32, 64, False),
    (1, 2, 2, 16, 8, 16, False),
    (2, 2, 2, 28, 32, 64, True),
], ids=["28x28_c32_c64", "16x16_c8_c16", "all_ties"])
@pytest.mark.parametrize("op", ["conv_stack_res", "conv_stack"])
def test_matches_jax_f32(op, case):
    seed, C, B, H, C1, C2, ones = case
    x, params, r = _inputs(seed, C, B, H, C1, C2, ones)
    want_out, want_grads = _jax_side(x, params, r, op)
    got_out, got_grads = _torch_side(x, params, r, op)
    assert got_out.shape == (C, B, H // 4, H // 4, C2)
    # forward to 1e-5 (f32 accumulation order differs)
    np.testing.assert_allclose(got_out, want_out, rtol=1e-5, atol=1e-5)
    for name, got, want in zip(("dw1", "db1", "dw2", "db2"), got_grads,
                               want_grads):
        # gradients to 2e-4, as the reference's own fused-segment tests
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_packed_matches_jax_f32():
    """conv_stack_packed at P = 2 against the reference's packed op."""
    x, params, r = _inputs(7, 2, 2, 28, 32, 64)
    want_out, want_grads = _jax_side(x, params, r, "conv_stack_packed")
    got_out, got_grads = _torch_side(x, params, r, "conv_stack_packed")
    np.testing.assert_allclose(got_out, want_out, rtol=1e-5, atol=1e-5)
    for name, got, want in zip(("dw1", "db1", "dw2", "db2"), got_grads,
                               want_grads):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_packed_equals_conv_stack_bit_for_bit(P):
    """The packed entry point is conv_stack over the P axis: bit-equal on
    the stacked inputs, values and gradients, and per client bit-equal in
    the forward. Per-client gradients here go through the plain version's
    library convolutions, whose f32 sums depend on the group count, so they
    are held to 1e-5; the kernels are held bit for bit per client on the
    card (tests/test_torch_kernels.py)."""
    x, params, r = _inputs(8 + P, P, 2, 16, 8, 16)
    out_p, grads_p = _torch_side(x, params, r, "conv_stack_packed")
    out_s, grads_s = _torch_side(x, params, r, "conv_stack")
    assert np.array_equal(out_p, out_s)
    assert all(np.array_equal(a, b) for a, b in zip(grads_p, grads_s))
    for c in range(P):
        out_c, grads_c = _torch_side(x[c:c + 1], [p[c:c + 1] for p in params],
                                     r[c:c + 1], "conv_stack")
        assert np.array_equal(out_p[c:c + 1], out_c)
        for a, b in zip(grads_p, grads_c):
            np.testing.assert_allclose(a[c:c + 1], b, rtol=1e-5, atol=1e-5)


def test_conv_stack_saves_no_pooled_and_no_index():
    """Residual-free: the backward gets the image and the four weights in
    the compute dtype (biases f32), nothing shaped like the output."""
    x, params, _ = _inputs(9, 2, 2, 16, 8, 16)
    tp = [torch.tensor(a, requires_grad=True) for a in params]
    xb = torch.tensor(x).bfloat16()
    out = cb.conv_stack(xb, *tp)
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == \
        [tuple(xb.shape)] + [tuple(p.shape) for p in params]
    assert [t.dtype for t in saved] == [
        torch.bfloat16, torch.bfloat16, torch.float32, torch.bfloat16,
        torch.float32]
    assert all(t.shape != out.shape and t.dtype != torch.uint8
               for t in saved)
    res = cb.conv_stack_res(xb, *tp)
    assert len(res.grad_fn.saved_tensors) == 6   # ... + pooled, idx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ones", [False, True], ids=["random", "all_ties"])
def test_conv_stack_equals_conv_stack_res(dtype, ones):
    """Same values and the same first-match routing: with the plain
    versions the two formulations agree bit for bit, ties included."""
    x, params, r = _inputs(10, 2, 2, 16, 8, 16, ones)
    outs = []
    for op in (cb.conv_stack, cb.conv_stack_res):
        tp = [torch.tensor(a, requires_grad=True) for a in params]
        out = op(torch.tensor(x).to(dtype), *tp)
        grads = torch.autograd.grad((out.float() * torch.tensor(r)).sum(),
                                    tp)
        outs.append((out, grads))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


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
    out = cb.conv_stack_packed(torch.tensor(x), *tp)
    torch.autograd.grad((out * torch.tensor(r)).sum(), tp)
    assert set(launch_counts().values()) == {0}


@pytest.mark.parametrize("op", ["conv_stack_res", "conv_stack",
                                "conv_stack_packed"])
@pytest.mark.parametrize("bad", ["odd_side", "two_channels", "w2_width"])
def test_rejects_bad_shapes(bad, op):
    x, (w1, b1, w2, b2), _ = _inputs(6, 1, 1, 16, 8, 16)
    if bad == "odd_side":
        x = x[:, :, :15, :15]
    elif bad == "two_channels":
        x = np.concatenate([x, x], -1)
    else:
        w2 = w2[..., :1, :]
    with pytest.raises(ValueError):
        getattr(cb, op)(*map(torch.tensor, (x, w1, b1, w2, b2)))


def test_packed_rejects_unstacked_and_mismatched_clients():
    x, (w1, b1, w2, b2), _ = _inputs(6, 2, 1, 16, 8, 16)
    t = torch.tensor
    with pytest.raises(ValueError, match="conv_stack_packed"):
        cb.conv_stack_packed(t(x[0]), t(w1[0]), t(b1[0]), t(w2[0]), t(b2[0]))
    with pytest.raises(ValueError, match="conv_stack_packed"):
        cb.conv_stack_packed(t(x), t(w1[:1]), t(b1), t(w2), t(b2))
