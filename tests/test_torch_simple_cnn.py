"""fl_tpu_torch SimpleCNN vs flax SimpleCNN, for each of the three values
of ``fused_conv_block`` (False: the unfused chain, True: conv_stack,
"residual": conv_stack_res) against the flax model built with the same one.

The flax parameters are carried into the port with ``params_from_flax``;
both sides see the same numpy images. In f32 the logits agree to 1e-5 and
the parameter gradients of the mean cross-entropy to 2e-4 (the fused
segment's f32 tolerances; the dense layers are plain GEMMs on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fl_tpu.models import create_model as jax_create_model
from fl_tpu_torch.fl.local_training import cross_entropy_loss
from fl_tpu_torch.models import (count_params, create_model,
                                 get_model_for_dataset, params_from_flax,
                                 params_to_flax)

FORMULATIONS = [False, True, "residual"]


@pytest.fixture(scope="module")
def flax_side():
    """Two clients' flax params (the flax init, and a perturbed copy with
    non-zero biases), images and labels."""
    # the unfused model declares the same tree and initializers as the
    # fused ones, and initializes without tracing the Pallas segment
    p0 = jax.device_get(jax_create_model("simple_cnn").init(
        jax.random.PRNGKey(0))["params"])
    rng = np.random.default_rng(0)
    p1 = jax.tree.map(lambda a: (a * 1.1 + 0.02 * rng.standard_normal(
        a.shape)).astype(np.float32), p0)
    stacked = jax.tree.map(lambda *a: np.stack(a), p0, p1)
    x = rng.standard_normal((2, 2, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, (2, 2)).astype(np.int32)
    return stacked, x, y


def test_param_round_trip_and_count(flax_side):
    stacked, _, _ = flax_side
    tp = params_from_flax(stacked)
    assert count_params(tp) == 2 * 421_642
    back = params_to_flax(tp)
    assert jax.tree.structure(back) == jax.tree.structure(stacked)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(stacked)):
        assert a.dtype == np.float32 and np.array_equal(a, b)


def test_port_init_matches_flax_tree(flax_side):
    model = create_model("simple_cnn")
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    assert count_params(params) == 421_642
    assert jax.tree.map(np.shape, params_to_flax(params)) == \
        jax.tree.map(lambda a: a.shape[1:], flax_side[0])
    # lecun_normal: std sqrt(1/fan_in), truncated at 2 std; zero biases
    k = params["fc1"]["kernel"]
    assert abs(float(k.std()) * np.sqrt(3136) - 1.0) < 0.02
    assert float(k.abs().max()) <= 2 / np.sqrt(3136) / 0.8796 + 1e-6
    assert all(float(params[l]["bias"].abs().max()) == 0 for l in params)


@pytest.mark.parametrize("fused", FORMULATIONS, ids=str)
def test_logits_and_grads_match_flax_f32(flax_side, fused):
    stacked, x, y = flax_side
    model = jax_create_model("simple_cnn", fused_conv_block=fused,
                             dropout_rate=0.0)

    def loss(p):
        logits = jax.vmap(lambda pp, xx: model.apply(
            {"params": pp}, xx, train=False)[0]
                          )(p, jnp.asarray(x))
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, y)
        return ce.mean(1).sum(), logits

    (_, j_logits), j_grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree.map(jnp.asarray, stacked))

    tmodel = create_model("simple_cnn", dropout_rate=0.0,
                          fused_conv_block=fused)
    tp = params_from_flax(stacked)
    for leaves in tp.values():
        for v in leaves.values():
            v.requires_grad_(True)
    t_logits = tmodel(tp, torch.tensor(x))
    t_loss = cross_entropy_loss(t_logits, torch.tensor(y).long()).sum()
    leaves = [tp[l][k] for l in sorted(tp) for k in sorted(tp[l])]
    t_grads = torch.autograd.grad(t_loss, leaves)

    # logits to 1e-5
    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(j_logits),
                               rtol=1e-5, atol=1e-5)
    # gradients to 2e-4
    for g, (path, jg) in zip(t_grads,
                             jax.tree_util.tree_leaves_with_path(j_grads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=2e-4,
                                   atol=2e-4,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("fused", FORMULATIONS, ids=str)
def test_bf16_logits_are_f32_and_close(flax_side, fused):
    """bf16 compute returns f32 logits near the f32 ones (bf16 rounding of
    activations and weights: a few percent)."""
    stacked, x, _ = flax_side
    tp = params_from_flax(stacked)
    lo32 = create_model("simple_cnn", fused_conv_block=fused)(
        tp, torch.tensor(x))
    lo16 = create_model("simple_cnn", dtype=torch.bfloat16,
                        fused_conv_block=fused)(tp, torch.tensor(x))
    assert lo16.dtype == torch.float32
    torch.testing.assert_close(lo16, lo32, rtol=0.05, atol=0.05)


def test_dropout_only_in_training():
    model = create_model("simple_cnn", dropout_rate=0.5)
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    stacked = {l: {k: v[None] for k, v in d.items()}
               for l, d in params.items()}
    x = torch.randn((1, 4, 28, 28, 1), generator=torch.Generator()
                    .manual_seed(2))
    ev1, ev2 = model(stacked, x), model(stacked, x)
    assert torch.equal(ev1, ev2)
    tr = [model(stacked, x, train=True,
                generator=torch.Generator().manual_seed(s)) for s in (3, 3, 4)]
    assert torch.equal(tr[0], tr[1]) and not torch.equal(tr[0], tr[2])


def test_unknown_model_and_dtype_are_refused():
    with pytest.raises(ValueError, match="Unknown model"):
        create_model("resnet9")
    with pytest.raises(ValueError, match="dtype"):
        create_model("simple_cnn", dtype=torch.float16)


def test_default_formulation_is_unfused_in_both_packages():
    assert create_model("simple_cnn").fused_conv_block is False
    assert jax_create_model("simple_cnn").module.fused_conv_block is False


def test_same_parameter_tree_for_all_formulations(flax_side):
    """FedAvg, checkpoints and params_from_flax see no difference; in f32
    the three formulations also give the same logits to 1e-5."""
    stacked, x, _ = flax_side
    tp = params_from_flax(stacked)
    shapes, logits = [], []
    for fused in FORMULATIONS:
        model = create_model("simple_cnn", fused_conv_block=fused)
        shapes.append(model.param_shapes())
        logits.append(model(tp, torch.tensor(x)))
    assert shapes[0] == shapes[1] == shapes[2]
    for lo in logits[1:]:
        torch.testing.assert_close(lo, logits[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["fused", "packed", 1, None])
def test_unknown_formulation_is_refused(bad):
    with pytest.raises(ValueError, match=r"False, True, 'residual'"):
        create_model("simple_cnn", fused_conv_block=bad)


@pytest.mark.parametrize("flag", ["fast_ops", "fast_pool_bwd",
                                  "fast_conv2_bwd", "fast_stem_wgrad"])
def test_tpu_formulation_flags_are_refused_by_name(flag):
    with pytest.raises(ValueError, match=flag):
        create_model("simple_cnn", **{flag: False})


def test_get_model_for_dataset():
    model = get_model_for_dataset("MNIST", dtype=torch.bfloat16,
                                  fused_conv_block=True)
    assert (model.num_classes, model.dtype, model.fused_conv_block) == \
        (10, torch.bfloat16, True)
    # the reference's routes: cifar10 → CIFAR10CNN, cifar100 → the
    # ResNet at 100 classes, any other dataset → SimpleCNN
    assert get_model_for_dataset("cifar10").name == "cifar10_cnn"
    resnet = get_model_for_dataset("cifar100")
    assert (resnet.name, resnet.num_classes) == ("federated_resnet", 100)
    assert get_model_for_dataset("svhn").name == "simple_cnn"


def test_unfused_pool_routes_ties_to_the_first_member():
    """F.max_pool2d's backward on an all-ties plane equals the fused ops'
    first-match rule (and XLA's select-and-scatter), in f32 and bf16."""
    from fl_tpu_torch.ops.conv_block import _unpool

    for dtype in (torch.float32, torch.bfloat16):
        t = torch.ones((1, 2, 4, 4), dtype=dtype, requires_grad=True)
        g = (torch.arange(8).reshape(1, 2, 2, 2) + 1).to(dtype)
        got, = torch.autograd.grad(
            torch.nn.functional.max_pool2d(t, 2), t, g)
        want = _unpool(g.float(), torch.zeros_like(g, dtype=torch.uint8), 4, 4)
        assert torch.equal(got.float(), want)


def test_unfused_convolution_is_the_library_call_with_tf32_off():
    """The unfused chain's convolution equals F.conv2d through autograd,
    values and both gradients, and leaves cuDNN's TF32 switch as it found
    it (it turns it off around its own forward and backward only)."""
    import torch.nn.functional as F

    from fl_tpu_torch.models.layers import GroupedConv

    g = torch.Generator().manual_seed(0)
    h = torch.randn((2, 6, 8, 8), generator=g)
    w = torch.randn((12, 2, 3, 3), generator=g)
    r = torch.randn((2, 12, 8, 8), generator=g)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        outs = []
        for conv in (lambda a, b: GroupedConv.apply(a, b, 3),
                     lambda a, b: F.conv2d(a, b, padding=1, groups=3)):
            a, b = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
            out = conv(a, b)
            outs.append((out.detach(), *torch.autograd.grad(out, (a, b), r)))
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = before
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # an input that needs no gradient gets none
    b = w.clone().requires_grad_(True)
    assert torch.autograd.grad(GroupedConv.apply(h, b, 3), b, r)[0].shape == w.shape
