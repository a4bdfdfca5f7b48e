"""fl_tpu_torch SimpleCNN vs flax SimpleCNN(fused_conv_block="residual").

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
from fl_tpu_torch.models import (count_params, create_model, params_from_flax,
                                 params_to_flax)


@pytest.fixture(scope="module")
def flax_side():
    """Two clients' flax params (the flax init, and a perturbed copy with
    non-zero biases), images and labels."""
    model = jax_create_model("simple_cnn", fused_conv_block="residual",
                             dropout_rate=0.0)
    # the unfused model declares the same tree and initializers, and
    # initializes without tracing the Pallas segment
    p0 = jax.device_get(jax_create_model("simple_cnn").init(
        jax.random.PRNGKey(0))["params"])
    rng = np.random.default_rng(0)
    p1 = jax.tree.map(lambda a: (a * 1.1 + 0.02 * rng.standard_normal(
        a.shape)).astype(np.float32), p0)
    stacked = jax.tree.map(lambda *a: np.stack(a), p0, p1)
    x = rng.standard_normal((2, 2, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, (2, 2)).astype(np.int32)
    return model, stacked, x, y


def test_param_round_trip_and_count(flax_side):
    _, stacked, _, _ = flax_side
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
        jax.tree.map(lambda a: a.shape[1:], flax_side[1])
    # lecun_normal: std sqrt(1/fan_in), truncated at 2 std; zero biases
    k = params["fc1"]["kernel"]
    assert abs(float(k.std()) * np.sqrt(3136) - 1.0) < 0.02
    assert float(k.abs().max()) <= 2 / np.sqrt(3136) / 0.8796 + 1e-6
    assert all(float(params[l]["bias"].abs().max()) == 0 for l in params)


def test_logits_and_grads_match_flax_f32(flax_side):
    model, stacked, x, y = flax_side

    def loss(p):
        logits = jax.vmap(lambda pp, xx: model.apply(
            {"params": pp}, xx, train=False)[0]
                          )(p, jnp.asarray(x))
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, y)
        return ce.mean(1).sum(), logits

    (_, j_logits), j_grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree.map(jnp.asarray, stacked))

    tmodel = create_model("simple_cnn", dropout_rate=0.0)
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


def test_bf16_logits_are_f32_and_close(flax_side):
    """bf16 compute returns f32 logits near the f32 ones (bf16 rounding of
    activations and weights: a few percent)."""
    _, stacked, x, _ = flax_side
    tp = params_from_flax(stacked)
    lo32 = create_model("simple_cnn")(tp, torch.tensor(x))
    lo16 = create_model("simple_cnn", dtype=torch.bfloat16)(
        tp, torch.tensor(x))
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
