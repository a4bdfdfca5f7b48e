"""The port's FederatedResNet, LightweightMobileNet and FederatedViT (with
and without LoRA) against fl_tpu's, on the CPU.

Each model runs 2 clients x 2 images, the flax variables (the flax init of
client 0 and a perturbed copy for client 1, with running statistics off
their init) carried in by ``variables_from_flax``, dropout 0. Tolerances:

- f32: the logits at rtol 1e-5 / atol 1e-5; each gradient leaf within
  relative Frobenius 1e-4 of flax's, or within 1e-6 of the whole tree's
  gradient norm where the true gradient is zero (a projection bias ahead
  of a softmax, whose f32 gradient is rounding in both packages); the
  updated ``batch_stats`` at rtol 1e-5. A BatchNorm model's training
  gradients are held in float64 on both sides (flax under
  ``jax.enable_x64``): at 2 images the fast-variance backward loses up to
  ~2e-4 of the f32 result to cancellation in the reference itself.
- bf16: the logits within relative Frobenius 1e-2 of flax's bf16 logits;
  the statistics within 2^-7 relative; and the port's bf16 rounding error
  (its distance from the port's f32 result) no larger than twice flax's,
  for the logits and for each gradient leaf. Where no BatchNorm trains,
  the whole gradient tree also within relative Frobenius 1e-2 of flax's
  (a training BatchNorm at 2 images amplifies bf16 rounding in both
  packages alike, up to 0.2 of the gradient).

The ResNet runs its gradients at ``num_blocks=(1, 1, 1)`` (both stride-2
stages and both shortcuts) and its default depth at 100 classes forward
only. Also: XLA's SAME padding at stride 2 (a symmetric pad fails it),
LoRADense and ``merge_lora`` against the reference's, the factory.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from fl_tpu.fl import peft as jpeft
from fl_tpu.fl.server_optimizer import \
    make_server_optimizer as jax_server_optimizer
from fl_tpu.models import create_model as jax_create_model
from fl_tpu.models import get_model_for_dataset as jax_model_for_dataset
from fl_tpu.models import get_lightweight_model as jax_lightweight
from fl_tpu.models.vit import FederatedViT as JaxViT
from fl_tpu_torch.core.pytree import tree_get, tree_map, tree_paths
from fl_tpu_torch.fl import peft
from fl_tpu_torch.fl.local_training import cross_entropy_loss
from fl_tpu_torch.fl.server_optimizer import state_from_optax
from fl_tpu_torch.models import (
    AVAILABLE_MODELS,
    ModelFactory,
    benchmark_models,
    create_model,
    get_lightweight_model,
    get_model_for_dataset,
    get_model_info,
    init_variables,
    list_available_models,
    params_from_flax,
    params_to_flax,
    validate_model_compatibility,
    variables_from_flax,
    variables_to_flax,
)
from fl_tpu_torch.models import layers
from fl_tpu_torch.models.vit import FederatedViT

C, B = 2, 2
TINY_VIT = dict(patch_size=8, embed_dim=32, depth=1, num_heads=2,
                mlp_ratio=2)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "f64": (jnp.float64, torch.float64)}

# case -> (registry name, keywords); dropout is off in every case
MODELS = {
    "resnet-111": ("federated_resnet", dict(num_blocks=(1, 1, 1))),
    "mobilenet-0.5": ("lightweight_mobilenet", dict(width_multiplier=0.5)),
    "mobilenet-1.0": ("lightweight_mobilenet", dict(width_multiplier=1.0)),
    "vit-tiny": ("federated_vit", dict(TINY_VIT, dropout_rate=0.0)),
    "vit-tiny-lora4": ("federated_vit", dict(TINY_VIT, dropout_rate=0.0,
                                             lora_rank=4)),
    "vit": ("federated_vit", dict(dropout_rate=0.0)),
    "vit-lora4": ("federated_vit", dict(dropout_rate=0.0, lora_rank=4)),
}
BN_MODELS = ("federated_resnet", "lightweight_mobilenet")


def _flax_shapes(name, **kw):
    """The reference model's variables as shapes (no init is compiled)."""
    return jax.eval_shape(jax_create_model(name, **kw).init,
                          jax.random.PRNGKey(0))



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one intra-op thread, restored after it: several test
    processes share the CPU under xdist, and idle OpenMP threads spinning
    in each starve the others' JAX compiles (these two files on 6 workers:
    257 s with torch's default threads, 49 s with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@functools.lru_cache(maxsize=None)
def _flax_variables(case):
    """Two clients' variables in flax's layout: the port's init (whose tree
    must be the reference's, leaf for leaf) and a perturbed copy with
    running statistics off their init, stacked."""
    name, kw = MODELS[case]
    v0 = variables_to_flax(init_variables(create_model(name, **kw)))
    assert jax.tree.map(np.shape, v0) == jax.tree.map(
        lambda a: a.shape, _flax_shapes(name, **kw))
    rng = np.random.default_rng(0)
    v1 = jax.tree.map(lambda a: (a * 1.1 + 0.02 * rng.standard_normal(
        a.shape)).astype(np.float32), v0)
    if "batch_stats" in v1:
        v1["batch_stats"] = jax.tree.map(
            lambda a: (np.abs(a) + 0.5).astype(np.float32), v1["batch_stats"])
    return jax.tree.map(lambda *a: np.stack(a), v0, v1)


def _inputs(classes=10):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((C, B, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, classes, (C, B)).astype(np.int32)
    return x, y


@functools.lru_cache(maxsize=None)
def _jax_side(case, dtype, train):
    """flax's logits, gradients of the summed per-client mean cross-entropy
    and (training a BatchNorm model) new statistics."""
    name, kw = MODELS[case]
    jdt = DTYPES[dtype][0]
    model = jax_create_model(name, dtype=jdt, **kw)
    var = _flax_variables(case)
    x, y = _inputs()
    cast = ((lambda a: jnp.asarray(a, jdt)) if dtype == "f64"
            else jnp.asarray)

    @jax.jit
    def run(params, stats, x):
        def loss(p):
            def one(pp, st, xx):
                v = {"params": pp}
                if st is not None:
                    v["batch_stats"] = st
                return model.apply(v, xx, train=train)
            logits, new = jax.vmap(one)(p, stats, x)
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, y)
            return ce.mean(1).sum(), (logits, new)
        (_, (logits, new)), g = jax.value_and_grad(loss, has_aux=True)(
            params)
        return logits, g, new.get("batch_stats")

    params = jax.tree.map(cast, var["params"])
    stats = (jax.tree.map(cast, var["batch_stats"])
             if "batch_stats" in var else None)
    return jax.device_get(run(params, stats, cast(x)))


def _port_side(case, dtype, train):
    name, kw = MODELS[case]
    tdt = DTYPES[dtype][1]
    model = create_model(name, dtype=tdt, **kw)
    var = variables_from_flax(_flax_variables(case))
    if dtype == "f64":
        var = tree_map(lambda t: t.double(), var)
    params = var["params"]
    paths = tree_paths(params)
    for p in paths:
        tree_get(params, p).requires_grad_(True)
    x, y = _inputs()
    xt = torch.from_numpy(x).to(torch.float64 if dtype == "f64"
                                else torch.float32)
    kw = {"batch_stats": var["batch_stats"]} if "batch_stats" in var else {}
    out = model(params, xt, train=train, **kw)
    logits, new = out if isinstance(out, tuple) else (out, None)
    loss = cross_entropy_loss(logits, torch.from_numpy(y).long()).sum()
    grads = torch.autograd.grad(loss, [tree_get(params, p) for p in paths])
    g = {p: t.numpy() for p, t in zip(paths, grads)}
    return (logits.detach().numpy(), g,
            None if new is None else variables_to_flax({"s": new})["s"])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _tree_norm(grads):
    return np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum()
                       for g in grads))


def _assert_grads_f32(got, want):
    """Each leaf within relative Frobenius 1e-4, or within 1e-6 of the
    tree's gradient norm (a leaf whose true gradient is zero)."""
    total = _tree_norm(tree_get(want, p) for p in got)
    for p, g in got.items():
        w = np.asarray(tree_get(want, p), np.float64)
        err = np.linalg.norm(np.asarray(g, np.float64) - w)
        assert err <= max(1e-4 * np.linalg.norm(w), 1e-6 * total), \
            (p, err, np.linalg.norm(w), total)


def _assert_stats(got, want, dtype):
    for p in tree_paths(got):
        g, w = tree_get(got, p), np.asarray(tree_get(want, p), np.float32)
        if dtype == "bf16":
            # f32 means of bf16 activations: within bf16's resolution
            np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=1e-3,
                                       err_msg=str(p))
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                       err_msg=str(p))


def _cases():
    out = []
    for case, (name, _) in MODELS.items():
        modes = (True, False) if name in BN_MODELS else (True,)
        for train in modes:
            for dtype in ("f32", "bf16"):
                out.append((case, dtype, train))
    return out


@pytest.mark.parametrize(
    "case,dtype,train", _cases(),
    ids=[f"{c}-{d}-{'train' if t else 'eval'}" for c, d, t in _cases()])
def test_forward_gradients_and_stats_match_flax(case, dtype, train):
    name = MODELS[case][0]
    bn_train = train and name in BN_MODELS
    jlogits, jgrads, jstats = _jax_side(case, dtype, train)
    logits, grads, stats = _port_side(case, dtype, train)
    assert logits.dtype == np.float32 and logits.shape == (C, B, 10)
    assert (stats is None) == (not bn_train)
    if dtype == "f32":
        np.testing.assert_allclose(logits, jlogits, rtol=1e-5, atol=1e-5)
        if bn_train:
            _assert_stats(stats, jstats, dtype)
            with jax.enable_x64(True):
                _, jgrads, _ = _jax_side(case, "f64", True)
            _, grads, _ = _port_side(case, "f64", True)
        _assert_grads_f32(grads, jgrads)
        return
    # bf16, through the f32 result
    logits32, grads32, _ = _port_side(case, "f32", train)
    assert _rel(logits, jlogits) <= 1e-2
    ours = np.linalg.norm(logits - logits32)
    theirs = np.linalg.norm(jlogits - logits32)
    assert ours <= 2.0 * theirs + 1e-6 * np.linalg.norm(logits32), \
        ("logits", ours, theirs)
    for p, g in grads.items():
        exact = np.asarray(grads32[p], np.float64)
        ours = np.linalg.norm(g - exact)
        theirs = np.linalg.norm(np.asarray(tree_get(jgrads, p)) - exact)
        assert ours <= 2.0 * theirs + 1e-6 * np.linalg.norm(exact), \
            (p, ours, theirs)
    if not bn_train:
        ours = np.concatenate([g.ravel() for g in grads.values()])
        theirs = np.concatenate([np.asarray(tree_get(jgrads, p)).ravel()
                                 for p in grads])
        assert _rel(ours, theirs) <= 1e-2
    else:
        _assert_stats(stats, jstats, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_resnet_at_its_default_depth_forward_matches_flax(dtype):
    """The cifar100 route's model (2, 2, 2) at 100 classes: eval logits and
    the training forward's logits and new statistics, forward only."""
    jdt, tdt = DTYPES[dtype]
    jm = jax_model_for_dataset("cifar100", dtype=jdt)
    v0 = variables_to_flax(init_variables(get_model_for_dataset(
        "cifar100")))
    rng = np.random.default_rng(0)
    v1 = jax.tree.map(lambda a: (a * 1.1 + 0.02 * rng.standard_normal(
        a.shape)).astype(np.float32), v0)
    var = jax.tree.map(lambda *a: np.stack(a), v0, v1)
    x, _ = _inputs()

    @jax.jit
    def run(v, x):
        def one(vv, xx):
            ev, _ = jm.apply(vv, xx, train=False)
            tr, new = jm.apply(vv, xx, train=True)
            return ev, tr, new["batch_stats"]
        return jax.vmap(one)(v, x)

    jev, jtr, jstats = jax.device_get(run(var, jnp.asarray(x)))
    model = get_model_for_dataset("cifar100", dtype=tdt)
    tv = variables_from_flax(var)
    with torch.no_grad():
        ev = model(tv["params"], torch.from_numpy(x),
                   batch_stats=tv["batch_stats"]).numpy()
        tr, new = model(tv["params"], torch.from_numpy(x), train=True,
                        batch_stats=tv["batch_stats"])
    assert ev.shape == (C, B, 100)
    for got, want in ((ev, jev), (tr.numpy(), jtr)):
        if dtype == "f32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert _rel(got, want) <= 1e-2
    stats = variables_to_flax({"s": new})["s"]
    assert len(tree_paths(stats)) == 30
    _assert_stats(stats, jstats, dtype)


@pytest.mark.parametrize("n,k,s", [(32, 3, 2), (16, 3, 2), (8, 3, 2),
                                   (2, 3, 2), (32, 1, 2), (32, 3, 1),
                                   (31, 3, 2), (7, 4, 4)])
def test_same_padding_is_xla_s(n, k, s):
    assert layers.same_pads(n, k, s) == tuple(
        jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0])


@pytest.mark.parametrize("size", [32, 16])
def test_stride2_conv_matches_xla_and_symmetric_padding_does_not(size):
    """A 3x3 stride-2 SAME conv of 2 clients (and the depthwise form) on
    even sizes, where XLA pads (0, 1): ``layers.conv`` equals flax's
    ``nn.Conv`` per client; ``F.conv2d(padding=1)`` — a one-pixel shift —
    does not."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((C, B, size, size, 4)).astype(np.float32)
    for groups, kshape in ((1, (3, 3, 4, 6)), (4, (3, 3, 1, 4))):
        k = rng.standard_normal((C,) + kshape).astype(np.float32)
        conv = fnn.Conv(kshape[-1], (3, 3), strides=(2, 2), padding="SAME",
                        feature_group_count=groups, use_bias=False)
        want = np.stack([np.asarray(conv.apply(
            {"params": {"kernel": k[c]}}, jnp.asarray(x[c])))
            for c in range(C)])
        h = layers.nhwc_to_planes(torch.from_numpy(x))
        g = C if groups == 1 else h.shape[1]
        got = layers.planes_to_nhwc(
            layers.conv(h, torch.from_numpy(k), g, stride=2), C).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        w = torch.from_numpy(k).permute(0, 4, 3, 1, 2).reshape(
            -1, kshape[2], 3, 3)
        sym = layers.planes_to_nhwc(
            F.conv2d(h, w, stride=2, padding=1, groups=g), C).numpy()
        assert sym.shape == want.shape
        assert np.abs(sym - want).max() > 1e-1


def test_lora_dense_starts_at_the_dense_and_matches_the_reference():
    """At init (B = 0) LoRADense computes the plain Dense bit for bit; with
    trained adapters it equals the reference's LoRADense (f32 rtol 1e-5)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((C, 5, 16)).astype(np.float32)
    lora = peft.LoRADense(8, rank=4)
    init = tree_map(lambda t: torch.stack([t, t * 1.5]),
                    lora.init(16, torch.Generator().manual_seed(0), "cpu"))
    assert float(init["lora_a"].std()) == pytest.approx(0.25, rel=0.25)
    assert not init["lora_b"].any()
    dense = layers.Dense(8)
    xt = torch.from_numpy(x)
    assert torch.equal(lora(init, xt), dense(init, xt))
    jl = jpeft.LoRADense(8, rank=4)
    inits = [jax.device_get(jl.init(jax.random.PRNGKey(c),
                                    jnp.asarray(x[0]))["params"])
             for c in range(C)]
    flax_p = {k: np.stack([np.asarray(p[k]) for p in inits])
              for k in inits[0]}
    flax_p["lora_b"] = rng.standard_normal(
        flax_p["lora_b"].shape).astype(np.float32)
    flax_p["bias"] = rng.standard_normal(
        flax_p["bias"].shape).astype(np.float32)
    want = np.stack([np.asarray(jl.apply(
        {"params": jax.tree.map(lambda a: a[c], flax_p)}, jnp.asarray(x[c])))
        for c in range(C)])
    got = lora(params_from_flax(flax_p), xt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_merge_lora_keeps_the_function_and_equals_the_reference():
    model = create_model("federated_vit", lora_rank=2, dropout_rate=0.0,
                         **TINY_VIT)
    params = tree_map(lambda t: t[None], init_variables(model)["params"])
    rng = np.random.default_rng(1)
    flat = params_to_flax(params)
    flat = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(0, 0.05, a.shape).astype(np.float32)
                         if "lora_" in str(path[-1]) else a), flat)
    params = params_from_flax(flat)
    x = torch.from_numpy(rng.normal(0, 1, (1, 2, 32, 32, 3)).astype(
        np.float32))
    merged = peft.merge_lora(params)
    np.testing.assert_allclose(model(merged, x).numpy(),
                               model(params, x).numpy(),
                               rtol=1e-5, atol=1e-5)
    want = jpeft.merge_lora(jax.tree.map(jnp.asarray, flat))
    for p in tree_paths(merged):
        np.testing.assert_allclose(tree_get(merged, p).numpy(),
                                   np.asarray(tree_get(want, p)),
                                   rtol=1e-6, atol=1e-7, err_msg=str(p))
        if "lora_" in p[-1]:
            assert not tree_get(merged, p).any()


def test_vit_dropout_masks():
    """``dropout_keep``'s sites and shapes, keep share 1 − rate; a forward
    given the masks equals the one drawing them from the same generator."""
    model = create_model("federated_vit", **TINY_VIT)
    keep = model.dropout_keep(2, 3, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in keep.items()} == {
        "embed": (2, 3, 16, 32), "block0/attn": (2, 3, 2, 16, 16),
        "block0/mlp": (2, 3, 16, 64)}
    frac = np.mean([v.float().mean().item() for v in keep.values()])
    assert abs(frac - 0.9) < 0.03
    params = tree_map(lambda t: torch.stack([t, t]),
                      init_variables(model)["params"])
    x = torch.randn((2, 3, 32, 32, 3), generator=torch.Generator()
                    .manual_seed(1))
    drawn = model(params, x, train=True,
                  generator=torch.Generator().manual_seed(0))
    given = model(params, x, train=True, dropout_mask=keep)
    assert torch.equal(drawn, given)
    assert not torch.equal(given, model(params, x))
    assert create_model("federated_vit", dropout_rate=0.0).dropout_keep(
        1, 1, None, "cpu") is None


def test_weight_carriers_round_trip_trees_of_any_depth():
    """A ViT-LoRA params tree (three levels under ``block0/q``, the leaf
    ``pos_embed`` at the top) and the ResNet's variables, numpy → torch →
    numpy bit for bit, through both pairs of carriers; the reference's
    FedAdam state of the ViT tree through ``state_from_optax``."""
    rng = np.random.default_rng(4)
    vit = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        _flax_shapes("federated_vit", lora_rank=4, **TINY_VIT))
    res = _flax_variables("resnet-111")
    for tree, there, back in (
            (vit["params"], params_from_flax, params_to_flax),
            (vit, variables_from_flax, variables_to_flax),
            (res, variables_from_flax, variables_to_flax)):
        out = back(there(tree))
        assert jax.tree.structure(out) == jax.tree.structure(
            jax.tree.map(np.asarray, tree))
        for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert there(vit)["params"]["pos_embed"].shape == (1, 16, 32)
    assert there(vit)["params"]["block0"]["q"]["lora_a"].shape == (32, 4)
    # the server optimizer's state, read from the reference's optax state
    opt = jax_server_optimizer("fedadam", learning_rate=1e-3)
    jstate = opt.init(jax.tree.map(jnp.asarray, vit["params"]))
    state = state_from_optax(jax.device_get(jstate))
    mu = [s for s in jstate if hasattr(s, "mu")][0].mu
    for a, b in zip(jax.tree.leaves(params_to_flax(state["mu"])),
                    jax.tree.leaves(mu)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert state["nu"]["pos_embed"].shape == (1, 16, 32)


def test_factory_routes_info_and_errors():
    assert list_available_models() == list(AVAILABLE_MODELS) == [
        "simple_cnn", "cifar10_cnn", "federated_resnet",
        "lightweight_mobilenet", "federated_vit"]
    res = get_model_for_dataset("cifar100")
    assert (res.name, res.num_classes, res.num_blocks) == \
        ("federated_resnet", 100, (2, 2, 2))
    assert get_model_for_dataset("CIFAR10").name == "cifar10_cnn"
    other = get_model_for_dataset("svhn")
    assert (other.name, other.input_shape) == ("simple_cnn", (28, 28, 1))
    light = get_lightweight_model()
    assert (light.name, light.width_multiplier) == \
        ("lightweight_mobilenet", 0.5)
    assert ModelFactory.create_model is create_model
    for name in AVAILABLE_MODELS:
        want = jax_create_model(name).get_model_info(_flax_shapes(name))
        assert get_model_info(name) == want, name
    assert get_model_info("lightweight_mobilenet")["parameters"] == 274_250
    assert validate_model_compatibility(
        create_model("federated_resnet"), create_model("federated_resnet"))
    assert not validate_model_compatibility(
        create_model("federated_resnet"),
        create_model("federated_resnet", num_classes=100))
    assert not validate_model_compatibility(
        create_model("federated_resnet"), get_lightweight_model())
    with pytest.raises(ValueError) as want:
        jax_create_model("vgg")
    with pytest.raises(ValueError) as got:
        create_model("vgg")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="input shape"):
        create_model("cifar10_cnn", input_shape=(28, 28, 3))
    assert (jax_lightweight().module.width_multiplier
            == light.width_multiplier)


def test_vit_flops_and_the_indivisible_patch_error():
    for kw in ({}, dict(input_hw=64, patch=8, dim=64, depth=2)):
        assert FederatedViT.flops_per_sample(**kw) == \
            JaxViT.flops_per_sample(**kw) > 1e6
    with pytest.raises(ValueError) as want:
        jax_create_model("federated_vit", input_shape=(30, 30, 3)).init(
            jax.random.PRNGKey(0))
    model = create_model("federated_vit", input_shape=(30, 30, 3))
    with pytest.raises(ValueError) as got:
        init_variables(model)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="divisible"):
        create_model("federated_vit")(
            {}, torch.zeros((1, 1, 30, 30, 3)))


def test_benchmark_models_on_the_cpu():
    out = benchmark_models(iters=1, device="cpu")
    assert list(out) == list(AVAILABLE_MODELS)
    for name, info in out.items():
        assert "error" not in info, (name, info)
        assert info["output_shape"] == (1, 10) and info["device"] == "cpu"
        assert info["inference_time"] > 0
        assert info["parameters"] == get_model_info(name)["parameters"]
