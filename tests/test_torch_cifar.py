"""The port's CIFAR-10 pieces against fl_tpu's, on the CPU.

- CIFAR10CNN at its published widths, 2 clients x 4 images, both norms,
  train and eval mode, the flax variables carried in by
  ``variables_from_flax``. f32: the logits, the updated ``batch_stats``
  and the parameter gradients of the mean cross-entropy at rtol 1e-5 (a
  gradient leaf also within 1e-5 of the tree's largest gradient entry: a
  conv bias ahead of a BatchNorm has an exactly-zero gradient, whose f32
  value is rounding). The BatchNorm's training gradient is compared in
  float64 on both sides: at 4 images its fast-variance backward loses
  ~1e-3 of the f32 result to cancellation in the reference itself (its f32
  bn5 bias gradient is 2e-3 off its own float64 one), so f32 against f32
  says nothing at rtol 1e-5. bf16: flax's bf16 logits within 0.1, the
  statistics within 2^-7 relative, and the port's bf16 rounding error (its
  distance from the f32 result) no larger than twice the reference's for
  the logits and each gradient leaf (measured: at most 1.8x, the logits of
  BatchNorm training; 1.5x for a gradient leaf).
- The 2x2 max pool's tie gradient: ``F.max_pool2d`` on the planes equal
  to ``fl_tpu.ops.pool_vjp.max_pool_2x2`` bit for bit on all-tie windows.
- Augmentation: the crop and the flip for the reference's own draws equal
  to ``fl_tpu.ops.preprocess`` bit for bit; the port's draws uniform over
  0..8 and flips at 0.5, one offset per (client, step).
- Ghost norms on ``norm="group"``: the clipped sums (noise off, every
  example clipped) against the reference's ghost and microbatch forms and
  the port's own microbatch fold, at the reference's ghost-vs-microbatch
  tolerance (rtol 2e-4 / atol 2e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from fl_tpu.fl import privacy as jdp
from fl_tpu.fl.local_training import cross_entropy_loss as jax_ce
from fl_tpu.models import create_model as jax_create_model
from fl_tpu.ops import preprocess as jpre
from fl_tpu.ops.pool_vjp import max_pool_2x2
from fl_tpu_torch.core import prng
from fl_tpu_torch.core.pytree import tree_get, tree_map, tree_paths
from fl_tpu_torch.fl import privacy as tdp
from fl_tpu_torch.fl.local_training import (
    FederatedTrainingConfig,
    cross_entropy_loss,
    make_local_train_fn,
)
from fl_tpu_torch.models import (
    create_model,
    get_model_for_dataset,
    variables_from_flax,
    variables_to_flax,
)
from fl_tpu_torch.ops import preprocess as tpre

C, B = 2, 4
GHOST = dict(rtol=2e-4, atol=2e-5)   # the reference's ghost-vs-microbatch


@functools.lru_cache(maxsize=None)
def _flax_variables(norm):
    """Two clients' flax variables: the flax init and a perturbed copy with
    non-zero biases (and, for BatchNorm, running statistics off their
    init), stacked."""
    v0 = jax.device_get(jax_create_model("cifar10_cnn", norm=norm).init(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    v1 = jax.tree.map(lambda a: (a * 1.1 + 0.02 * rng.standard_normal(
        a.shape)).astype(np.float32), v0)
    if "batch_stats" in v1:
        v1["batch_stats"] = jax.tree.map(
            lambda a: (np.abs(a) + 0.5).astype(np.float32), v1["batch_stats"])
    return jax.tree.map(lambda *a: np.stack(a), v0, v1)


def _inputs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((C, B, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, (C, B)).astype(np.int32)
    return x, y


def _jax_side(norm, dtype, train):
    """flax's logits, gradients and (train, BatchNorm) new statistics."""
    model = jax_create_model("cifar10_cnn", norm=norm, dtype=dtype,
                             dropout_rate=0.0)
    var = _flax_variables(norm)
    x, y = _inputs()
    cast = (lambda a: jnp.asarray(a, dtype)) if dtype == jnp.float64 \
        else jnp.asarray

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


def _port_side(norm, dtype, train):
    model = create_model("cifar10_cnn", norm=norm, dtype=dtype,
                         dropout_rate=0.0)
    var = variables_from_flax(_flax_variables(norm))
    if dtype == torch.float64:
        var = tree_map(lambda t: t.double(), var)
    params = var["params"]
    paths = tree_paths(params)
    for p in paths:
        tree_get(params, p).requires_grad_(True)
    x, y = _inputs()
    xt = torch.from_numpy(x).to(torch.float64 if dtype == torch.float64
                                else torch.float32)
    out = model(params, xt, train=train, **(
        {"batch_stats": var["batch_stats"]} if norm == "batch" else {}))
    logits, new = out if (norm == "batch" and train) else (out, None)
    loss = cross_entropy_loss(logits, torch.from_numpy(y).long()).sum()
    grads = torch.autograd.grad(loss, [tree_get(params, p) for p in paths])
    g = {p: t.numpy() for p, t in zip(paths, grads)}
    return (logits.detach().numpy(), g,
            None if new is None else variables_to_flax({"s": new})["s"])


def _assert_grads(got, want, rtol):
    """Each leaf at ``rtol``, plus ``rtol`` of the tree's largest entry."""
    scale = max(np.abs(np.asarray(tree_get(want, p))).max() for p in got)
    for p, g in got.items():
        np.testing.assert_allclose(g, np.asarray(tree_get(want, p)),
                                   rtol=rtol, atol=rtol * scale,
                                   err_msg=str(p))


CASES = [(n, t) for n in ("batch", "group") for t in (True, False)]


@pytest.mark.parametrize("norm,train", CASES,
                         ids=[f"{n}-{'train' if t else 'eval'}"
                              for n, t in CASES])
def test_forward_backward_and_stats_match_flax_f32(norm, train):
    jlogits, jgrads, jstats = _jax_side(norm, jnp.float32, train)
    logits, grads, stats = _port_side(norm, torch.float32, train)
    np.testing.assert_allclose(logits, jlogits, rtol=1e-5, atol=1e-5)
    if norm == "batch" and train:
        for p in tree_paths(stats):
            np.testing.assert_allclose(tree_get(stats, p),
                                       tree_get(jstats, p), rtol=1e-5,
                                       atol=1e-7, err_msg=str(p))
    else:
        _assert_grads(grads, jgrads, 1e-5)


def test_batchnorm_training_gradients_match_flax_in_float64():
    """Both models in float64 (flax under ``jax.enable_x64``; the logits
    still come back as f32 on both sides, as flax casts them)."""
    _flax_variables("batch")   # the same f32 init as the other cases
    with jax.enable_x64(True):
        _, jgrads, jstats = _jax_side("batch", jnp.float64, True)
    _, grads, stats = _port_side("batch", torch.float64, True)
    _assert_grads(grads, jgrads, 1e-5)
    for p in tree_paths(stats):
        np.testing.assert_allclose(tree_get(stats, p), tree_get(jstats, p),
                                   rtol=1e-5, err_msg=str(p))


def _bf16_error_within_twice_the_reference(got, want, exact, what):
    """‖port_bf16 − f32‖ ≤ 2·‖flax_bf16 − f32‖ (+ 1e-6 of ‖f32‖)."""
    exact = np.asarray(exact, np.float64)
    ours = np.linalg.norm(np.asarray(got, np.float64) - exact)
    theirs = np.linalg.norm(np.asarray(want, np.float64) - exact)
    assert ours <= 2.0 * theirs + 1e-6 * np.linalg.norm(exact), \
        (what, ours, theirs)


@pytest.mark.parametrize("norm,train", CASES,
                         ids=[f"{n}-{'train' if t else 'eval'}"
                              for n, t in CASES])
def test_forward_backward_and_stats_match_flax_bf16(norm, train):
    """bf16 against flax's bf16 through the f32 result (the port's f32,
    held to flax's above): the port's bf16 rounding error no larger than
    twice the reference's, for the logits and each gradient leaf; the
    logits within 0.1 of flax's bf16 ones, the statistics within bf16's
    resolution of them."""
    jlogits, jgrads, jstats = _jax_side(norm, jnp.bfloat16, train)
    logits, grads, stats = _port_side(norm, torch.bfloat16, train)
    logits32, grads32, _ = _port_side(norm, torch.float32, train)
    assert logits.dtype == np.float32
    np.testing.assert_allclose(logits, jlogits, rtol=0.1, atol=0.1)
    _bf16_error_within_twice_the_reference(logits, jlogits, logits32,
                                           "logits")
    for p, g in grads.items():
        _bf16_error_within_twice_the_reference(
            g, tree_get(jgrads, p), grads32[p], p)
    if stats is not None:
        # the statistics are f32 means of bf16 activations: within bf16's
        # resolution (XLA on the CPU skips some of flax's bf16 roundings,
        # so its own error is no yardstick here)
        for p in tree_paths(stats):
            np.testing.assert_allclose(tree_get(stats, p),
                                       tree_get(jstats, p), rtol=2 ** -7,
                                       atol=1e-3, err_msg=str(p))


def test_init_shapes_counts_and_routing():
    model = get_model_for_dataset("cifar10")
    assert (model.name, model.norm, model.num_classes) == \
        ("cifar10_cnn", "batch", 10)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    stats = model.init_batch_stats("cpu")
    flax = jax.device_get(jax_create_model("cifar10_cnn").init(
        jax.random.PRNGKey(0)))
    ours = variables_to_flax({"params": params, "batch_stats": stats})
    assert jax.tree.map(np.shape, ours) == jax.tree.map(np.shape, flax)
    assert sum(t.numel() for t in jax.tree.leaves(params)) == 1_470_890
    assert sum(t.numel() for t in jax.tree.leaves(stats)) == 896
    gn = create_model("cifar10_cnn", norm="group")
    assert gn.init_batch_stats("cpu") is None
    assert [e[0] for e in gn.DP_LAYERS] == \
        [e[0] for e in jax_create_model("cifar10_cnn",
                                        norm="group").module.DP_LAYERS]
    assert model.DP_LAYERS is None
    with pytest.raises(ValueError, match="fast_pool_bwd"):
        create_model("cifar10_cnn", fast_pool_bwd=True)
    with pytest.raises(ValueError, match="norm="):
        create_model("cifar10_cnn", norm="layer")


def test_dropout_masks_and_eval_needs_running_stats():
    model = create_model("cifar10_cnn")
    keep = model.dropout_keep(2, 3, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in keep.items()} == {
        "pool1": (2, 3, 16, 16, 32), "pool2": (2, 3, 8, 8, 64),
        "pool3": (2, 3, 4, 4, 128), "fc1": (2, 3, 512), "fc2": (2, 3, 256)}
    frac = np.mean([v.float().mean().item() for v in keep.values()])
    assert abs(frac - 0.7) < 0.02
    params = tree_map(lambda t: t[None], model.init(
        torch.Generator().manual_seed(0), "cpu"))
    with pytest.raises(ValueError, match="batch_stats"):
        model(params, torch.zeros(1, 2, 32, 32, 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_pool_tie_gradient_is_the_first_match_of_pool_vjp(dtype):
    """All-tie and partly tied windows: F.max_pool2d on (B, C·K, H, W)
    planes routes each window's gradient where the reference's
    scatter-free max_pool_2x2 does (its first maximum)."""
    rng = np.random.default_rng(3)
    x = (rng.integers(0, 3, (3, 8, 8, 6)) * 0.5).astype(np.float32)
    x[0] = 1.0   # every window a four-way tie
    w = rng.standard_normal((3, 4, 4, 6)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    want = jax.grad(lambda a: jnp.sum(
        max_pool_2x2(a).astype(jnp.float32) * w))(jnp.asarray(x, jdt))
    xt = torch.tensor(x, dtype=dtype).permute(0, 3, 1, 2).requires_grad_(
        True)
    out = F.max_pool2d(xt, 2)
    (out.float() * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    got = xt.grad.permute(0, 2, 3, 1).float().numpy()
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def _normalized_batch(seed=4):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((3, 5, 32, 32, 3)).astype(np.float32)


def test_crop_and_flip_equal_the_reference_for_its_draws():
    """Per client, the reference's augment with a key; the port with the
    offsets and flips that key draws (its own splits): bit for bit, the
    crop alone, the flip alone and both in one gather."""
    x = _normalized_batch()
    keys = jax.random.split(jax.random.PRNGKey(5), x.shape[0])
    dys, dxs, flips, crops, want = [], [], [], [], []
    for c in range(x.shape[0]):
        kc, kf = jax.random.split(keys[c])
        kdy, kdx = jax.random.split(kc)
        dys.append(int(jax.random.randint(kdy, (), 0, 9)))
        dxs.append(int(jax.random.randint(kdx, (), 0, 9)))
        flips.append(np.asarray(jax.random.bernoulli(
            kf, 0.5, (x.shape[1], 1, 1, 1))).reshape(-1))
        crops.append(np.asarray(jpre.random_crop_with_padding(
            jnp.asarray(x[c]), kc, 4)))
        want.append(np.asarray(jpre.make_cifar_augment()(
            jnp.asarray(x[c]), keys[c])))
    dy, dx = torch.tensor(dys), torch.tensor(dxs)
    flip = torch.from_numpy(np.stack(flips))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        tpre.random_crop_with_padding(xt, dy, dx).numpy(), np.stack(crops))
    np.testing.assert_array_equal(
        tpre.crop_and_flip(xt, dy, dx, flip).numpy(), np.stack(want))
    np.testing.assert_array_equal(
        tpre.random_hflip(torch.from_numpy(np.stack(crops)), flip).numpy(),
        np.stack(want))
    u8 = np.random.default_rng(6).integers(0, 256, (2, 32, 32, 3),
                                           dtype=np.uint8)
    mean, std = (0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)
    np.testing.assert_array_equal(
        tpre.normalize_u8(torch.from_numpy(u8), mean, std).numpy(),
        np.asarray(jpre.normalize_u8(jnp.asarray(u8), mean, std)))


def test_augment_draws_uniform_offsets_and_fair_flips():
    n = 18_000
    dy, dx, flip = tpre.augment_draws(torch.Generator().manual_seed(0), n,
                                      16)
    for off in (dy, dx):
        counts = np.bincount(off.numpy(), minlength=9)
        assert counts.shape == (9,) and off.min() >= 0 and off.max() <= 8
        # each value's count within 5σ of n/9
        sd = np.sqrt(n * (1 / 9) * (8 / 9))
        assert np.all(np.abs(counts - n / 9) < 5 * sd), counts
    p = flip.float().mean().item()
    assert abs(p - 0.5) < 5 * np.sqrt(0.25 / flip.numel())


def test_trainer_augments_each_step_one_offset_a_client():
    """The trainer's augment slot: the normalized (C, B, ...) batch, a
    fresh generator each step (fold(fold(round, AUGMENT), step)); with
    every image of a client equal, all its samples come out as one crop
    (or its mirror)."""
    seen = []
    base = tpre.make_cifar_augment()

    def spy(x, gen):
        seen.append(torch.randint(0, 1 << 30, (1,), generator=gen).item())
        out = base(x, gen)
        flat = out.reshape(out.shape[0], out.shape[1], -1)
        mirror = out.flip(3).reshape(flat.shape)
        for c in range(out.shape[0]):
            for b in range(out.shape[1]):
                assert (torch.equal(flat[c, b], flat[c, 0])
                        or torch.equal(mirror[c, b], flat[c, 0]))
        return out

    model = create_model("cifar10_cnn", norm="group", dropout_rate=0.0)
    cfg = FederatedTrainingConfig(local_epochs=2, batch_size=4,
                                  learning_rate=1e-3)
    img = np.random.default_rng(7).integers(0, 256, (2, 1, 32, 32, 3),
                                            dtype=np.uint8)
    images = torch.from_numpy(np.repeat(img, 8, axis=1))
    labels = torch.zeros((2, 8), dtype=torch.int64)
    mean = torch.tensor((0.5, 0.5, 0.5))
    train = make_local_train_fn(model, cfg, 8, mean, mean, augment_fn=spy)
    params = tree_map(lambda t: t[None].expand(2, *t.shape).clone(),
                      model.init(torch.Generator().manual_seed(0), "cpu"))
    rseed = prng.round_seed(prng.root_seed(0), 0)
    train(params, images, labels, torch.tensor([8, 8]), rseed)
    assert len(seen) == 4 and len(set(seen)) == 4
    aug = prng.stream_seed(rseed, prng.Stream.AUGMENT)
    assert seen == [torch.randint(0, 1 << 30, (1,), generator=prng.generator(
        prng.fold(aug, s), "cpu")).item() for s in range(4)]


def test_ghost_norms_on_group_norm_match_the_reference():
    """Noise off, C small enough that every example is clipped (so each
    example's weight is C/‖g_i‖, the ghost norm): the port's ghost form
    and microbatch fold against the reference's ghost and microbatch
    forms on CIFAR10CNN(norm="group"), 2 clients x 4 examples, f32, one
    padded slot."""
    jm = jax_create_model("cifar10_cnn", norm="group", dropout_rate=0.0)
    var = _flax_variables("group")
    x, y = _inputs()
    wmask = np.ones((C, B), np.float32)
    wmask[0, 2] = 0.0
    clip = 1e-3

    def loss_fn(p, extra, xb, yb, dkey):
        logits, _ = jm.apply({"params": p, **extra}, xb, train=True,
                             dropout_rng=dkey)
        return jax_ce(logits, yb), None

    refs = [jax.jit(jdp.make_ghost_dp_sgd_grad_fn(jm, clip, 0.0)),
            jax.jit(jdp.make_dp_sgd_grad_fn(loss_fn, clip, 0.0, 2))]
    wants = []
    for ref in refs:
        per = [jax.device_get(ref(
            jax.tree.map(lambda a: jnp.asarray(a[c]), var["params"]), {},
            jnp.asarray(x[c]), jnp.asarray(y[c]), jnp.asarray(wmask[c]),
            jax.random.PRNGKey(0), jax.random.PRNGKey(1)))
            for c in range(C)]
        wants.append(jax.tree.map(lambda *a: np.stack(a), *per))
    model = create_model("cifar10_cnn", norm="group", dropout_rate=0.0)
    params = variables_from_flax(var)["params"]
    args = (params, torch.from_numpy(x), torch.from_numpy(y).long(),
            torch.from_numpy(wmask), 1, 2)
    forms = [tdp.make_ghost_dp_sgd_grad_fn(model, clip, 0.0),
             tdp.make_dp_sgd_grad_fn(model, clip, 0.0, microbatch_size=2)]
    for form in forms:
        got = form(*args)
        for want in wants:
            for p in tree_paths(got):
                np.testing.assert_allclose(
                    tree_get(got, p).numpy(), tree_get(want, p),
                    err_msg=str(p), **GHOST)
