"""Example-level DP-SGD (``dp_mode="dp_sgd"``) of the port against fl_tpu.

- The mechanism (the cases of ``tests/test_dp_sgd_semantics.py``) on the
  reference's linear model, held to the reference's
  ``make_dp_sgd_grad_fn`` at f32 rtol 1e-5 where the noise is off: padded
  slots contribute nothing, one example moves the mean by at most 2C/B,
  the noise is N(0, (z·C/B)²) by its distribution, and local training
  masks exactly the padded slots.
- Ghost norms against the microbatch fold on SimpleCNN (f32, the same
  seeds, noise on): the reference's tolerance between its two forms, rtol
  2e-4 / atol 2e-5.
- The per-example clipped sums (noise off) against the reference's
  ``make_dp_sgd_grad_fn`` on its ``"residual"`` model (Pallas in interpret
  mode) and on ``False``, f32, weights carried by ``params_from_flax``, at
  the same rtol 2e-4 / atol 2e-5.
- One engine round of each form (the microbatch fold on ``"residual"``,
  K1/K2's path, and both forms on ``False``) against the JAX engine's
  ghost round on the unfused bf16 model, with the clip active on every
  example (C = 0.05, checked through the clip scales) and the noise out
  of the way (z = 1e-9, so σ ≈ 3e-12 an element
  stays far below Adam's ε = 1e-8 and cannot turn an update of an
  exactly-zero gradient; ε = 1e30 admits it): params rtol 2e-2 / atol
  1e-3, train loss rtol 5e-2 (the reference's one-round bf16
  tolerances for two formulations of the segment,
  tests/test_conv_block_engine.py); the ε charged, the certified ε and the
  ledger equal.
- The PLD step budget under dp_sgd and the rules: equal to the reference's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy import stats

from fl_tpu.core.types import PrivacyConfig as JaxPrivacyConfig
from fl_tpu.data import load_dataset as jax_load_dataset
from fl_tpu.data import make_federated_arrays as jax_make_arrays
from fl_tpu.fl import privacy as jdp
from fl_tpu.fl.local_training import \
    FederatedTrainingConfig as JaxTrainingConfig
from fl_tpu.fl.local_training import cross_entropy_loss as jax_ce
from fl_tpu.models import create_model as jax_create_model
from fl_tpu.orchestration import FederatedRoundEngine as JaxEngine
from fl_tpu.orchestration import RoundEngineConfig as JaxConfig
from fl_tpu_torch.core.types import PrivacyConfig
from fl_tpu_torch.data import load_dataset, make_federated_arrays
from fl_tpu_torch.fl import privacy as tdp
from fl_tpu_torch.fl.local_training import (
    FederatedTrainingConfig,
    make_local_train_fn,
)
from fl_tpu_torch.models import (
    SimpleCNN,
    create_model,
    params_from_flax,
    params_to_flax,
)
from fl_tpu_torch.orchestration import FederatedRoundEngine, RoundEngineConfig

F32 = dict(rtol=2e-4, atol=2e-5)   # the reference's ghost-vs-microbatch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Linear:
    """The reference's ``linear_model_loss`` model over stacked clients:
    logits = x @ w, no dropout."""

    dtype = torch.float32

    def __call__(self, params, x, train=False, dropout_mask=None):
        return torch.bmm(x.reshape(x.shape[0], x.shape[1], -1),
                         params["lin"]["w"])


def linear_model_loss(params, extra, xb, yb, dkey):
    del extra, dkey
    logits = xb @ params["w"]
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, yb).mean(), None


def _linear_case(seed, B=8):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1, (8, 4)).astype(np.float32)
    xb = rng.normal(0, 1, (B, 8)).astype(np.float32)
    yb = rng.integers(0, 4, (B,))
    return w, xb, yb


def _port_linear(fn, w, xb, yb, wmask, noise_seed=0):
    out = fn({"lin": {"w": torch.from_numpy(w)[None]}},
             torch.from_numpy(xb)[None], torch.from_numpy(yb)[None],
             torch.as_tensor(wmask, dtype=torch.float32)[None], 1,
             noise_seed)
    return out["lin"]["w"][0].numpy()


def _ref_linear(C, w, xb, yb, wmask, m=4):
    fn = jdp.make_dp_sgd_grad_fn(linear_model_loss, max_grad_norm=C,
                                 noise_multiplier=0.0, microbatch_size=m)
    key = jax.random.PRNGKey(0)
    return np.asarray(fn({"w": jnp.asarray(w)}, {}, jnp.asarray(xb),
                         jnp.asarray(yb), jnp.asarray(wmask, jnp.float32),
                         key, key)["w"])


# ---------------------------------------------------------------------------
# the mechanism
# ---------------------------------------------------------------------------

def test_padded_slots_contribute_zero():
    """Hostile content in masked slots changes nothing; unmasking them
    does; the masked gradient equals the reference's."""
    fn = tdp.make_dp_sgd_grad_fn(Linear(), 1.0, 0.0, microbatch_size=4)
    w, xb, yb = _linear_case(0)
    wmask = np.array([1, 1, 1, 1, 0, 0, 0, 0], np.float32)
    g1 = _port_linear(fn, w, xb, yb, wmask)
    hostile = xb.copy()
    hostile[4:] = 1e3
    np.testing.assert_allclose(_port_linear(fn, w, hostile, yb, wmask), g1,
                               rtol=1e-6)
    assert not np.allclose(_port_linear(fn, w, xb, yb, np.ones(8)), g1)
    np.testing.assert_allclose(g1, _ref_linear(1.0, w, xb, yb, wmask),
                               rtol=1e-5, atol=1e-7)


def test_per_example_clip_bounds_single_example_influence():
    """Swapping one example for an extreme one moves the noise-free mean
    gradient by at most 2C/B in L2, as in the reference."""
    C, B = 1.0, 8
    fn = tdp.make_dp_sgd_grad_fn(Linear(), C, 0.0, microbatch_size=4)
    w, xb, yb = _linear_case(1, B)
    ones = np.ones(B, np.float32)
    base = _port_linear(fn, w, xb, yb, ones)
    poisoned = xb.copy()
    poisoned[3] = 1e4
    diff = np.linalg.norm(base - _port_linear(fn, w, poisoned, yb, ones))
    assert diff <= 2 * C / B + 1e-6
    np.testing.assert_allclose(base, _ref_linear(C, w, xb, yb, ones),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("m", [4, 8, 16])
def test_noise_scale_is_zC_over_B(m):
    """Zero gradients: the output is N(0, (z·C/B)²), by its standard
    deviation (rel 0.05, the reference's check) and a Kolmogorov–Smirnov
    test at 1e-3, whatever the chunking; a new seed gives new noise."""
    z, C, B = 4.0, 2.0, 16
    fn = tdp.make_dp_sgd_grad_fn(Linear(), C, z, microbatch_size=m)
    w = np.zeros((64, 64), np.float32)
    xb = np.zeros((B, 64), np.float32)
    yb = np.zeros((B,), np.int64)
    g = _port_linear(fn, w, xb, yb, np.ones(B), noise_seed=7)
    sigma = z * C / B
    assert float(np.std(g)) == pytest.approx(sigma, rel=0.05)
    assert stats.kstest(g.ravel() / sigma, "norm").pvalue > 1e-3
    assert not np.array_equal(
        g, _port_linear(fn, w, xb, yb, np.ones(B), noise_seed=8))


def test_local_training_dp_masks_exactly_the_padded_slots():
    """Through the trainer: a 32-slot shard holding 16 valid examples
    masks exactly 16 slots of the epoch out of the DP gradient. The probe
    gradient is the step's wmask.sum() on every element, so with plain SGD
    every parameter moves by lr·n_valid, client by client."""
    model = create_model("simple_cnn")
    lr = 0.5
    cfg = FederatedTrainingConfig(local_epochs=1, batch_size=8,
                                  optimizer_type="sgd", learning_rate=lr,
                                  momentum=0.0)

    def probe(params, xb, yb, wmask, dseed, nseed):
        s = wmask.sum(1)
        return {l: {k: s.reshape((-1,) + (1,) * (v.dim() - 1)).expand(
            v.shape).clone() for k, v in d.items()}
            for l, d in params.items()}

    fn = make_local_train_fn(model, cfg, 32, torch.zeros(1), torch.ones(1),
                             dp_sgd_fn=probe)
    init = model.init(torch.Generator().manual_seed(0), "cpu")
    params = {l: {k: v[None].expand(2, *v.shape).clone()
                  for k, v in d.items()} for l, d in init.items()}
    n_valid = torch.tensor([16, 32])
    out, _ = fn(params, torch.zeros((2, 32, 28, 28, 1), dtype=torch.uint8),
                torch.zeros((2, 32), dtype=torch.int64), n_valid, 1)
    w0 = params["conv1"]["kernel"]
    w1 = out["conv1"]["kernel"]
    want = lr * n_valid.float().reshape(2, 1, 1, 1, 1).expand(w0.shape)
    torch.testing.assert_close(w0 - w1, want, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# the two forms on SimpleCNN
# ---------------------------------------------------------------------------

def _cnn_inputs(C=2, B=8, seed=5):
    rng = np.random.default_rng(seed)
    xb = rng.normal(size=(C, B, 28, 28, 1)).astype(np.float32)
    yb = rng.integers(0, 10, (C, B))
    wmask = np.ones((C, B), np.float32)
    wmask[0, [1, B - 1]] = 0.0
    return xb, yb, wmask


@pytest.mark.parametrize("norm_chunk", [None, 4])
def test_ghost_equals_microbatch(norm_chunk):
    """The same noisy gradient from both forms, leaf by leaf (f32, z = 1.1,
    C = 0.7, two slots of client 0 masked)."""
    model = create_model("simple_cnn", dropout_rate=0.0)
    init = model.init(torch.Generator().manual_seed(0), "cpu")
    params = {l: {k: torch.stack([v, 1.1 * v]) for k, v in d.items()}
              for l, d in init.items()}
    xb, yb, wmask = (torch.from_numpy(a) for a in _cnn_inputs())
    micro = tdp.make_dp_sgd_grad_fn(model, 0.7, 1.1, microbatch_size=4)
    ghost = tdp.make_ghost_dp_sgd_grad_fn(model, 0.7, 1.1,
                                          norm_chunk=norm_chunk)
    gm = micro(params, xb, yb, wmask, 1, 2)
    gg = ghost(params, xb, yb, wmask, 1, 2)
    for l in gm:
        for k in gm[l]:
            np.testing.assert_allclose(gg[l][k].numpy(), gm[l][k].numpy(),
                                       err_msg=f"{l}/{k}", **F32)


@pytest.mark.parametrize("fused", [False, "residual"])
def test_per_example_clipped_sums_equal_the_reference(fused):
    """Noise off: the port's microbatch fold (and on False its ghost form)
    against the reference's make_dp_sgd_grad_fn on the JAX model with the
    same fused_conv_block, client by client (2 clients, the second's
    slots all valid), f32."""
    jmodel = jax_create_model("simple_cnn", fused_conv_block=fused,
                              dropout_rate=0.0)
    jparams = jmodel.init(jax.random.PRNGKey(0))["params"]

    def loss_fn(p, extra, xb, yb, dkey):
        logits, _ = jmodel.apply({"params": p, **extra}, xb, train=True,
                                 dropout_rng=dkey)
        return jax_ce(logits, yb), None

    C = 0.5
    xb, yb, wmask = _cnn_inputs(B=4)
    ref = jax.jit(jdp.make_dp_sgd_grad_fn(loss_fn, C, 0.0, 2))
    per_client = [jax.device_get(ref(
        jparams, {}, jnp.asarray(xb[c]), jnp.asarray(yb[c]),
        jnp.asarray(wmask[c]), jax.random.PRNGKey(0),
        jax.random.PRNGKey(1))) for c in range(2)]
    want = jax.tree.map(lambda *a: np.stack(a), *per_client)
    model = create_model("simple_cnn", fused_conv_block=fused,
                         dropout_rate=0.0)
    params = {l: {k: v[None].expand(2, *v.shape).clone()
                  for k, v in d.items()}
              for l, d in params_from_flax(jax.device_get(jparams)).items()}
    args = (params, torch.from_numpy(xb), torch.from_numpy(yb),
            torch.from_numpy(wmask), 1, 2)
    forms = [tdp.make_dp_sgd_grad_fn(model, C, 0.0, microbatch_size=2)]
    if fused is False:
        forms.append(tdp.make_ghost_dp_sgd_grad_fn(model, C, 0.0))
    for form in forms:
        got = params_to_flax(form(*args))
        for l in want:
            for k in want[l]:
                np.testing.assert_allclose(got[l][k], np.asarray(want[l][k]),
                                           err_msg=f"{l}/{k}", **F32)


# ---------------------------------------------------------------------------
# engine rounds against the JAX engine
# ---------------------------------------------------------------------------

C_CLIP = 0.05
QUIET = dict(epsilon=1e30, delta=1e-5, max_grad_norm=C_CLIP,
             noise_multiplier=1e-9)


def _arrays(num_clients=4, samples=16):
    kw = dict(num_clients=num_clients, strategy="iid",
              samples_per_client=samples, seed=0)
    return (jax_make_arrays(jax_load_dataset("mnist", n_train_synth=256,
                                             n_test_synth=64), **kw),
            make_federated_arrays(load_dataset("mnist", n_train_synth=256,
                                               n_test_synth=64), **kw))


def _engines(fused, impl, privacy=QUIET, batch=16, samples=16, **cfg):
    """A JAX dp_sgd engine of ``fused`` / ``impl`` and the port's, the
    port's from the JAX engine's initial parameters."""
    common = dict(dp_mode="dp_sgd", dp_sgd_impl=impl, dp_microbatch=8,
                  seed=0, **cfg)
    train = dict(local_epochs=1, batch_size=batch, learning_rate=1e-3)
    jarr, tarr = _arrays(samples=samples)
    jeng = JaxEngine(
        jax_create_model("simple_cnn", dtype=jnp.bfloat16,
                         fused_conv_block=fused, dropout_rate=0.0), jarr,
        JaxConfig(training=JaxTrainingConfig(optimizer_type="adam",
                                             **train),
                  privacy=JaxPrivacyConfig(**privacy), **common))
    return jeng, _port_engine(fused, impl, jeng, tarr, privacy, train,
                              common)


def _port_engine(fused, impl, jeng, tarr, privacy, train, common):
    teng = FederatedRoundEngine(
        create_model("simple_cnn", dtype=torch.bfloat16, dropout_rate=0.0,
                     fused_conv_block=fused), tarr,
        RoundEngineConfig(training=FederatedTrainingConfig(**train),
                          privacy=PrivacyConfig(**privacy),
                          **dict(common, dp_sgd_impl=impl)),
        device="cpu")
    teng.global_variables = {"params": params_from_flax(
        jax.device_get(jeng.global_variables["params"]))}
    return teng


@pytest.fixture(scope="module")
def jax_dp_sgd_round():
    """One round of the JAX engine's ghost form on the unfused bf16 model
    (its ghost and microbatch forms agree to rtol 2e-4, so one reference
    round serves the port's forms on every formulation)."""
    jeng, _ = _engines(False, "ghost")
    init = params_from_flax(jax.device_get(jeng.global_variables["params"]))
    return jeng, init, jeng.run_round(evaluate=False)


@pytest.fixture(scope="module", params=[("residual", "microbatch"),
                                        (False, "ghost"),
                                        (False, "microbatch")], ids=str)
def dp_sgd_round(request, jax_dp_sgd_round):
    fused, impl = request.param
    jeng, init, jr = jax_dp_sgd_round
    _, tarr = _arrays()
    teng = _port_engine(
        fused, impl, jeng, tarr, QUIET,
        dict(local_epochs=1, batch_size=16, learning_rate=1e-3),
        dict(dp_mode="dp_sgd", dp_microbatch=8, seed=0))
    # the reference round's starting point
    teng.global_variables = {"params": init}
    scales = []
    clip_scale = tdp._clip_scale

    def spy(sq, c, wmask):
        out = clip_scale(sq, c, wmask)
        scales.append(out.detach().clone())
        return out

    tdp._clip_scale = spy
    try:
        tr = teng.run_round(evaluate=False)
    finally:
        tdp._clip_scale = clip_scale
    return dict(jeng=jeng, teng=teng, jr=jr, tr=tr, scales=scales)


def test_dp_sgd_round_matches_jax(dp_sgd_round):
    r = dp_sgd_round
    # every example of the step was clipped: C sits well below its norm
    scales = torch.cat([s.ravel() for s in r["scales"]])
    assert scales.numel() == 4 * 16 and (scales < 0.5).all(), scales
    np.testing.assert_allclose(r["tr"].train_loss, r["jr"].train_loss,
                               rtol=5e-2)
    jp = jax.device_get(r["jeng"].global_variables["params"])
    tp = params_to_flax(r["teng"].global_variables["params"])
    for l in jp:
        for k in jp[l]:
            np.testing.assert_allclose(tp[l][k], np.asarray(jp[l][k]),
                                       rtol=2e-2, atol=1e-3,
                                       err_msg=f"{l}/{k}")


def test_dp_sgd_round_charges_the_reference_epsilon(dp_sgd_round):
    r = dp_sgd_round
    assert r["tr"].epsilon_spent == r["jr"].epsilon_spent
    assert r["teng"].certified_epsilon() == r["jeng"].certified_epsilon()
    jl = r["jeng"].accountant.get_privacy_ledger()[-1]
    tl = r["teng"].accountant.get_privacy_ledger()[-1]
    for key in ("mechanism_type", "epsilon", "delta", "sensitivity",
                "noise_scale", "metadata"):
        assert tl[key] == jl[key], key


def test_dp_sgd_pld_step_budget_equals_the_reference():
    """accountant='pld' under dp_sgd: q = batch/shard = 0.5, two
    invocations a round; the certified step count and the refusal at the
    round that would pass it equal the reference's."""
    priv = dict(epsilon=4.0, delta=1e-5, max_grad_norm=1.0,
                noise_multiplier=1.5)
    kw = dict(accountant="pld", pld_dt=1e-3)
    jeng, teng = _engines(False, "auto", privacy=priv, batch=8, **kw)
    assert teng._rdp_round_params() == jeng._rdp_round_params() == (0.5, 2)
    budget = teng._pld_step_budget()
    assert budget == jeng._pld_step_budget()
    assert 2 <= budget < 40
    teng._pld_steps_taken = jeng._pld_steps_taken = budget - 1
    with pytest.raises(jdp.PrivacyError) as want:
        jeng._dispatch_round(np.ones(4, np.float32))
    with pytest.raises(tdp.PrivacyError) as got:
        teng._dispatch_round(np.ones(4, np.float32))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def test_dp_sgd_impl_rules_raise_the_reference_messages():
    priv = dict(epsilon=8.0, delta=1e-5, max_grad_norm=1.0,
                noise_multiplier=1.0)
    jarr, tarr = _arrays()

    def both(jmodel, tmodel, **kw):
        cfg = dict(dp_mode="dp_sgd", **kw)
        with pytest.raises(ValueError) as want:
            JaxEngine(jmodel, jarr, JaxConfig(
                privacy=JaxPrivacyConfig(**priv), **cfg))
        with pytest.raises(ValueError) as got:
            FederatedRoundEngine(tmodel, tarr, RoundEngineConfig(
                privacy=PrivacyConfig(**priv), **cfg), device="cpu")
        assert str(got.value) == str(want.value)

    both(jax_create_model("simple_cnn"), create_model("simple_cnn"),
         dp_sgd_impl="exact")

    class Untapped(SimpleCNN):
        name = "cifar10_cnn"
        DP_LAYERS = None

    both(jax_create_model("cifar10_cnn"), Untapped(), dp_sgd_impl="ghost")
    assert not tdp.model_supports_ghost_dp(Untapped())
    assert tdp.model_supports_ghost_dp(create_model("simple_cnn"))


@pytest.mark.parametrize("fused", [True, "residual"])
def test_fused_model_refuses_the_taps_with_the_reference_message(fused):
    jmodel = jax_create_model("simple_cnn", fused_conv_block=fused)
    variables = jmodel.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as want:
        jmodel.module.apply(variables, jnp.zeros((1, 28, 28, 1)),
                            dp_capture=True)
    model = create_model("simple_cnn", fused_conv_block=fused)
    params = {l: {k: v[None] for k, v in d.items()} for l, d in
              model.init(torch.Generator().manual_seed(0), "cpu").items()}
    for kw in (dict(dp_capture=True),
               dict(dp_perturb=model.dp_preactivation_shapes(1, 1))):
        with pytest.raises(ValueError) as got:
            model(params, torch.zeros((1, 1, 28, 28, 1)), **kw)
        assert str(got.value) == str(want.value)


def test_taps_leave_the_forward_unchanged_and_give_the_layer_gradients():
    """On the unfused model: zero perturbations and the captures change no
    logit; the gradient with respect to a perturbation is the gradient with
    respect to that layer's pre-activation, so fc2's equals
    softmax − onehot for each example; the captured fc2 input is fc1's
    relu output."""
    model = create_model("simple_cnn", dropout_rate=0.0)
    params = {l: {k: v[None] for k, v in d.items()} for l, d in
              model.init(torch.Generator().manual_seed(3), "cpu").items()}
    x = torch.randn(1, 3, 28, 28, 1, generator=torch.Generator()
                    .manual_seed(4))
    y = torch.tensor([[1, 7, 3]])
    plain = model(params, x)
    shapes = model.dp_preactivation_shapes(1, 3)
    zeros = {n: torch.zeros(s, requires_grad=True) for n, s in shapes.items()}
    logits, caps = model(params, x, dp_perturb=zeros, dp_capture=True)
    assert torch.equal(logits, plain)
    assert {n: tuple(t.shape) for n, t in caps.items()} == {
        "conv1": (1, 3, 28, 28, 1), "conv2": (1, 3, 14, 14, 32),
        "fc1": (1, 3, 3136), "fc2": (1, 3, 128)}
    assert (caps["fc2"] >= 0).all()
    dy = torch.autograd.grad(tdp.per_example_losses(logits, y).sum(),
                             zeros["fc2"])[0]
    want = torch.softmax(plain, -1) - torch.nn.functional.one_hot(y, 10)
    torch.testing.assert_close(dy, want, rtol=1e-5, atol=1e-6)
