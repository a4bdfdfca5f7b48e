"""The port's compression family vs fl_tpu's, function by function.

The same numpy inputs, made from a seed, go through the JAX function and
its port on the CPU (neither side reaches a Pallas kernel: the reference's
uplink, top-k, PowerSGD and downlink are jnp / lax code):

- flatten: the columns of ``stack_flatten`` and the leaves of
  ``stack_unflatten`` identical, SimpleCNN's D = 421,642 and D_pad =
  421,760;
- ``int8_roundtrip_matrix`` bit-equal, on ragged D and on a block of zeros;
- ``topk_roundtrip_matrix`` equal on tie-free data; with ties, k kept a row
  and every kept |x| ≥ every dropped |x|;
- ``_orthonormalize`` and ``powersgd_roundtrip`` within rtol 1e-5 / atol
  1e-6 (the reference's f32 einsums and the port's ``torch.bmm`` sum in
  other orders), the degenerate column zeroed on both sides; the plan equal
  entry for entry;
- both error-feedback steps: the algebra exact to 1e-6, non-participants
  transmitting zero and keeping their state;
- the downlink's θ̂ bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl_tpu.fl import powersgd as jps
from fl_tpu.fl import uplink as jup
from fl_tpu.ops import flatten as jfl
from fl_tpu.ops import quantize as jq
from fl_tpu.ops import topk as jtk
from fl_tpu_torch.fl import powersgd as ps
from fl_tpu_torch.fl import uplink as up
from fl_tpu_torch.models import create_model, params_to_flax
from fl_tpu_torch.ops import flatten as fl
from fl_tpu_torch.ops import topk as tk
from fl_tpu_torch.orchestration.round_engine import downlink_roundtrip

SIMPLE_CNN_D = 421_642


def _normal(seed, shape, sigma=1.0):
    return np.random.default_rng(seed).normal(0, sigma, shape).astype(
        np.float32)


def _simple_cnn_tree(C=None, seed=0):
    """SimpleCNN's leaves (flax names and layouts) as numpy f32, random,
    with a client axis of C when C is given."""
    shapes = params_to_flax(create_model("simple_cnn").init(
        torch.Generator().manual_seed(0), "cpu"))
    rng = np.random.default_rng(seed)
    lead = () if C is None else (C,)
    return {l: {k: rng.normal(0, 0.1, lead + v.shape).astype(np.float32)
                for k, v in leaves.items()} for l, leaves in shapes.items()}


def _to_torch(tree, dtype=None):
    return {l: {k: torch.tensor(v, dtype=dtype) for k, v in leaves.items()}
            for l, leaves in tree.items()}


def _to_jax(tree, dtype=None):
    return {l: {k: jnp.asarray(v, dtype) for k, v in leaves.items()}
            for l, leaves in tree.items()}


# ---------------------------------------------------------------------------
# flatten
# ---------------------------------------------------------------------------

def test_flatten_columns_and_unflatten_match_jax():
    tree = _simple_cnn_tree(C=3)
    jt, tt = _to_jax(tree), _to_torch(tree)
    # one bf16 leaf: cast to f32 into the matrix, and back on unflatten
    jt["fc2"]["kernel"] = jt["fc2"]["kernel"].astype(jnp.bfloat16)
    tt["fc2"]["kernel"] = tt["fc2"]["kernel"].to(torch.bfloat16)
    jmat, jspec = jfl.stack_flatten(jt)
    mat, spec = fl.stack_flatten(tt)
    assert fl.flat_dim(tt) == jfl.flat_dim(jt) == SIMPLE_CNN_D
    assert fl.padded_dim(SIMPLE_CNN_D) == mat.shape[1] == 421_760
    assert mat.dtype == torch.float32
    np.testing.assert_array_equal(mat.numpy(), np.asarray(jmat))
    # unflatten a changed matrix, so the leaves are not the inputs
    new = _normal(1, tuple(mat.shape))
    jback = jfl.stack_unflatten(jnp.asarray(new), jspec)
    back = fl.stack_unflatten(torch.tensor(new), spec)
    for l in tree:
        for k in tree[l]:
            a, b = back[l][k], jback[l][k]
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))
    assert fl.flat_dim(_to_torch(_simple_cnn_tree()), batched=False) \
        == SIMPLE_CNN_D


# ---------------------------------------------------------------------------
# int8 and top-k uplinks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,D", [(3, 3000), (2, 4096), (4, 2048 * 3 + 128),
                                 (2, 1)])
def test_int8_roundtrip_is_bit_equal_to_jax(C, D):
    x = _normal(C * D, (C, D), sigma=2.0)
    if D > 2048:
        x[1, 2048:4096] = 0.0  # a block of zeros: scale clamps to 1e-12/127
    got = up.int8_roundtrip_matrix(torch.tensor(x))
    want = np.asarray(jup.int8_roundtrip_matrix(jnp.asarray(x)))
    assert tuple(got.shape) == (C, D)
    np.testing.assert_array_equal(got.numpy(), want)


def test_topk_roundtrip_matches_jax_without_ties():
    x = _normal(3, (4, 1000))
    got = up.topk_roundtrip_matrix(torch.tensor(x), 37)
    want = np.asarray(jup.topk_roundtrip_matrix(jnp.asarray(x), 37))
    np.testing.assert_array_equal(got.numpy(), want)
    assert ((got != 0).sum(1) == 37).all()


def test_topk_with_ties_keeps_k_and_the_largest():
    """Ties at the threshold may be broken another way than lax.top_k's;
    what must hold is k kept a row and no dropped |x| above a kept one."""
    x = np.round(_normal(4, (3, 500)), 1)  # many equal magnitudes
    x[x == 0] = 0.1  # no zeros: a kept entry reads as non-zero
    x[0, :50] = 0.7
    x[0, 50:100] = -0.7
    for k in (10, 60, 499):
        got = up.topk_roundtrip_matrix(torch.tensor(x), k).numpy()
        kept = got != 0
        assert (kept.sum(1) == k).all()
        for r in range(3):
            assert np.abs(x[r][kept[r]]).min() >= np.abs(x[r][~kept[r]]).max()
            np.testing.assert_array_equal(got[r][kept[r]], x[r][kept[r]])


def test_topk_sparsify_densify_ratio_match_jax():
    x = _normal(5, (777,))
    for ratio in (0.9, 0.5, 0.0, 0.9995):
        v, i = tk.topk_sparsify_ratio(torch.tensor(x), ratio)
        jv, ji = jtk.topk_sparsify_ratio(jnp.asarray(x), ratio)
        assert i.dtype == torch.int32 and len(i) == len(ji)
        assert set(i.tolist()) == set(np.asarray(ji).tolist())
        np.testing.assert_array_equal(
            tk.topk_densify(v, i, 777).numpy(),
            np.asarray(jtk.topk_densify(jv, ji, 777)))
    # k = round(d·(1 − ratio)), Python's round: 777·0.5 = 388.5 → 388
    assert len(tk.topk_sparsify_ratio(torch.tensor(x), 0.5)[1]) == 388


def test_make_uplink_fn_budget_and_refusals():
    x = torch.tensor(_normal(6, (2, fl.padded_dim(SIMPLE_CNN_D))))
    out = up.make_uplink_fn("topk", 0.01, d_valid=SIMPLE_CNN_D)(x)
    assert ((out != 0).sum(1) == 4216).all()
    assert up.make_uplink_fn("none")(x) is x
    assert up.make_uplink_fn("int8") is up.int8_roundtrip_matrix
    assert up.UPLINK_KINDS == jup.UPLINK_KINDS
    with pytest.raises(ValueError, match="powersgd carries"):
        up.make_uplink_fn("powersgd")
    with pytest.raises(ValueError, match="unknown uplink compression"):
        up.make_uplink_fn("gzip")


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_error_feedback_step_matches_jax_and_respects_mask(kind):
    C, D = 4, 3000
    delta, ef = _normal(7, (C, D)), _normal(8, (C, D), 0.5)
    mask = np.array([1, 0, 1, 1], np.float32)
    fn = up.make_uplink_fn(kind, 0.05, d_valid=D - 11)
    tx, new_ef = up.apply_uplink_with_error_feedback(
        torch.tensor(delta), torch.tensor(ef), torch.tensor(mask), fn)
    jtx, jef = jup.apply_uplink_with_error_feedback(
        jnp.asarray(delta), jnp.asarray(ef), jnp.asarray(mask),
        jup.make_uplink_fn(kind, 0.05, d_valid=D - 11))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jtx), atol=1e-6)
    np.testing.assert_allclose(new_ef.numpy(), np.asarray(jef), atol=1e-6)
    # the algebra: transmitted + new EF = delta + old EF for participants
    np.testing.assert_allclose((tx + new_ef).numpy()[mask > 0],
                               (delta + ef)[mask > 0], atol=1e-6)
    assert (tx[1] == 0).all() and torch.equal(new_ef[1], torch.tensor(ef[1]))


# ---------------------------------------------------------------------------
# PowerSGD
# ---------------------------------------------------------------------------

def _plans(rank):
    tree = _simple_cnn_tree()
    return (ps.make_powersgd_plan(_to_torch(tree), rank),
            jps.make_powersgd_plan({"params": _to_jax(tree)}, rank))


@pytest.mark.parametrize("rank", [1, 4, 16])
def test_plan_matches_jax_entry_for_entry(rank):
    plan, jplan = _plans(rank)
    assert (plan.rank, plan.d, plan.d_pad, plan.dq_pad) == \
        (jplan.rank, jplan.d, jplan.d_pad, jplan.dq_pad)
    assert [tuple(vars(e).values()) for e in plan.entries] == \
        [tuple(vars(e).values()) for e in jplan.entries]
    assert plan.compressed_floats() == jplan.compressed_floats()
    if rank == 4:
        # all four kernels compressed: 936 Q columns, padded to 1,024; a
        # client sends 15,414 floats instead of 421,642
        assert [(e.n, e.m) for e in plan.entries] == [
            (9, 32), (288, 64), (3136, 128), (128, 10)]
        assert plan.dq_pad == 1024 and plan.compressed_floats() == 15_414


def test_plan_refuses_rank_below_one():
    with pytest.raises(ValueError, match="powersgd rank must be ≥ 1"):
        ps.make_powersgd_plan(_to_torch(_simple_cnn_tree()), 0)


def test_orthonormalize_matches_jax_with_a_degenerate_column():
    p = _normal(9, (3, 50, 4))
    p[1, :, 2] = 2.0 * p[1, :, 0] - p[1, :, 1]  # in the span: zeroed
    p[2, :, 3] = 0.0                             # zero column: zeroed
    got = ps._orthonormalize(torch.tensor(p)).numpy()
    want = np.asarray(jps._orthonormalize(jnp.asarray(p)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (got[1, :, 2] == 0).all() and (got[2, :, 3] == 0).all()
    np.testing.assert_allclose(got[0].T @ got[0], np.eye(4), atol=1e-5)


@pytest.mark.parametrize("rank", [2, 4])
def test_powersgd_roundtrip_matches_jax(rank):
    plan, jplan = _plans(rank)
    C = 3
    carried = _normal(10, (C, plan.d_pad))
    carried[:, plan.d:] = 0.0
    q = _normal(11, (C, plan.dq_pad))
    out, qn = ps.powersgd_roundtrip(torch.tensor(carried), torch.tensor(q),
                                    plan)
    jout, jqn = jps.powersgd_roundtrip(jnp.asarray(carried), jnp.asarray(q),
                                       jplan)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(qn.numpy(), np.asarray(jqn), rtol=1e-5,
                               atol=1e-6)
    # leaves outside every entry (biases, lane padding) pass through
    covered = np.zeros(plan.d_pad, bool)
    for e in plan.entries:
        covered[e.offset:e.offset + e.n * e.m] = True
    np.testing.assert_array_equal(out.numpy()[:, ~covered],
                                  carried[:, ~covered])


def test_powersgd_roundtrip_transmits_low_rank_exactly():
    """A leaf delta of rank below r is reproduced (the projection onto
    col(MQ) is col(M)); the degenerate direction is zeroed, not blown up."""
    plan, _ = _plans(4)
    rng = np.random.default_rng(12)
    carried = np.zeros((2, plan.d_pad), np.float32)
    for e in plan.entries:
        low = rng.normal(size=(2, e.n, 2)) @ rng.normal(size=(2, 2, e.m))
        carried[:, e.offset:e.offset + e.n * e.m] = low.reshape(2, -1)
    q = torch.randn((2, plan.dq_pad), generator=torch.Generator()
                    .manual_seed(0))
    out, _ = ps.powersgd_roundtrip(torch.tensor(carried), q, plan)
    np.testing.assert_allclose(out.numpy(), carried, atol=2e-4)


def test_powersgd_state_lies_on_its_generators_device():
    """The initial state is drawn on the generator's device, with no
    device argument that could disagree with it."""
    plan, _ = _plans(2)
    gen = torch.Generator().manual_seed(1)
    state = ps.init_uplink_state(gen, plan, 3)
    assert state.device == gen.device
    again = ps.init_uplink_state(torch.Generator().manual_seed(1), plan, 3)
    assert torch.equal(state, again)
    with pytest.raises(TypeError):
        ps.init_uplink_state(gen, plan, 3, "cpu")


def test_powersgd_error_feedback_matches_jax_and_respects_mask():
    plan, jplan = _plans(4)
    C = 4
    state = ps.init_uplink_state(torch.Generator().manual_seed(3), plan, C)
    assert tuple(state.shape) == (C, plan.d_pad + plan.dq_pad)
    assert (state[:, :plan.d_pad] == 0).all()
    state[:, :plan.d_pad] = torch.tensor(_normal(13, (C, plan.d_pad), 0.1))
    state[:, plan.d:plan.d_pad] = 0.0
    delta = _normal(14, (C, plan.d_pad))
    delta[:, plan.d:] = 0.0
    mask = np.array([1, 1, 0, 1], np.float32)
    s0 = state.numpy().copy()
    tx, new = ps.apply_powersgd_with_error_feedback(
        torch.tensor(delta), state, torch.tensor(mask), plan)
    jtx, jnew = jps.apply_powersgd_with_error_feedback(
        jnp.asarray(delta), jnp.asarray(s0), jnp.asarray(mask), jplan)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jtx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), rtol=1e-5,
                               atol=1e-6)
    ef = new.numpy()[:, :plan.d_pad]
    live = mask > 0
    np.testing.assert_allclose((tx.numpy() + ef)[live],
                               (delta + s0[:, :plan.d_pad])[live], atol=1e-6)
    assert (tx[2] == 0).all()
    np.testing.assert_array_equal(new.numpy()[2], s0[2])


# ---------------------------------------------------------------------------
# downlink
# ---------------------------------------------------------------------------

def _jax_downlink(x, kind):
    """The reference's downlink_ref (fl_tpu/orchestration/round_engine.py,
    the superstep's θ̂)."""
    if kind == "int8":
        q, s, zp = jq.quantize_affine(x, bits=8, symmetric=True)
        return jq.dequantize_affine(q, s, zp, symmetric=True).astype(x.dtype)
    return x.astype(jnp.bfloat16).astype(x.dtype)


@pytest.mark.parametrize("kind", ["int8", "bfloat16"])
def test_downlink_is_bit_equal_to_jax(kind):
    tree = _simple_cnn_tree(seed=15)
    tree["conv1"]["bias"][:] = 0.0  # an all-zero leaf: scale clamps
    for l, leaves in tree.items():
        for k, v in leaves.items():
            got = downlink_roundtrip(torch.tensor(v), kind)
            want = jax.jit(_jax_downlink, static_argnums=1)(jnp.asarray(v),
                                                             kind)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{l}/{k}")
