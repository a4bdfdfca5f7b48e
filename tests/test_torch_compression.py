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
- ``_orthonormalize`` within rtol 1e-5 / atol 1e-6, the degenerate column
  zeroed on both sides; ``powersgd_roundtrip`` and its error-feedback step
  against a float64 evaluation of the same steps, each package within the
  f32 forward-error bound c·γ_K·(|P|·|Pᵀ|·|M|) of its products (the
  reference's f32 einsums and the port's ``torch.bmm`` sum in other
  orders), and the two within the sum of their bounds; the plan equal
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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# f32 unit roundoff: the forward-error bound of a K-long f32 product is
# |ŷ − y| ≤ γ_K·(|A|·|B|), γ_K = K·u / (1 − K·u) (Higham, Thm. 3.5)
_U32 = 2.0 ** -24
# one constant over the roundtrip's three stages (M·Q, modified
# Gram–Schmidt, Mᵀ·P and P·Qᵀ); both packages stay under 2.2 of it
_STAGES = 4.0


def _gamma(k):
    return k * _U32 / (1.0 - k * _U32)


def _orthonormalize_f64(p):
    """``_orthonormalize`` in float64 with numpy: the same modified
    Gram–Schmidt and the same degenerate-column rule."""
    cols = []
    for i in range(p.shape[-1]):
        v = p[:, :, i]
        orig = np.sqrt(np.sum(v * v, axis=1, keepdims=True))
        for u in cols:
            v = v - np.sum(v * u, axis=1, keepdims=True) * u
        norm = np.sqrt(np.sum(v * v, axis=1, keepdims=True))
        cols.append(np.where(norm <= 1e-5 * orig + 1e-30, 0.0,
                             v / np.maximum(norm, 1e-30)))
    return np.stack(cols, axis=2)


def _roundtrip_f64(carried, q, plan):
    """``powersgd_roundtrip`` evaluated in float64 on the f32 inputs, and
    the elementwise forward-error bound of an f32 evaluation:

        |ŷ − y| ≤ c·γ_K·S,  K = max(n, m),  c = ``_STAGES``,

    with S = |P|·|Pᵀ|·|M| for the reconstruction P·Pᵀ·M and S = |Mᵀ|·|P|
    for the new Q = Mᵀ·P (|·| elementwise, the products in float64). The
    columns that pass through uncopied get a bound of 0. Returns (out, qn,
    out bound, qn bound)."""
    c, r = carried.shape[0], plan.rank
    carried = carried.astype(np.float64)
    q = q.astype(np.float64)
    out, qn = carried.copy(), q.copy()
    out_b, qn_b = np.zeros_like(out), np.zeros_like(qn)
    for e in plan.entries:
        cols = slice(e.offset, e.offset + e.n * e.m)
        qcols = slice(e.q_offset, e.q_offset + e.m * r)
        mat = carried[:, cols].reshape(c, e.n, e.m)
        p = _orthonormalize_f64(mat @ q[:, qcols].reshape(c, e.m, r))
        qe = mat.transpose(0, 2, 1) @ p
        out[:, cols] = (p @ qe.transpose(0, 2, 1)).reshape(c, -1)
        qn[:, qcols] = qe.reshape(c, -1)
        g = _STAGES * _gamma(max(e.n, e.m))
        ap = np.abs(p)
        out_b[:, cols] = g * (ap @ (ap.transpose(0, 2, 1) @ np.abs(mat))
                              ).reshape(c, -1)
        qn_b[:, qcols] = g * (np.abs(mat).transpose(0, 2, 1) @ ap
                              ).reshape(c, -1)
    return out, qn, out_b, qn_b


def _within_bound(got, want, bound, what):
    err = np.abs(got.astype(np.float64) - want)
    bad = err > bound
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} of {bad.size} entries beyond the f32 "
        f"bound, the worst {float(err[bad].max()):.3g} against "
        f"{float(bound[bad][np.argmax(err[bad])]):.3g}")


@pytest.mark.parametrize("rank", [2, 4])
def test_powersgd_roundtrip_matches_jax(rank):
    """Each package against the float64 evaluation of the same steps within
    the f32 forward-error bound c·γ_K·S (``_roundtrip_f64``), and the two
    against each other within the sum of their bounds: the two sum the
    products up to K = 3,136 long in other orders, on outputs that nearly
    cancel, so neither equals the other to a fixed relative tolerance."""
    plan, jplan = _plans(rank)
    C = 3
    carried = _normal(10, (C, plan.d_pad))
    carried[:, plan.d:] = 0.0
    q = _normal(11, (C, plan.dq_pad))
    out, qn = ps.powersgd_roundtrip(torch.tensor(carried), torch.tensor(q),
                                    plan)
    jout, jqn = jps.powersgd_roundtrip(jnp.asarray(carried), jnp.asarray(q),
                                       jplan)
    out64, qn64, out_b, qn_b = _roundtrip_f64(carried, q, plan)
    for name, got, want, bound in (
            ("port out", out.numpy(), out64, out_b),
            ("jax out", np.asarray(jout), out64, out_b),
            ("port q", qn.numpy(), qn64, qn_b),
            ("jax q", np.asarray(jqn), qn64, qn_b)):
        _within_bound(got, want, bound, name)
    _within_bound(out.numpy(), np.asarray(jout, np.float64), 2 * out_b,
                  "port vs jax out")
    _within_bound(qn.numpy(), np.asarray(jqn, np.float64), 2 * qn_b,
                  "port vs jax q")
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
    # the float64 step from the same f32 carried = delta + e_t (one f32
    # add, the same on both sides); the new EF = carried − transmitted
    # adds one rounding, u·|carried − transmitted|, to the bound
    carried = delta + s0[:, :plan.d_pad]
    out64, qn64, out_b, qn_b = _roundtrip_f64(
        carried, s0[:, plan.d_pad:], plan)
    live = (mask > 0)[:, None]
    tx64 = np.where(live, out64, 0.0)
    tx_b = np.where(live, out_b, 0.0)
    new64 = np.concatenate([np.where(live, carried - tx64, s0[:, :plan.d_pad]),
                            np.where(live, qn64, s0[:, plan.d_pad:])], 1)
    new_b = np.concatenate([
        np.where(live, out_b + 2 * _U32 * np.abs(carried - tx64), 0.0),
        np.where(live, qn_b, 0.0)], 1)
    for name, got_tx, got_new in (("port", tx.numpy(), new.numpy()),
                                  ("jax", np.asarray(jtx),
                                   np.asarray(jnew))):
        _within_bound(got_tx, tx64, tx_b, f"{name} transmitted")
        _within_bound(got_new, new64, new_b, f"{name} state")
    _within_bound(tx.numpy(), np.asarray(jtx, np.float64), 2 * tx_b,
                  "port vs jax transmitted")
    _within_bound(new.numpy(), np.asarray(jnew, np.float64), 2 * new_b,
                  "port vs jax state")
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
