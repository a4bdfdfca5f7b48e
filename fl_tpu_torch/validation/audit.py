"""One-run empirical privacy auditing: measured ε lower bounds.

The port of ``fl_tpu.validation.audit``: the client-level audit of Steinke,
Nasr & Jagielski, "Privacy Auditing with One (1) Training Run" (NeurIPS
2023). ``m`` canary clients are independently included or excluded with
probability ½ in a SINGLE federated training run; a score ranks canaries
by apparent membership, and the number of correct membership guesses
yields a high-confidence lower bound on the client-level ε the run
actually provides (the dominating-binomial tail of their Theorem 5.2,
with ``m·δ`` slack for (ε, δ)-DP, which only weakens the bound).

A correct DP implementation keeps ``audited ε ≤ certified ε``; a violation
proves an accounting or mechanism bug (wrong sensitivity, reused noise, a
missing clip).

The statistics and the canary construction are numpy and equal the
reference's bit for bit (the update canaries are drawn leaf by leaf in
flax's flatten order, and the port keeps flax's layouts). The scores are
PyTorch on the engine's device: update canaries inject through the round
engine's ``audit_injection`` hook and are scored by a projection of the
released delta; data canaries are scored by autograd through the port's
model. The ``mesh`` argument is refused until the port shards clients
over several GPUs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fl_tpu_torch.core.pytree import (
    tree_from_leaves, tree_get, tree_leaves, tree_map, tree_paths)
from fl_tpu_torch.data.federated import FederatedArrays

# ---------------------------------------------------------------------------
# Statistical machinery (pure, exactly testable)
# ---------------------------------------------------------------------------


def binomial_sf(v: int, r: int, p: float) -> float:
    """P[Binomial(r, p) ≥ v], exact (lgamma log-pmf accumulation)."""
    if v <= 0:
        return 1.0
    if v > r:
        return 0.0
    if p <= 0.0:
        return 0.0
    if p >= 1.0:
        return 1.0
    log_p, log_q = math.log(p), math.log1p(-p)
    lg_r = math.lgamma(r + 1)
    total = 0.0
    for k in range(v, r + 1):
        log_pmf = (lg_r - math.lgamma(k + 1) - math.lgamma(r - k + 1)
                   + k * log_p + (r - k) * log_q)
        total += math.exp(log_pmf)
    return min(1.0, total)


def audit_tail_probability(num_correct: int, num_guesses: int,
                           epsilon: float) -> float:
    """The Thm 5.2 dominating tail: P[C ≥ c] under ε-DP with r guesses."""
    p = math.exp(epsilon) / (1.0 + math.exp(epsilon))
    return binomial_sf(num_correct, num_guesses, p)


def empirical_epsilon_lower_bound(
    num_correct: int,
    num_guesses: int,
    num_canaries: int,
    delta: float = 0.0,
    confidence: float = 0.95,
    eps_max: float = 50.0,
) -> float:
    """Largest ε refuted at the given confidence by ``num_correct`` correct
    membership guesses out of ``num_guesses`` (Steinke et al. 2023, Thm
    5.2; ``num_canaries·delta`` slack per §5.3 — conservative).

    Returns 0.0 when the observation is consistent with every ε ≥ 0 (the
    attack found no signal), and ``eps_max`` when even that is refuted.
    """
    if not 0 <= num_correct <= num_guesses:
        raise ValueError("need 0 <= num_correct <= num_guesses")
    if num_guesses == 0:
        return 0.0
    beta = 1.0 - confidence
    slack = num_canaries * delta

    def rejected(eps: float) -> bool:
        return (audit_tail_probability(num_correct, num_guesses, eps)
                + slack) <= beta

    if not rejected(0.0):
        return 0.0
    if rejected(eps_max):
        return eps_max
    lo, hi = 0.0, eps_max  # rejected(lo), not rejected(hi)
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if rejected(mid):
            lo = mid
        else:
            hi = mid
    return lo


def canary_guesses(scores: np.ndarray, k_pos: int, k_neg: int) -> np.ndarray:
    """Guess vector from membership scores: the ``k_pos`` highest scores are
    guessed IN (+1), the ``k_neg`` lowest OUT (−1), the rest abstain (0).
    Abstaining on uncertain canaries strengthens the bound (Thm 5.2 is in
    terms of non-abstentions r, and mid-ranked scores are coin flips)."""
    m = len(scores)
    if k_pos + k_neg > m:
        raise ValueError("k_pos + k_neg cannot exceed the canary count")
    order = np.argsort(scores)  # ascending
    guesses = np.zeros(m, np.int8)
    if k_neg:
        guesses[order[:k_neg]] = -1
    if k_pos:
        guesses[order[m - k_pos:]] = 1
    return guesses


# ---------------------------------------------------------------------------
# Canary construction + scoring
# ---------------------------------------------------------------------------


def append_canary_clients(
    data: FederatedArrays,
    num_canaries: int,
    canary_samples: int,
    seed: int = 0,
) -> FederatedArrays:
    """Append ``num_canaries`` canary clients holding i.i.d. uniform-random
    images with uniform-random labels: random data is maximally
    memorization-sensitive, so the membership signal is strong when privacy
    is weak. ``data`` holds host (numpy) arrays."""
    if canary_samples > data.samples_per_client:
        raise ValueError(
            f"canary_samples={canary_samples} exceeds the padded shard "
            f"length {data.samples_per_client}")
    rng = np.random.default_rng(seed)
    n = data.samples_per_client
    img_shape = data.images.shape[2:]
    imgs = np.zeros((num_canaries, n) + img_shape, np.uint8)
    labs = np.zeros((num_canaries, n), np.int32)
    imgs[:, :canary_samples] = rng.integers(
        0, 256, (num_canaries, canary_samples) + img_shape, dtype=np.uint8)
    labs[:, :canary_samples] = rng.integers(
        0, data.num_classes, (num_canaries, canary_samples), dtype=np.int32)
    counts = np.full((num_canaries,), canary_samples, np.int32)
    return dataclasses.replace(
        data,
        images=np.concatenate([np.asarray(data.images), imgs]),
        labels=np.concatenate([np.asarray(data.labels), labs]),
        num_samples=np.concatenate([np.asarray(data.num_samples), counts]),
    )


def make_update_canaries(variables, num_canaries: int, scale: float,
                         seed: int = 0):
    """Random directions on the sphere of radius ``scale`` in the model's
    full variable space, one per canary, stacked on a leading axis: a tree
    like ``variables`` (``{"params": {layer: {leaf}}}``, and a BatchNorm
    model's ``batch_stats``) of f32 tensors on its device. Drawn leaf by leaf in flax's flatten order with numpy, so
    they equal the reference's directions for a seed.

    Random directions in the ~4·10⁵-dimensional parameter space are near
    orthogonal to each other and to every real client's update, so the
    released aggregate's projection onto a canary's direction isolates that
    canary's own contribution plus the mechanism's noise (Steinke et al.
    2023 §6)."""
    rng = np.random.default_rng(seed)
    paths = tree_paths(variables)
    outs = [rng.standard_normal(
        (num_canaries,) + tuple(leaf.shape)).astype(np.float32)
        for leaf in tree_leaves(variables)]
    sq = sum((o.reshape(num_canaries, -1) ** 2).sum(axis=1) for o in outs)
    norm = np.sqrt(sq)
    outs = [o * (scale / norm).reshape((num_canaries,) + (1,) * (o.ndim - 1))
            for o in outs]
    return tree_from_leaves(paths, [
        torch.from_numpy(o).to(tree_get(variables, p).device)
        for p, o in zip(paths, outs)])


def make_update_dot_fn():
    """⟨released global delta, canary direction⟩ for a stacked
    canary-direction tree: the sufficient statistic for update-canary
    membership (the mechanism's noise contributes N(0, σ²·scale²) to each
    dot; a participating canary adds its full clipped magnitude). Returns
    ``dot_fn(old_vars, new_vars, directions) -> (m,) f32 tensor``."""

    @torch.no_grad()
    def dot_fn(old_vars, new_vars, directions):
        total = None
        for p in tree_paths(directions):
            d = tree_get(directions, p)
            delta = (tree_get(new_vars, p).float()
                     - tree_get(old_vars, p).float())
            dots = d.reshape(d.shape[0], -1) @ delta.reshape(-1)
            total = dots if total is None else total + dots
        return total

    return dot_fn


def _normalize_u8(x_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 NHWC -> normalized float32 (as ``fl_tpu.ops.preprocess.
    normalize_u8``)."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x_u8.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x_u8.device)
    return (x_u8.float() / 255.0 - mean) / std


def _canary_losses(model, stacked_params, x_u8, labels, counts, mean, std):
    """(m,) mean softmax cross-entropy of each canary's first ``counts``
    samples under its own slice of ``stacked_params`` (eval mode)."""
    logits = model(stacked_params, _normalize_u8(x_u8, mean, std),
                   train=False)
    m, n, k = logits.shape
    per = F.cross_entropy(logits.reshape(m * n, k),
                          labels.reshape(-1).long(),
                          reduction="none").reshape(m, n)
    msk = (torch.arange(n, device=per.device)[None]
           < counts.reshape(m, 1)).float()
    return (per * msk).sum(1) / torch.clamp(msk.sum(1), min=1.0)


def _broadcast(params, m: int):
    """Each leaf repeated over a new leading canary axis of size m."""
    return tree_map(lambda v: v.detach()[None].expand(
        (m,) + tuple(v.shape)).clone(), params)


def _canary_batch(images, labels, counts, device):
    return (torch.as_tensor(np.asarray(images)).to(device),
            torch.as_tensor(np.asarray(labels)).to(device),
            torch.as_tensor(np.asarray(counts)).to(device))


def make_canary_dot_fn(model):
    """Per-round membership evidence: the projection of the realized
    global update onto each canary's unit-normalized loss gradient at the
    round's starting model, ⟨θ_t − θ_{t+1}, ∇L_i(θ_t)/‖∇L_i(θ_t)‖⟩. Large
    and positive when the round moved the model down canary i's descent
    direction, which only the canary's own participation produces; it
    survives FedAvg's 1/m dilution. The m gradients are one autograd pass
    over the model broadcast to m stacked clients. Returns
    ``dot_fn(old_vars, new_vars, images, labels, counts, mean, std) ->
    (m,) f32 tensor``."""

    def dot_fn(old_vars, new_vars, images, labels, counts, mean, std):
        old, new = old_vars["params"], new_vars["params"]
        paths = tree_paths(old)
        device = tree_get(old, paths[0]).device
        x, y, c = _canary_batch(images, labels, counts, device)
        m = x.shape[0]
        stacked = _broadcast(old, m)
        leaves = [tree_get(stacked, p).requires_grad_(True) for p in paths]
        loss = _canary_losses(model, stacked, x, y, c, mean, std)
        grads = torch.autograd.grad(loss.sum(), leaves)
        with torch.no_grad():
            flat = [g.reshape(m, -1) for g in grads]
            norm = torch.sqrt(sum((g * g).sum(1) for g in flat))
            moved = [(tree_get(old, p) - tree_get(new, p)).float()
                     .reshape(-1) for p in paths]
            dots = sum(g @ mv for g, mv in zip(flat, moved))
            return dots / torch.clamp(norm, min=1e-12)

    return dot_fn


def make_canary_score_fn(model):
    """Black-box per-canary score: the mean loss drop between two variable
    sets on each canary's own (masked) samples; higher = more evidence the
    canary was trained on. Weaker than :func:`make_canary_dot_fn` but needs
    only query access to the two models. Returns ``score_fn(init_vars,
    final_vars, images, labels, counts, mean, std) -> (m,) f32 tensor``."""

    @torch.no_grad()
    def score_fn(init_vars, final_vars, images, labels, counts, mean, std):
        init, final = init_vars["params"], final_vars["params"]
        device = tree_leaves(init)[0].device
        x, y, c = _canary_batch(images, labels, counts, device)
        m = x.shape[0]
        return (_canary_losses(model, _broadcast(init, m), x, y, c, mean,
                               std)
                - _canary_losses(model, _broadcast(final, m), x, y, c, mean,
                                 std))

    return score_fn


# ---------------------------------------------------------------------------
# The audit harness
# ---------------------------------------------------------------------------


def run_client_membership_audit(
    model,
    data: FederatedArrays,
    config,
    num_canaries: int = 16,
    num_rounds: int = 10,
    canary_samples: int = 8,
    guess_fraction: float = 0.25,
    confidence: float = 0.95,
    seed: int = 0,
    mesh=None,
    canary_kind: str = "update",
    score_method: str = "grad_dot",
    device="cuda",
) -> Dict[str, Any]:
    """Audit one training run of :class:`FederatedRoundEngine` for
    client-level privacy; returns the measured ε lower bound beside the
    accountant's certified ε. The engine runs on ``device`` (the GPU unless
    the caller asks for the CPU).

    - ``canary_kind="update"`` (default, requires ``dp_mode="client_dp"``):
      each canary client submits a fixed random direction of norm equal to
      the clip bound through the production round (the engine's
      ``audit_injection`` hook replaces the canary's trained delta ahead of
      the central clip), scored by the released round delta's projection
      onto its direction, summed over rounds.
    - ``canary_kind="data"``: canaries holding random out-of-distribution
      examples, scored by ``score_method`` (``"grad_dot"`` or
      ``"loss_drop"``); any dp_mode but dp_sgd, including ``"none"`` and
      ``"delta"``. A loose audit under-estimates ε, the safe direction.

    Canary inclusion bits are i.i.d. uniform, as the theorem requires;
    participation masks keep Bernoulli(q) sampling for every client, with
    excluded canaries forced out.
    """
    from fl_tpu_torch.orchestration.round_engine import FederatedRoundEngine

    if config.dp_mode == "dp_sgd":
        raise ValueError(
            "dp_sgd certifies example-level DP; a client-level canary "
            "audit would not lower-bound it. Audit dp_mode='client_dp', "
            "'delta', or 'none'.")
    if mesh is not None:
        raise ValueError("mesh: the port does not shard clients over "
                         "several GPUs yet; run the audit with mesh=None")
    if canary_kind not in ("update", "data"):
        raise ValueError("canary_kind must be 'update' or 'data'")
    if score_method not in ("grad_dot", "loss_drop"):
        raise ValueError("score_method must be 'grad_dot' or 'loss_drop'")
    if canary_kind == "update" and config.dp_mode != "client_dp":
        raise ValueError(
            "update canaries inject through the client_dp clip→noise path; "
            "set dp_mode='client_dp' or use canary_kind='data'")

    rng = np.random.default_rng(seed)
    audited = append_canary_clients(data, num_canaries, canary_samples,
                                    seed=seed)
    num_real = data.num_clients
    num_total = num_real + num_canaries
    included = rng.integers(0, 2, num_canaries).astype(bool)

    if canary_kind == "update":
        config = dataclasses.replace(config, audit_injection=True)
    engine = FederatedRoundEngine(model, audited, config, device=device)
    init_weights = tree_map(torch.clone, engine.global_variables["params"])
    canary_batch = (np.asarray(audited.images)[num_real:],
                    np.asarray(audited.labels)[num_real:],
                    np.asarray(audited.num_samples)[num_real:])

    inject_stacked = directions = None
    if canary_kind == "update":
        directions = make_update_canaries(
            engine.global_variables, num_canaries,
            scale=float(config.privacy.max_grad_norm), seed=seed)
        # full (C_total,)-stacked injection tree: zeros for real clients
        inject_stacked = tree_map(
            lambda u: torch.cat([u.new_zeros((num_real,) + u.shape[1:]),
                                 u]), directions)

    dot_fn = (make_update_dot_fn() if canary_kind == "update"
              else make_canary_dot_fn(model)
              if score_method == "grad_dot" else None)
    scores = np.zeros(num_canaries, np.float64)
    q = config.participation_rate
    for _ in range(num_rounds):
        mask = (rng.random(num_total) < q).astype(np.float32)
        mask[num_real:] *= included.astype(np.float32)
        before = engine.global_variables
        if canary_kind == "update":
            flags = np.zeros(num_total, np.float32)
            flags[num_real:] = mask[num_real:]
            engine.run_round(mask=mask, evaluate=False,
                             inject_flags=flags,
                             inject_deltas=inject_stacked)
            scores += dot_fn(before, engine.global_variables,
                             directions).cpu().numpy()
        else:
            engine.run_round(mask=mask, evaluate=False)
            if dot_fn is not None:
                scores += dot_fn(before, engine.global_variables,
                                 *canary_batch, audited.mean,
                                 audited.std).cpu().numpy()

    if canary_kind == "data" and score_method == "loss_drop":
        scores = make_canary_score_fn(model)(
            {"params": init_weights}, engine.global_variables,
            *canary_batch, audited.mean, audited.std).cpu().numpy()

    k = max(1, int(round(guess_fraction * num_canaries)))
    guesses = canary_guesses(scores, k_pos=k, k_neg=k)
    truth = np.where(included, 1, -1).astype(np.int8)
    num_guesses = int((guesses != 0).sum())
    num_correct = int(((guesses == truth) & (guesses != 0)).sum())

    delta = config.privacy.delta if config.privacy is not None else 0.0
    eps_lb = empirical_epsilon_lower_bound(
        num_correct, num_guesses, num_canaries, delta=delta,
        confidence=confidence)

    certified: Optional[float] = None
    if engine.rdp_accountant is not None:
        certified = engine.rdp_accountant.get_epsilon(delta)
    elif config.dp_mode == "delta" and engine.budget_tracker is not None:
        certified = engine.budget_tracker.consumed_epsilon

    return {
        "empirical_epsilon_lower_bound": float(eps_lb),
        "certified_epsilon": certified,
        "consistent": (certified is None
                       or eps_lb <= certified + 1e-9),
        "num_canaries": num_canaries,
        "num_guesses": num_guesses,
        "num_correct": num_correct,
        "confidence": confidence,
        "rounds": num_rounds,
        "dp_mode": config.dp_mode,
        "canary_kind": canary_kind,
        "score_method": (score_method if canary_kind == "data"
                         else "update_dot"),
        "scores": scores.tolist(),
        "included": included.tolist(),
    }
