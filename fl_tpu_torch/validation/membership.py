"""Membership-inference attack harness: measured MIA risk, not a heuristic
(port of ``fl_tpu.validation.membership``).

Loss-threshold membership inference (Yeom et al. 2018; the score variant
of Sablayrolles et al. 2019): an attacker who can query the released
global model guesses that an example was in the training federation iff
its loss is below a threshold. This module runs it against models
produced by the port's training path and reports rank-AUC and the best
threshold advantage (max TPR − FPR), next to the (ε, δ)-DP ceiling on
that advantage (Kairouz et al. 2015; tanh(ε/2) at δ=0).

Per-example losses come from the model's stacked forward (one client of
the stacked axis, eval mode, no autograd), chunk by chunk on the model's
device, each chunk normalized from uint8 there. The statistics are numpy
and copied from the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from fl_tpu_torch.core.pytree import tree_leaves, tree_map
from fl_tpu_torch.fl.local_training import model_kwargs, per_example_losses


def _device_of(variables) -> torch.device:
    return tree_leaves(variables)[0].device


def make_example_loss_fn(model, mean, std, chunk_size: int = 256
                         ) -> Callable:
    """``fn(variables, images_u8, labels) -> (N,) f32 losses`` (a tensor
    on the variables' device).

    ``variables`` is one model's tree (``{"params": ..., maybe
    "batch_stats": ...}``, unstacked); images are uint8 (N, H, W, ch),
    normalized chunk by chunk so the f32 copy of the whole set never
    materializes."""
    @torch.no_grad()
    def example_losses(variables, images_u8, labels) -> torch.Tensor:
        dev = _device_of(variables)
        m = torch.as_tensor(np.asarray(torch.as_tensor(mean).cpu()),
                            dtype=torch.float32, device=dev)
        s = torch.as_tensor(np.asarray(torch.as_tensor(std).cpu()),
                            dtype=torch.float32, device=dev)
        stacked = tree_map(lambda v: v[None], variables)
        kw = model_kwargs(stacked.get("batch_stats"))
        images_u8 = torch.as_tensor(np.asarray(images_u8)) \
            if not isinstance(images_u8, torch.Tensor) else images_u8
        labels = torch.as_tensor(np.asarray(labels)) \
            if not isinstance(labels, torch.Tensor) else labels
        n = images_u8.shape[0]
        chunk = min(chunk_size, n)
        out = []
        for lo in range(0, n, chunk):
            xb = images_u8[lo:lo + chunk].to(dev)
            yb = labels[lo:lo + chunk].to(dev).long()
            x = (xb.float() / 255.0 - m) / s
            logits = model(stacked["params"], x[None], train=False, **kw)
            out.append(per_example_losses(logits, yb[None])[0])
        return torch.cat(out).float()

    return example_losses


def rank_auc(pos: np.ndarray, neg: np.ndarray) -> float:
    """Exact Mann-Whitney AUC of scores ``pos`` (members) vs ``neg``
    (non-members): P(pos_score > neg_score) + ½P(tie)."""
    pos = np.asarray(pos, np.float64)
    neg = np.asarray(neg, np.float64)
    all_scores = np.concatenate([pos, neg])
    order = np.argsort(all_scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    # average ranks over ties (midrank method)
    sorted_scores = all_scores[order]
    i = 0
    n = len(all_scores)
    while i < n:
        j = i
        while j + 1 < n and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    r_pos = ranks[: len(pos)].sum()
    u = r_pos - len(pos) * (len(pos) + 1) / 2.0
    return float(u / (len(pos) * len(neg)))


def best_threshold_advantage(pos: np.ndarray, neg: np.ndarray):
    """Max over thresholds of TPR − FPR for the rule score ≥ t, plus the
    achieving threshold. Scores: higher = more member-like."""
    pos = np.sort(np.asarray(pos, np.float64))[::-1]
    neg = np.sort(np.asarray(neg, np.float64))[::-1]
    thresholds = np.unique(np.concatenate([pos, neg]))[::-1]
    tpr = np.searchsorted(-pos, -thresholds, side="right") / len(pos)
    fpr = np.searchsorted(-neg, -thresholds, side="right") / len(neg)
    adv = tpr - fpr
    k = int(np.argmax(adv))
    return float(adv[k]), float(thresholds[k])


def membership_advantage_bound(epsilon: float, delta: float = 0.0) -> float:
    """Ceiling on membership advantage (max TPR − FPR) any attacker can
    achieve against an (ε, δ)-DP mechanism: (e^ε − 1 + 2δ)/(e^ε + 1)
    from the hypothesis-testing region (Kairouz et al. 2015), tanh(ε/2)
    at δ=0, clamped to [0, 1]."""
    if epsilon < 0 or delta < 0:
        raise ValueError("epsilon and delta must be non-negative")
    t = math.exp(epsilon)
    return float(min(1.0, (t - 1.0 + 2.0 * delta) / (t + 1.0)))


@dataclasses.dataclass
class MembershipReport:
    auc: float                    # rank-AUC of −loss, member vs non-member
    advantage: float              # best TPR − FPR over thresholds
    threshold_loss: float         # loss threshold achieving it
    member_loss_mean: float
    nonmember_loss_mean: float
    n_members: int
    n_nonmembers: int
    epsilon: Optional[float] = None
    delta: Optional[float] = None
    advantage_bound: Optional[float] = None  # DP ceiling, if ε was given

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def loss_attack_report(
    model,
    variables,
    member_images: np.ndarray,
    member_labels: np.ndarray,
    nonmember_images: np.ndarray,
    nonmember_labels: np.ndarray,
    mean,
    std,
    epsilon: Optional[float] = None,
    delta: Optional[float] = None,
) -> MembershipReport:
    """Run the loss-threshold attack against ``variables`` (one model's
    tree, on the device the attack runs on). Members must be actual
    training examples; non-members fresh draws from the same
    distribution. Pass the run's certified (ε, δ) to also report the DP
    advantage ceiling."""
    loss_fn = make_example_loss_fn(model, mean, std)
    m_losses = loss_fn(variables, member_images,
                       member_labels).cpu().numpy()
    n_losses = loss_fn(variables, nonmember_images,
                       nonmember_labels).cpu().numpy()
    # member-likeness score = −loss
    auc = rank_auc(-m_losses, -n_losses)
    adv, thr = best_threshold_advantage(-m_losses, -n_losses)
    bound = (membership_advantage_bound(epsilon, delta or 0.0)
             if epsilon is not None else None)
    return MembershipReport(
        auc=auc, advantage=adv, threshold_loss=-thr,
        member_loss_mean=float(m_losses.mean()),
        nonmember_loss_mean=float(n_losses.mean()),
        n_members=int(len(m_losses)), n_nonmembers=int(len(n_losses)),
        epsilon=epsilon, delta=delta, advantage_bound=bound,
    )


def evaluate_membership_risk(
    engine,
    nonmember_images: np.ndarray,
    nonmember_labels: np.ndarray,
    epsilon: Optional[float] = None,
    delta: Optional[float] = None,
    max_members: int = 4096,
) -> MembershipReport:
    """Attack a FederatedRoundEngine's current global model using its own
    federation data as the member set (valid shard slots only: pad slots
    were never trained on and would dilute the attack)."""
    data = engine.data
    imgs = torch.as_tensor(data.images).cpu().numpy()      # (C, n, ...)
    labs = torch.as_tensor(data.labels).cpu().numpy()
    counts = torch.as_tensor(data.num_samples).cpu().numpy()
    members_x, members_y = [], []
    for c in range(imgs.shape[0]):
        k = int(counts[c])
        members_x.append(imgs[c, :k])
        members_y.append(labs[c, :k])
    mx = np.concatenate(members_x)[:max_members]
    my = np.concatenate(members_y)[:max_members]
    if epsilon is None and engine.privacy is not None \
            and engine.config.dp_mode in ("dp_sgd", "client_dp",
                                          "distributed", "dp_ftrl"):
        # the engine's own certified budget is the honest ceiling input
        epsilon = float(engine.privacy.epsilon)
        delta = float(engine.privacy.delta)
    return loss_attack_report(
        engine.model, engine.global_variables, mx, my,
        nonmember_images, nonmember_labels,
        mean=data.mean, std=data.std, epsilon=epsilon, delta=delta,
    )
