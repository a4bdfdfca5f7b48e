"""Sample-weighted FedAvg over the stacked client axis (port of the device
path of ``fl_tpu.fl.fedavg`` and the round engine's combine), and FedNova's
effective step counts, by which the engine reweights it."""

from __future__ import annotations

from typing import Optional

import torch

from fl_tpu_torch.core.pytree import tree_map


def normalized_client_weights(num_samples: torch.Tensor,
                              mask: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """wₖ = maskₖ·nₖ / Σ maskⱼ·nⱼ (ref: _calculate_sample_weights,
    src/aggregation/fedavg.py:247-256), uniform over the mask when every
    weighted count is zero."""
    n = num_samples.float()
    m = torch.ones_like(n) if mask is None else mask.float()
    weighted = n * m
    total = weighted.sum()
    uniform = m / torch.clamp(m.sum(), min=1.0)
    return torch.where(total > 0, weighted / torch.clamp(total, min=1e-12),
                       uniform)


def weighted_delta_sum(stacked_tree, weights: torch.Tensor, ref_tree):
    """Σₖ wₖ·(θₖ − θ̂) leaf by leaf, in f32: on a shard of the client axis,
    the shard's partial sum (its rows of the weights normalized over all
    C), which one packed all-reduce completes."""
    return tree_map(
        lambda c, ref: torch.tensordot(weights, (c - ref[None]).float(),
                                       dims=1),
        stacked_tree, ref_tree)


def apply_delta(global_tree, avg_tree):
    """global + the averaged delta, in each global leaf's dtype."""
    return tree_map(lambda g, d: (g + d).to(g.dtype), global_tree, avg_tree)


def fedavg_delta(global_tree, stacked_tree, weights: torch.Tensor,
                 ref_tree=None):
    """global + Σₖ wₖ·(θₖ − θ̂), leaf by leaf, where θ̂ (``ref_tree``,
    default the global model) is the model the clients received: with
    downlink compression the deltas are measured against the compressed
    broadcast and applied to the full-precision master. Non-participants
    (weight 0) leave the global model where it was."""
    ref_tree = global_tree if ref_tree is None else ref_tree
    return apply_delta(global_tree,
                       weighted_delta_sum(stacked_tree, weights, ref_tree))


def fednova_effective_steps(tau: torch.Tensor, momentum: float
                            ) -> torch.Tensor:
    """FedNova's per-client effective step count a_i (Wang et al. 2020,
    Table 1, local SGD with heavy-ball momentum ρ):

        a_i = [τ_i − ρ(1−ρ^{τ_i})/(1−ρ)] / (1−ρ),    a_i = τ_i at ρ = 0,

    the ℓ1 norm of the trajectory's accumulated update coefficients."""
    tau = tau.float()
    if momentum <= 0.0:
        return tau
    rho = torch.tensor(momentum, dtype=torch.float32, device=tau.device)
    return (tau - rho * (1.0 - rho ** tau) / (1.0 - rho)) / (1.0 - rho)
