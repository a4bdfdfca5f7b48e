"""DP-FTRL: client-level DP via binary-tree noise, no sampling required.

The port of ``fl_tpu.fl.dp_ftrl`` (Kairouz et al. 2021, "Practical and
Private (Deep) Learning without Sampling or Shuffling"). The server
releases noisy PREFIX SUMS of the per-round clipped update sums through
binary-tree aggregation; the guarantee holds for arbitrary participation
orderings as long as each client contributes to at most ``k`` rounds.

Tree aggregation (Dwork et al. 2010; Chan et al. 2011): the dyadic node
``node(l, j)`` carries one i.i.d. N(0, σ_node²·I) draw, and the prefix
[1, t] is covered by one node per set bit of t, so the released sum

    S̃_t = Σ_{s≤t} Δ_s + Σ_{set bits l of t} noise(node(l, 2·(t >> (l+1))))

carries popcount(t) ≤ h noise terms. A node's noise is regenerated from a
seed keyed by (tree nonce, level, node index) only, so the same node gives
the same draw in every prefix that reuses it and the tree is never
stored; the host knows t, so only the popcount(t) nodes the prefix needs
are drawn (the reference draws every level and masks the unset ones).

Privacy: one client changes one leaf by at most C, which touches at most
h = ⌈log2 T⌉ + 1 nodes; over k participations the L2 sensitivity is
C·√(k·h), and σ_node = z·C·√(k·h) makes the whole T-round transcript one
Gaussian mechanism with multiplier z, ε fixed up front.

The accounting functions are copies of the reference's numpy code and
give equal values; :func:`tree_noise_prefix` and :func:`ftrl_server_step`
run on tensors.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from fl_tpu_torch.core import prng

# dense α grid: fractional low orders matter for small z
_ALPHAS: Tuple[float, ...] = tuple(
    [1.0 + x / 10.0 for x in range(1, 100)]
    + list(range(11, 64))
    + [128.0, 256.0, 512.0, 1024.0]
)


def gaussian_epsilon(noise_multiplier: float, delta: float,
                     alphas: Sequence[float] = _ALPHAS) -> float:
    """Exact (ε, δ) of a single Gaussian mechanism with σ = z·Δ, by the
    analytic hockey-stick curve (Balle & Wang 2018, ``fl.pld``).
    ``alphas`` is kept for the reference's signature and not used."""
    z = float(noise_multiplier)
    if z <= 0:
        return float("inf")
    from fl_tpu_torch.fl.pld import analytic_gaussian_epsilon

    return analytic_gaussian_epsilon(z, delta)


def calibrate_noise_multiplier(epsilon: float, delta: float,
                               tol: float = 1e-4) -> float:
    """Smallest z with gaussian_epsilon(z, delta) ≤ ε (bisection; the map
    is monotone decreasing in z)."""
    lo, hi = 1e-3, 1.0
    while gaussian_epsilon(hi, delta) > epsilon:
        hi *= 2.0
        if hi > 1e7:
            raise ValueError("cannot calibrate noise for this (ε, δ)")
    while hi - lo > tol * hi:
        mid = 0.5 * (lo + hi)
        if gaussian_epsilon(mid, delta) <= epsilon:
            hi = mid
        else:
            lo = mid
    return hi


def tree_height(t_max: int) -> int:
    """Number of tree levels a single leaf can touch: ⌈log2 T⌉ + 1."""
    if t_max < 1:
        raise ValueError("t_max must be >= 1")
    return int(math.ceil(math.log2(t_max))) + 1 if t_max > 1 else 1


def ftrl_sensitivity(clip: float, t_max: int,
                     max_participations: int = 1) -> float:
    """L2 sensitivity of the full tree release: C·√(k·h)."""
    return clip * math.sqrt(max_participations * tree_height(t_max))


def prefix_node_count(t: int) -> int:
    """Noise terms in S̃_t — popcount(t)."""
    return bin(int(t)).count("1")


def node_seed(tree_seed: int, level: int, index: int) -> int:
    """The seed of node (level, index): fold(fold(tree_seed, level),
    index), nothing else."""
    return prng.fold(prng.fold(tree_seed, level), index)


def tree_noise_prefix(tree_seed: int, t: int, dim: int, sigma_node: float,
                      height: int, device="cpu") -> torch.Tensor:
    """(dim,) f32 Σ of the dyadic-cover node noises of prefix [1, t]
    (1-indexed): one σ_node·N(0, I) draw a set bit of t below ``height``,
    node (l, 2·(t >> (l+1))) from :func:`node_seed`."""
    t = int(t)
    total = torch.zeros((dim,), dtype=torch.float32, device=device)
    for level in range(height):
        if (t >> level) & 1:
            g = prng.generator(node_seed(tree_seed, level,
                                         (t >> (level + 1)) * 2), device)
            total += sigma_node * torch.randn(
                (dim,), generator=g, device=device, dtype=torch.float32)
    return total


def ftrl_server_step(
    params_flat: torch.Tensor,    # (D,) current global params
    cumsum: torch.Tensor,         # (D,) true clipped-sum prefix (carried)
    prev_noisy: torch.Tensor,     # (D,) S̃_{t-1} (carried)
    momentum_buf: torch.Tensor,   # (D,) momentum state (carried)
    round_sum: torch.Tensor,      # (D,) this round's clipped participant sum
    tree_seed: int,
    t: int,                       # 1-indexed round number
    sigma_node: float,
    height: int,
    server_lr: float,
    cohort_size: float,           # fixed m̄ denominator (not realized count)
    momentum: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One DP-FTRL(M) server update. Returns (new_params_flat,
    new_cumsum, new_noisy, new_momentum_buf).

    w_t = w_{t−1} + (η/m̄)·m_t with m_t = β·m_{t−1} + (S̃_t − S̃_{t−1}); at
    β = 0 this telescopes to w_t = w_0 + (η/m̄)·S̃_t (the leaves are client
    deltas, so the server adds the prefix sum). The differencing and the
    momentum act on released prefix sums: post-processing."""
    new_cumsum = cumsum + round_sum
    noise = tree_noise_prefix(tree_seed, t, cumsum.shape[0], sigma_node,
                              height, cumsum.device)
    new_noisy = new_cumsum + noise
    g = new_noisy - prev_noisy
    new_m = momentum * momentum_buf + g
    new_params = params_flat + (server_lr / cohort_size) * new_m
    return new_params, new_cumsum, new_noisy, new_m


def rotation_mask(num_clients: int, round_number: int,
                  cohort_size: int) -> np.ndarray:
    """Deterministic round-robin cohort for round t — the natural DP-FTRL
    participation pattern (no sampling needed; each client participates
    once per ⌈N/m⌉ rounds)."""
    if not 0 < cohort_size <= num_clients:
        raise ValueError("cohort_size must be in [1, num_clients]")
    mask = np.zeros((num_clients,), np.float32)
    start = (round_number * cohort_size) % num_clients
    idx = (start + np.arange(cohort_size)) % num_clients
    mask[idx] = 1.0
    return mask


def max_rounds_within_participations(num_clients: int, cohort_size: int,
                                     max_participations: int) -> int:
    """Rounds the rotation schedule can run before some client would
    exceed ``max_participations``."""
    return (num_clients // cohort_size) * max_participations
