"""Federated analytics: DP histograms, heavy hitters and quantiles (port of
``fl_tpu.fl.analytics``).

The query-side sibling of federated learning (Zhu et al. 2020, federated
heavy hitters): the coordinator wants population statistics without
collecting anyone's raw items. Counts are integers, so the distributed-DP
stack (``fl.distributed_dp``: Skellam shares, a modular sum) applies with
no quantization step:

- :func:`dp_histogram`: each client's items become a capped local count
  vector (the cap bounds the L1 and L2 sensitivities), the (C, D) count
  matrix is summed on the device and one aggregate Skellam draw
  (``aggregate_skellam_noise``, the exact distribution of the summed
  per-client shares) is added before anything leaves it; ε is certified by
  the same ``skellam_rdp`` bound the training mode uses.
- :func:`heavy_hitters`: top-k of the noised histogram above τ·σ.
- :func:`dp_quantiles`: quantiles of a bucketized domain read off the
  noised cumulative histogram.
- :class:`RandomizedResponse`: k-ary randomized response, the local-DP
  regime (Kairouz et al. 2016).

The cap, the ε calibration and the read-outs are numpy and copied from the
reference; the release runs on ``device`` (the card unless the caller asks
for the CPU). Its noise is keyed root(seed) → DISTRIBUTED_DP → 0xA66, as
the reference folds its key.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from fl_tpu_torch.core import prng
from fl_tpu_torch.core.mesh import resolve_device
from fl_tpu_torch.core.transfer import to_device
from fl_tpu_torch.fl.accounting import DEFAULT_ALPHAS, eps_from_rdp
from fl_tpu_torch.fl.distributed_dp import (
    aggregate_skellam_noise,
    skellam_rdp,
    wrap_int32,
)


@dataclass(frozen=True)
class AnalyticsResult:
    counts: np.ndarray          # debiased estimates, float64 (D,)
    epsilon: float              # (ε, δ)-DP of this release
    delta: float
    sigma: float                # per-bucket noise std of the estimate
    participants: int


def _cap_items(items: np.ndarray, cap: int,
               rng: np.random.Generator) -> np.ndarray:
    """Per-client contribution cap by uniform subsampling WITHOUT
    replacement: the kept multiset has exactly min(len, cap) items, so the
    client's count vector is integer with L1 ≤ cap and L2 ≤ cap."""
    items = np.asarray(items, np.int64)
    if items.size <= cap:
        return items
    return rng.choice(items, size=cap, replace=False)


def dp_histogram(
    client_items: Sequence[np.ndarray],
    domain_size: int,
    epsilon: Optional[float] = None,
    delta: float = 1e-6,
    max_items_per_client: int = 1,
    noise_scale: Optional[float] = None,
    seed: int = 0,
    device=None,
) -> AnalyticsResult:
    """Central-model DP histogram via the distributed Skellam mechanism.

    ``client_items``: one int array of item ids per client, capped at
    ``max_items_per_client`` by uniform subsampling (Δ₁ = Δ₂ = cap
    exactly). Exactly one of ``epsilon`` (noise calibrated to meet it) or
    ``noise_scale`` (σ of the summed noise, ε derived) must be given.
    The (C, D) int32 count matrix is summed on ``device`` (None: the
    card) and the noise added there; only the noised sum comes back."""
    n = len(client_items)
    if n < 1:
        raise ValueError("need at least one client")
    if (epsilon is None) == (noise_scale is None):
        raise ValueError("give exactly one of epsilon / noise_scale")
    cap = int(max_items_per_client)
    if cap < 1:
        raise ValueError("max_items_per_client must be >= 1")
    device = resolve_device("dp_histogram", device, None)
    d2 = float(cap)
    d1 = float(cap)

    if noise_scale is None:
        mu = _calibrate_mu(epsilon, delta, d2, d1)
    else:
        mu = float(noise_scale) ** 2
    eps_actual = float(eps_from_rdp(
        skellam_rdp(mu, d2, d1, DEFAULT_ALPHAS), delta)[0])

    cap_rng = np.random.default_rng(seed + 0x5EED)
    counts = np.zeros((n, domain_size), np.int32)
    for i, items in enumerate(client_items):
        items = np.asarray(items, np.int64)
        if items.size and (items.min() < 0 or items.max() >= domain_size):
            raise ValueError(f"client {i} items outside [0, {domain_size})")
        kept = _cap_items(items, cap, cap_rng)
        np.add.at(counts[i], kept, 1)

    mat = to_device(counts, device)
    total = mat.sum(0, dtype=torch.int64)
    noise_seed = prng.fold(prng.stream_seed(
        prng.root_seed(seed), prng.Stream.DISTRIBUTED_DP), 0xA66)
    noise = aggregate_skellam_noise(noise_seed, mu / 2.0, domain_size,
                                    device=device)
    summed = wrap_int32(total + noise).cpu().numpy().astype(np.int64)
    return AnalyticsResult(
        counts=summed.astype(np.float64),
        epsilon=eps_actual, delta=delta,
        sigma=math.sqrt(mu), participants=n)


def _calibrate_mu(target_eps: float, delta: float, d2: float, d1: float,
                  lo: float = 1e-2, hi: float = 1e12) -> float:
    def eps_at(mu):
        return float(eps_from_rdp(
            skellam_rdp(mu, d2, d1, DEFAULT_ALPHAS), delta)[0])

    if eps_at(hi) > target_eps:
        raise ValueError(f"epsilon={target_eps} unreachable")
    for _ in range(200):
        mid = math.sqrt(lo * hi)
        if eps_at(mid) > target_eps:
            lo = mid
        else:
            hi = mid
        if hi / lo < 1 + 1e-6:
            break
    return hi


def heavy_hitters(result: AnalyticsResult, k: int = 10,
                  tau: float = 3.0) -> Dict[int, float]:
    """Top-k buckets whose noised count clears τ·σ (each reported hitter is
    nonzero-frequency with confidence ≥ Φ(τ)). Returns {item_id:
    estimated_count}, largest first."""
    est = result.counts
    order = np.argsort(-est)[:k]
    thresh = tau * result.sigma
    return {int(i): float(est[i]) for i in order if est[i] > thresh}


def dp_quantiles(result: AnalyticsResult,
                 bucket_edges: np.ndarray,
                 qs: Sequence[float]) -> Dict[float, float]:
    """Quantiles of a bucketized numeric domain from the noised histogram:
    the q-quantile is the left edge of the first bucket whose (clipped)
    cumulative share reaches q. ``bucket_edges``: (D+1,) monotone edges."""
    edges = np.asarray(bucket_edges, np.float64)
    if edges.size != result.counts.size + 1:
        raise ValueError("bucket_edges must have histogram size + 1 edges")
    c = np.maximum(result.counts, 0.0)
    total = c.sum()
    if total <= 0:
        raise ValueError("histogram is empty after noise clipping")
    cdf = np.cumsum(c) / total
    out = {}
    for q in qs:
        if not 0 < q < 1:
            raise ValueError(f"quantile {q} outside (0, 1)")
        idx = int(np.searchsorted(cdf, q))
        out[float(q)] = float(edges[min(idx, edges.size - 2)])
    return out


class RandomizedResponse:
    """k-ary randomized response (local DP): each item is reported
    truthfully w.p. e^ε/(e^ε+k−1), else uniformly among the other k−1."""

    def __init__(self, domain_size: int, epsilon_local: float):
        if epsilon_local <= 0:
            raise ValueError("epsilon_local must be positive")
        self.k = int(domain_size)
        self.eps = float(epsilon_local)
        e = math.exp(self.eps)
        self.p_true = e / (e + self.k - 1)
        self.p_other = 1.0 / (e + self.k - 1)

    def randomize(self, items: np.ndarray,
                  rng: np.random.Generator) -> np.ndarray:
        items = np.asarray(items, np.int64)
        flip = rng.random(items.shape) >= self.p_true
        noise = rng.integers(0, self.k - 1, size=items.shape)
        # uniform over the k-1 OTHER values
        other = noise + (noise >= items)
        return np.where(flip, other, items)

    def estimate_histogram(self, reported: np.ndarray) -> np.ndarray:
        """Unbiased frequency estimates from the reported items:
        n̂_v = (c_v − n·p_other) / (p_true − p_other)."""
        reported = np.asarray(reported, np.int64)
        n = reported.size
        c = np.bincount(reported, minlength=self.k).astype(np.float64)
        return (c - n * self.p_other) / (self.p_true - self.p_other)

    def estimator_std(self, n: int) -> float:
        """Per-bucket standard deviation of the unbiased estimator."""
        p = self.p_other
        return math.sqrt(n * p * (1 - p)) / (self.p_true - self.p_other)
