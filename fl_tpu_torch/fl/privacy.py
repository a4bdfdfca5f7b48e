"""Differential privacy of the delta-clipping mode, and the host ledgers.

``dp_noise_client_deltas`` is the port of ``fl_tpu.fl.privacy.
dp_noise_client_deltas`` (the per-leaf-group epilogue): one L2 norm per
client over all leaves; scale = min(1, C/‖Δ‖), sens = min(‖Δ‖, C),
σ = sens·√(2 ln(1.25/δ))/ε; then every element gets Δ·scale + σ·z through
the clip+noise kernel (``fl_tpu_torch.ops.dp.clip_noise``, K3 on CUDA).

Leaf groups: a leaf with at least ``STANDALONE_MIN`` elements per client
runs the kernel on its own (C, D) view, with no copy (SimpleCNN's fc1
kernel, 95% of the bytes); the small leaves are concatenated into one more
group. Every (round, client, group) has its own seed, so no noise stream is
reused.

:class:`PrivacyBudgetTracker` and :class:`PrivacyAccountant` are host-side
copies of the reference's ledgers, with the methods the round engine uses
(status reports, export and checkpoint state come with checkpointing).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from fl_tpu_torch.core import prng
from fl_tpu_torch.core.pytree import tree_paths
from fl_tpu_torch.ops import dp as dp_ops

STANDALONE_MIN = 1 << 16


class PrivacyError(Exception):
    """ref: PrivacyError, src/shared/privacy.py:20-22."""


def leaf_groups(tree) -> List[List[tuple]]:
    """Paths grouped for the clip+noise kernel: each large leaf alone (in
    tree order), then all small leaves together."""
    paths = tree_paths(tree)
    big = [[p] for p in paths
           if tree[p[0]][p[1]][0].numel() >= STANDALONE_MIN]
    small = [p for p in paths if [p] not in big]
    return big + ([small] if small else [])


def client_norms(tree) -> torch.Tensor:
    """(C,) global L2 norm of each client's stacked leaves."""
    sq = [tree[l][k].reshape(tree[l][k].shape[0], -1).float().square().sum(1)
          for l, k in tree_paths(tree)]
    return torch.stack(sq).sum(0).sqrt()


def dp_noise_client_deltas(stacked_deltas, rseed: int, epsilon: float,
                           delta: float, max_norm: float
                           ) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """Reference-mode DP over stacked client deltas (leading axis C).
    ``rseed`` is the round's seed; client c's group g noise is keyed by
    fold(fold(fold(rseed, c), DP_NOISE), g). Returns (noisy tree,
    sensitivity (C,), sigma (C,))."""
    norms = client_norms(stacked_deltas)
    scale = torch.clamp(max_norm / torch.clamp(norms, min=1e-12), max=1.0)
    sens = torch.clamp(norms, max=max_norm)
    sigma = sens * dp_ops.gaussian_factor(epsilon, delta)

    noisy: Dict = {l: {} for l in stacked_deltas}
    for gi, group in enumerate(leaf_groups(stacked_deltas)):
        leaves = [stacked_deltas[l][k] for l, k in group]
        C = leaves[0].shape[0]
        flats = [t.reshape(C, -1).float() for t in leaves]
        x = flats[0] if len(flats) == 1 else torch.cat(flats, 1)
        seeds = torch.as_tensor(prng.as_int64(prng.client_stream_seeds(
            rseed, C, prng.Stream.DP_NOISE, gi))).to(x.device)
        out = dp_ops.clip_noise(x, scale, sigma, seeds)
        parts = torch.split(out, [f.shape[1] for f in flats], 1)
        for (l, k), t, part in zip(group, leaves, parts):
            noisy[l][k] = part.reshape(t.shape).to(t.dtype)
    return noisy, sens, sigma


class PrivacyBudgetTracker:
    """Additive (ε, δ) budget ledger
    (ref: PrivacyBudgetTracker, src/shared/privacy.py:25-92)."""

    def __init__(self, initial_epsilon: float, initial_delta: float):
        self.initial_epsilon = initial_epsilon
        self.initial_delta = initial_delta
        self.consumed_epsilon = 0.0
        self.consumed_delta = 0.0
        self.consumption_history: List[Dict[str, Any]] = []

    def consume_budget(self, epsilon: float, delta: float,
                       operation: str = "training") -> None:
        self.consumed_epsilon += epsilon
        self.consumed_delta += delta
        self.consumption_history.append({
            "timestamp": time.time(),
            "epsilon": epsilon,
            "delta": delta,
            "operation": operation,
            "total_epsilon": self.consumed_epsilon,
            "total_delta": self.consumed_delta,
        })

    def get_remaining_budget(self) -> Tuple[float, float]:
        return (
            max(0.0, self.initial_epsilon - self.consumed_epsilon),
            max(0.0, self.initial_delta - self.consumed_delta),
        )

    def is_budget_exhausted(self, required_epsilon: float = 0.0,
                            required_delta: float = 0.0) -> bool:
        # small relative tolerance so k rounds of budget/k sum cleanly
        # despite float accumulation
        rem_e, rem_d = self.get_remaining_budget()
        tol_e = 1e-9 * max(self.initial_epsilon, 1.0)
        tol_d = 1e-9 * max(self.initial_delta, 1e-12)
        return rem_e < required_epsilon - tol_e or rem_d < required_delta - tol_d


class PrivacyAccountant:
    """Mechanism ledger with additive composition
    (ref: PrivacyAccountant, privacy.py:419-484)."""

    def __init__(self):
        self.privacy_ledger: List[Dict[str, Any]] = []
        self.total_epsilon = 0.0
        self.total_delta = 0.0

    def add_mechanism(self, mechanism_type: str, epsilon: float, delta: float,
                      sensitivity: float, noise_scale: float,
                      metadata: Optional[Dict[str, Any]] = None) -> None:
        self.privacy_ledger.append({
            "timestamp": time.time(),
            "mechanism_type": mechanism_type,
            "epsilon": epsilon,
            "delta": delta,
            "sensitivity": sensitivity,
            "noise_scale": noise_scale,
            "metadata": metadata or {},
        })
        self.total_epsilon += epsilon
        self.total_delta += delta

    def get_privacy_ledger(self) -> List[Dict[str, Any]]:
        return list(self.privacy_ledger)
