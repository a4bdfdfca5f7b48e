"""Differential privacy of the delta-clipping and client-level modes, and
the host ledgers.

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

Client-level DP-FedAvg (``dp_mode="client_dp"``) is the port of
``fl_tpu.fl.privacy``'s central-noise functions (``privacy.py:259-347``),
plain PyTorch as the reference's are XLA: :func:`clip_client_deltas`,
:func:`clipped_masked_mean` (the engine's clip and fixed-denominator masked
sum in one pass, with each client's clip scale folded into its weight so
that no clipped copy of the (C, D) deltas is made),
:func:`central_noise_tree`, and adaptive clipping's
:func:`adaptive_clip_delta_multiplier`, :func:`noisy_clipped_fraction` and
:func:`geometric_clip_update` (Andrew et al. 2021). Their draws come from
``torch.Generator``s seeded by derived seeds (``core.prng``) where the
reference takes keys.

:class:`PrivacyBudgetTracker` and :class:`PrivacyAccountant` are host-side
copies of the reference's ledgers, with the methods the round engine uses
(status reports, export and checkpoint state come with checkpointing).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from fl_tpu_torch.core import prng
from fl_tpu_torch.core.pytree import clip_by_global_norm, tree_map, tree_paths
from fl_tpu_torch.core.transfer import to_device
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
        seeds = to_device(prng.as_int64(prng.client_stream_seeds(
            rseed, C, prng.Stream.DP_NOISE, gi)), x.device)
        out = dp_ops.clip_noise(x, scale, sigma, seeds)
        parts = torch.split(out, [f.shape[1] for f in flats], 1)
        for (l, k), t, part in zip(group, leaves, parts):
            noisy[l][k] = part.reshape(t.shape).to(t.dtype)
    return noisy, sens, sigma


def clip_client_deltas(stacked_deltas, max_norm: float
                       ) -> Tuple[Any, torch.Tensor]:
    """Clip each client's delta to global L2 norm ≤ C (no per-client
    noise). Returns (clipped stacked deltas, per-client pre-clip norms)."""
    clipped = torch.func.vmap(
        lambda tree: clip_by_global_norm(tree, max_norm)[0])(stacked_deltas)
    return clipped, client_norms(stacked_deltas)


def clipped_masked_mean(stacked_deltas, max_norm, mask: torch.Tensor,
                        expected_count: float) -> Tuple[Any, torch.Tensor]:
    """Σₖ maskₖ·clip_C(Δₖ) / m̄ leaf by leaf, in f32, and the (C,) pre-clip
    norms: :func:`clip_client_deltas` followed by the client_dp masked sum
    over the FIXED expected participant count m̄, with client k's clip scale
    min(1, C / max(‖Δₖ‖, 1e-12)) folded into its weight. ``max_norm`` may
    be a 0-d tensor (the adaptive clip norm)."""
    norms = client_norms(stacked_deltas)
    scale = torch.clamp(max_norm / torch.clamp(norms, min=1e-12), max=1.0)
    w = mask.float() * scale / expected_count
    mean = tree_map(lambda d: torch.tensordot(w, d.float(), dims=1),
                    stacked_deltas)
    return mean, norms


def central_noise_tree(tree, seed: int, sigma) -> Any:
    """Add N(0, σ²) to every element of an unstacked tree — the aggregator's
    noise of client-level DP-FedAvg (McMahan et al. 2018: the fixed-m̄ mean
    of C-clipped updates has sensitivity C/m̄, so σ = z·C/m̄). Leaf i of
    ``tree_paths`` order draws from its own sub-stream fold(seed, i)."""
    out: Dict = {}
    for i, (l, k) in enumerate(tree_paths(tree)):
        leaf = tree[l][k]
        g = prng.generator(prng.fold(seed, i), leaf.device)
        noise = torch.randn(leaf.shape, generator=g, device=leaf.device,
                            dtype=torch.float32)
        out.setdefault(l, {})[k] = leaf + (sigma * noise).to(leaf.dtype)
    return out


def adaptive_clip_delta_multiplier(noise_multiplier: float,
                                   count_stddev: float) -> float:
    """Noise multiplier z_Δ of the clipped-delta aggregate such that the
    joint release (aggregate at z_Δ·C, centered clipped count at σ_b) is one
    Gaussian mechanism at ``noise_multiplier`` z: z⁻² = z_Δ⁻² + (2σ_b)⁻²
    (Andrew et al. 2021, Theorem 1), so the accountant is unchanged."""
    if count_stddev <= 0:
        raise PrivacyError("count_stddev must be positive")
    inv = noise_multiplier ** -2 - (2.0 * count_stddev) ** -2
    if inv <= 0:
        raise PrivacyError(
            f"adaptive clipping infeasible: need 2·count_stddev > "
            f"noise_multiplier (got σ_b={count_stddev}, z={noise_multiplier})"
            " — raise clip_count_stddev or lower the noise multiplier"
        )
    return float(inv ** -0.5)


def noisy_clipped_fraction(centered_sum: torch.Tensor, expected_count,
                           count_stddev: float, seed: int) -> torch.Tensor:
    """DP estimate of the fraction of participants whose pre-clip norm was
    ≤ C, from the reduced centered sum Σᵢ mᵢ·(bᵢ − ½) plus N(0, σ_b²) drawn
    from ``seed``, over the fixed expected count m̄."""
    g = prng.generator(seed, centered_sum.device)
    noise = torch.randn((), generator=g, device=centered_sum.device)
    return (centered_sum + count_stddev * noise) / expected_count + 0.5


def geometric_clip_update(clip_norm, noisy_fraction: torch.Tensor,
                          target_quantile: float, learning_rate: float
                          ) -> torch.Tensor:
    """C ← C·exp(−η_C·(b̃ − γ)) (Andrew et al. 2021, Alg. 1): the fixed
    point is the γ-quantile of the client delta norms."""
    return clip_norm * torch.exp(
        -learning_rate * (noisy_fraction - target_quantile))


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

    # state for checkpoint/resume (the checkpoint's meta.json holds it)
    def state_dict(self) -> Dict[str, Any]:
        return {
            "initial_epsilon": self.initial_epsilon,
            "initial_delta": self.initial_delta,
            "consumed_epsilon": self.consumed_epsilon,
            "consumed_delta": self.consumed_delta,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.initial_epsilon = state["initial_epsilon"]
        self.initial_delta = state["initial_delta"]
        self.consumed_epsilon = state["consumed_epsilon"]
        self.consumed_delta = state["consumed_delta"]


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

    def get_total_privacy_cost(self) -> Tuple[float, float]:
        return self.total_epsilon, self.total_delta

    def get_privacy_ledger(self) -> List[Dict[str, Any]]:
        return list(self.privacy_ledger)
