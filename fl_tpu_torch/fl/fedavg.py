"""FedAvg (port of ``fl_tpu.fl.fedavg``): the sample-weighted reduction
over the stacked client axis that the round engines combine with,
FedNova's effective step counts, by which the engine reweights it, and the
host aggregator of the deployment coordinator.

Parity target: ``FedAvgAggregator`` / ``AdaptiveFedAvg``
(src/aggregation/fedavg.py). :class:`FedAvgAggregator` keeps the
reference's API surface (validation and filtering, the ``max_clients`` cut
by sample count, aggregation history and stats, the convergence metric)
and runs the arithmetic on its device: the updates' leaves are stacked
into (C, ...) tensors there and averaged by :func:`fedavg_stacked`, one
reduction a leaf, with the weights of :func:`normalized_client_weights`.
The averaged leaves stay tensors on that device (the reference's stay
device arrays); they become numpy only at the wire
(``core.types.weights_like``).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from fl_tpu_torch.core.mesh import resolve_device
from fl_tpu_torch.core.pytree import tree_leaves, tree_map
from fl_tpu_torch.core.transfer import to_device
from fl_tpu_torch.core.types import GlobalModel, ModelUpdate
from fl_tpu_torch.utils.validation import (
    ModelUpdateValidator,
    validate_model_compatibility,
)

logger = logging.getLogger(__name__)


class FedAvgError(Exception):
    """Aggregation failure (ref: FedAvgError, src/aggregation/fedavg.py:20)."""


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


def fedavg_stacked(stacked_tree, num_samples: torch.Tensor,
                   mask: Optional[torch.Tensor] = None):
    """Sample-weighted average over the leading client axis of a stacked
    tree: each leaf in f32, Σₖ wₖ·θₖ over the (C, ...) axis, cast back to
    the leaf's dtype (ref: ``fedavg_stacked`` and
    ``core.pytree.stacked_weighted_mean``)."""
    w = normalized_client_weights(num_samples, mask)

    def avg(leaf):
        wl = w.to(leaf.device).reshape((-1,) + (1,) * (leaf.dim() - 1))
        return (leaf.float() * wl).sum(0).to(leaf.dtype)

    return tree_map(avg, stacked_tree)


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


def convergence_score(old_tree, new_tree) -> torch.Tensor:
    """Σℓ‖Δℓ‖ / Σℓ‖θℓ‖ clamped to [0, 1] (ref:
    calculate_convergence_metrics, src/aggregation/fedavg.py:144-190: the
    reference sums per-layer norms, not squared norms; matched here). The
    difference is taken in f32, the norms accumulate in float64: torch's
    f32 norm on the CPU loses ~2e-6 relative over fc1's 401,408
    elements, where the reference's lies within 2e-8 of float64."""
    diffs = tree_leaves(tree_map(
        lambda a, b: torch.linalg.vector_norm((b - a).float(),
                                              dtype=torch.float64),
        old_tree, new_tree))
    norms = tree_leaves(tree_map(
        lambda b: torch.linalg.vector_norm(b.float(), dtype=torch.float64),
        new_tree))
    total_diff = torch.stack(diffs).sum()
    total_norm = torch.stack(norms).sum()
    score = torch.where(total_norm > 0, total_diff / total_norm,
                        torch.zeros_like(total_norm))
    return score.clamp(0.0, 1.0)


# ---------------------------------------------------------------------------
# The host aggregator (services layer)
# ---------------------------------------------------------------------------

def weight_tensor(value, device) -> torch.Tensor:
    """One weight (numpy array or tensor) as a tensor on ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    a = np.asarray(value)
    # arrays decoded from the wire may be read-only; torch wants its own
    return to_device(a if a.flags.writeable else a.copy(), device)


class FedAvgAggregator:
    """Host-level aggregator with the reference's API surface
    (src/aggregation/fedavg.py:25-357). ``device``: where the reduction
    runs and the averaged leaves live; None is the card."""

    def __init__(
        self,
        min_clients: int = 2,
        max_clients: Optional[int] = None,
        validate_updates: bool = True,
        validator: Optional[ModelUpdateValidator] = None,
        device=None,
    ):
        self.min_clients = min_clients
        self.max_clients = max_clients
        self.validate_updates = validate_updates
        self.validator = (validator or ModelUpdateValidator()
                          if validate_updates else None)
        self.device = resolve_device(type(self).__name__, device, None)
        self.aggregation_history: List[Dict[str, Any]] = []

    # -- public API ---------------------------------------------------------
    def aggregate_updates(
        self,
        updates: List[ModelUpdate],
        weights: Optional[List[float]] = None,
    ) -> GlobalModel:
        t0 = time.perf_counter()
        if not updates:
            raise FedAvgError("No model updates provided")
        if weights is not None:
            if len(weights) != len(updates):
                raise FedAvgError("Number of weights must match number of updates")
            if any(w < 0 for w in weights):
                raise FedAvgError("All weights must be non-negative")
            if sum(weights) == 0:
                raise FedAvgError("Sum of weights cannot be zero")

        valid = self._filter_updates(updates)
        if len(valid) < self.min_clients:
            raise FedAvgError(
                f"Insufficient valid updates: {len(valid)} < {self.min_clients}"
            )
        if self.max_clients and len(valid) > self.max_clients:
            valid = sorted(valid, key=lambda u: u.num_samples, reverse=True)
            valid = valid[: self.max_clients]

        if weights is None:
            counts = torch.tensor([float(u.num_samples) for u in valid],
                                  dtype=torch.float32)
        else:
            counts = torch.tensor([float(w) for w in weights[: len(valid)]],
                                  dtype=torch.float32)

        # the flat weight dicts stacked into a client-leading tree on the
        # aggregator's device, then one reduction a leaf
        keys = list(valid[0].model_weights.keys())
        stacked = {
            k: torch.stack([weight_tensor(u.model_weights[k], self.device)
                            for u in valid])
            for k in keys
        }
        averaged = fedavg_stacked(stacked, counts.to(self.device))
        del stacked

        w_np = normalized_client_weights(counts).numpy()
        total_samples = int(sum(u.num_samples for u in valid))
        avg_loss = float(
            sum(u.training_loss * w for u, w in zip(valid, w_np))
        )
        # sample-weighted mean of the client-reported train accuracy: the
        # deployment coordinator's target-accuracy exit criterion reads it
        # (the reference reads the same accuracies through its
        # MetricsCollector, federated_simulation.py:407-428)
        acc_metrics = {}
        reported = [(u.training_metrics.accuracy, w)
                    for u, w in zip(valid, w_np)
                    if u.training_metrics is not None]
        if reported:
            wsum = sum(w for _, w in reported)
            if wsum > 0:
                acc_metrics["train_accuracy"] = float(
                    sum(a * w for a, w in reported) / wsum
                )
        model = GlobalModel(
            round_number=valid[0].round_number,
            model_weights=averaged,
            accuracy_metrics=acc_metrics,
            participating_clients=[u.client_id for u in valid],
            convergence_score=0.0,
        )
        self._record_stats(valid, w_np, total_samples, avg_loss,
                           time.perf_counter() - t0)
        return model

    def validate_update(self, update: ModelUpdate) -> bool:
        if not self.validate_updates or self.validator is None:
            return True
        return self.validator.validate_model_update(update)

    def calculate_convergence_metrics(
        self, old_model: Optional[GlobalModel], new_model: Optional[GlobalModel]
    ) -> float:
        if not old_model or not new_model:
            return 1.0
        common = [k for k in new_model.model_weights if k in old_model.model_weights]
        old = {k: weight_tensor(old_model.model_weights[k], self.device)
               for k in common}
        new = {k: weight_tensor(new_model.model_weights[k], self.device)
               for k in common}
        return float(convergence_score(old, new))

    def get_aggregation_stats(self) -> Dict[str, Any]:
        if not self.aggregation_history:
            return {"message": "No aggregation history available"}
        recent = self.aggregation_history[-10:]
        participation: Dict[str, int] = {}
        for s in self.aggregation_history:
            for cid in s["client_weights"]:
                participation[cid] = participation.get(cid, 0) + 1
        total_rounds = len(self.aggregation_history)
        return {
            "total_aggregations": total_rounds,
            "recent_aggregations": len(recent),
            "avg_clients_per_round": float(np.mean([s["num_clients"] for s in recent])),
            "avg_samples_per_round": float(np.mean([s["total_samples"] for s in recent])),
            "avg_aggregation_time": float(np.mean([s["aggregation_time"] for s in recent])),
            "avg_training_loss": float(np.mean([s["avg_training_loss"] for s in recent])),
            "client_participation": {
                "unique_clients": len(participation),
                "avg_participation_rate": float(
                    np.mean(list(participation.values())) / total_rounds
                ) if participation else 0.0,
                "most_active_clients": sorted(
                    participation.items(), key=lambda kv: kv[1], reverse=True
                )[:5],
            },
        }

    # -- internals ------------------------------------------------------------
    def _filter_updates(self, updates: List[ModelUpdate]) -> List[ModelUpdate]:
        """Validation filter (ref: _filter_and_validate_updates,
        fedavg.py:209-245, without its pop-while-iterating bug:
        incompatible updates are left out by a comprehension)."""
        valid: List[ModelUpdate] = []
        for u in updates:
            if u.num_samples <= 0:
                logger.warning("Skipping %s: invalid sample count", u.client_id)
                continue
            if u.training_loss < 0:
                logger.warning("Skipping %s: invalid training loss", u.client_id)
                continue
            if self.validate_updates and not self.validate_update(u):
                logger.warning("Skipping %s: validation failed", u.client_id)
                continue
            valid.append(u)
        if len(valid) > 1:
            ref = valid[0].model_weights
            kept = [valid[0]]
            for u in valid[1:]:
                try:
                    validate_model_compatibility(ref, u.model_weights)
                    kept.append(u)
                except Exception as e:
                    logger.warning("Removing incompatible update from %s: %s",
                                   u.client_id, e)
            valid = kept
        return valid

    def _record_stats(self, updates, weights, total_samples, avg_loss, dt):
        self.aggregation_history.append({
            "timestamp": time.time(),
            "num_clients": len(updates),
            "total_samples": total_samples,
            "avg_training_loss": avg_loss,
            "aggregation_time": dt,
            "client_weights": {u.client_id: float(w)
                               for u, w in zip(updates, weights)},
            "client_samples": {u.client_id: u.num_samples for u in updates},
        })
        if len(self.aggregation_history) > 100:
            self.aggregation_history = self.aggregation_history[-100:]


class AdaptiveFedAvg(FedAvgAggregator):
    """Performance-aware weighting: blends sample weights with an
    inverse-loss performance score (ref: AdaptiveFedAvg,
    src/aggregation/fedavg.py:360-467)."""

    def __init__(
        self,
        min_clients: int = 2,
        max_clients: Optional[int] = None,
        validate_updates: bool = True,
        performance_weight: float = 0.1,
        device=None,
    ):
        super().__init__(min_clients, max_clients, validate_updates,
                         device=device)
        self.performance_weight = performance_weight
        self.client_performance_history: Dict[str, Dict[str, Any]] = {}

    def aggregate_updates(self, updates, weights=None):
        self._update_performance_history(updates)
        if weights is None:
            weights = self._adaptive_weights(updates)
        return super().aggregate_updates(updates, weights)

    def _update_performance_history(self, updates: List[ModelUpdate]) -> None:
        for u in updates:
            h = self.client_performance_history.setdefault(
                u.client_id,
                {"losses": [], "sample_counts": [], "participation_count": 0},
            )
            h["losses"] = (h["losses"] + [u.training_loss])[-10:]
            h["sample_counts"] = (h["sample_counts"] + [u.num_samples])[-10:]
            h["participation_count"] += 1

    def _adaptive_weights(self, updates: List[ModelUpdate]) -> List[float]:
        total = sum(u.num_samples for u in updates)
        sample_w = [
            (u.num_samples / total) if total else 1.0 / len(updates)
            for u in updates
        ]
        if self.performance_weight == 0:
            return sample_w
        all_losses = [
            float(np.mean(h["losses"]))
            for h in self.client_performance_history.values() if h["losses"]
        ]
        max_loss = max(all_losses) if all_losses else 0.0
        adj = []
        for u in updates:
            h = self.client_performance_history.get(u.client_id)
            if h and h["losses"] and max_loss > 0:
                adj.append(1.0 - float(np.mean(h["losses"])) / max_loss)
            else:
                adj.append(1.0)
        blended = [
            (1 - self.performance_weight) * sw + self.performance_weight * a
            for sw, a in zip(sample_w, adj)
        ]
        s = sum(blended)
        return [b / s for b in blended] if s else sample_w


def create_fedavg_aggregator(aggregator_type: str = "standard",
                             **kwargs) -> FedAvgAggregator:
    """Factory (ref: create_fedavg_aggregator, fedavg.py:470-484)."""
    if aggregator_type == "adaptive":
        return AdaptiveFedAvg(**kwargs)
    return FedAvgAggregator(**kwargs)


def benchmark_aggregation_performance(
    num_clients_list=(5, 10, 25, 50), model_size: int = 1_000_000,
    device=None,
) -> Dict[str, Any]:
    """Throughput over dummy updates (ref: fedavg.py:487-548): the mean
    time of 5 :func:`fedavg_stacked` calls on ``device`` (the card by
    default; a CUDA run synchronizes before reading the clock)."""
    device = resolve_device("benchmark_aggregation_performance", device,
                            None)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    results: Dict[str, Any] = {}
    rng = np.random.default_rng(0)
    for n in num_clients_list:
        layer = model_size // 4
        stacked = {
            f"layer{i}": to_device(rng.normal(size=(n, layer)).astype(
                np.float32), device)
            for i in range(4)
        }
        counts = to_device(rng.integers(100, 1000, size=n).astype(
            np.float32), device)
        fedavg_stacked(stacked, counts)
        sync()
        t0 = time.perf_counter()
        for _ in range(5):
            fedavg_stacked(stacked, counts)
        sync()
        dt = (time.perf_counter() - t0) / 5
        results[f"{n}_clients"] = {
            "aggregation_time": dt,
            "throughput": n / dt,
            "memory_usage": int(model_size * 4),
        }
    return results
