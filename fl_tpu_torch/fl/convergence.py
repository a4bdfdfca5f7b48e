"""Convergence detection and early stopping for the federated round loop.

A copy of ``fl_tpu.fl.convergence`` (numpy only), so the port imports no JAX.

Parity target: src/aggregation/convergence.py — the three early-stop
criteria (patience without accuracy improvement, windowed convergence-score
threshold, accuracy plateau, ref :152-187), the composite convergence score
(relative weight change + negative accuracy change + positive loss change,
ref :229-248), confidence from recent-score std (ref :250-268), and the
variance-adaptive threshold variant (ref :330-383+).

Runs on host over scalar metrics (it consumes one float per round — there is
nothing to accelerate), but the weight-change norms it needs are computed
on-device by the round engine and handed in as scalars.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np


@dataclass
class ConvergenceMetrics:
    """ref: ConvergenceMetrics, src/aggregation/convergence.py:24-34."""

    weight_change_norm: float = 0.0
    relative_weight_change: float = 0.0
    accuracy_change: float = 0.0
    loss_change: float = 0.0
    convergence_score: float = 0.0
    is_converged: bool = False
    confidence: float = 0.0


@dataclass
class RoundObservation:
    """One round's scalar observations, produced by the round engine."""

    round_number: int
    accuracy: float
    loss: float
    weight_change_norm: float = 0.0       # ‖θ_t − θ_{t−1}‖₂ (global)
    weight_norm: float = 0.0              # ‖θ_t‖₂ (global)


class ConvergenceDetector:
    """ref: ConvergenceDetector, src/aggregation/convergence.py:37-327."""

    def __init__(
        self,
        patience: int = 5,
        min_delta: float = 1e-4,
        window_size: int = 3,
        convergence_threshold: float = 1e-3,
    ):
        self.patience = patience
        self.min_delta = min_delta
        self.window_size = window_size
        self.convergence_threshold = convergence_threshold

        self.accuracy_history: Deque[float] = deque(maxlen=100)
        self.loss_history: Deque[float] = deque(maxlen=100)
        self.weight_change_history: Deque[float] = deque(maxlen=100)
        self.convergence_history: Deque[Dict[str, Any]] = deque(maxlen=100)

        self.best_accuracy = 0.0
        self.best_loss = float("inf")
        self.rounds_without_improvement = 0
        self.converged = False
        self._prev: Optional[RoundObservation] = None

    # -- per-round update ----------------------------------------------------
    def update(self, obs: RoundObservation) -> ConvergenceMetrics:
        """Ingest one round's metrics; returns the composite convergence
        metrics (ref: calculate_convergence_metrics, convergence.py:74-150)."""
        m = ConvergenceMetrics()
        self.accuracy_history.append(obs.accuracy)
        self.loss_history.append(obs.loss)

        if self._prev is not None:
            m.weight_change_norm = obs.weight_change_norm
            m.relative_weight_change = (
                obs.weight_change_norm / obs.weight_norm
                if obs.weight_norm > 0 else 0.0
            )
            m.accuracy_change = obs.accuracy - self._prev.accuracy
            m.loss_change = obs.loss - self._prev.loss
            self.weight_change_history.append(m.weight_change_norm)

        m.convergence_score = self._score(m)
        m.is_converged, m.confidence = self._check(m)

        self.convergence_history.append({
            "round": obs.round_number,
            "accuracy": obs.accuracy,
            "loss": obs.loss,
            "convergence_score": m.convergence_score,
            "is_converged": m.is_converged,
        })

        if obs.accuracy > self.best_accuracy:
            self.best_accuracy = obs.accuracy
            self.rounds_without_improvement = 0
        else:
            self.rounds_without_improvement += 1
        self.best_loss = min(self.best_loss, obs.loss)
        self.converged = m.is_converged
        self._prev = obs
        return m

    # -- early stopping (ref: should_stop_early, convergence.py:152-187) -----
    def should_stop_early(self) -> Tuple[bool, str]:
        if self.rounds_without_improvement >= self.patience:
            return True, f"No improvement for {self.patience} rounds"

        if len(self.convergence_history) >= self.window_size:
            recent = [h["convergence_score"]
                      for h in list(self.convergence_history)[-self.window_size:]]
            avg = float(np.mean(recent))
            if avg < self.convergence_threshold:
                return True, f"Convergence threshold reached (score: {avg:.6f})"

        if len(self.accuracy_history) >= self.window_size * 2:
            acc = list(self.accuracy_history)
            recent_avg = float(np.mean(acc[-self.window_size:]))
            older_avg = float(
                np.mean(acc[-self.window_size * 2: -self.window_size])
            )
            if abs(recent_avg - older_avg) < self.min_delta:
                return True, (
                    f"Accuracy plateaued (change: {abs(recent_avg - older_avg):.6f})"
                )
        return False, "Continue training"

    # -- internals -------------------------------------------------------------
    def _score(self, m: ConvergenceMetrics) -> float:
        """Composite score; lower = more converged
        (ref: _calculate_convergence_score, convergence.py:229-248)."""
        score = 0.0
        if m.relative_weight_change > 0:
            score += m.relative_weight_change
        if m.accuracy_change < 0:
            score += abs(m.accuracy_change)
        if m.loss_change > 0:
            score += m.loss_change
        return score

    def _check(self, m: ConvergenceMetrics) -> Tuple[bool, float]:
        """ref: _check_convergence, convergence.py:250-268."""
        is_conv = m.convergence_score < self.convergence_threshold
        confidence = 0.0
        if len(self.convergence_history) >= 3:
            recent = [h["convergence_score"]
                      for h in list(self.convergence_history)[-3:]]
            avg, std = float(np.mean(recent)), float(np.std(recent))
            confidence = max(0.0, 1.0 - std) if avg < self.convergence_threshold else 0.0
        return is_conv, confidence

    # -- summaries ----------------------------------------------------------
    def get_convergence_summary(self) -> Dict[str, Any]:
        """ref: get_convergence_summary, convergence.py:270-297."""
        if not self.convergence_history:
            return {"message": "No convergence data available"}
        recent = list(self.convergence_history)[-10:]
        stop, reason = self.should_stop_early()
        return {
            "current_status": {
                "converged": self.converged,
                "best_accuracy": self.best_accuracy,
                "best_loss": self.best_loss,
                "rounds_without_improvement": self.rounds_without_improvement,
                "total_rounds": len(self.convergence_history),
            },
            "recent_performance": {
                "avg_accuracy": float(np.mean([h["accuracy"] for h in recent])),
                "avg_loss": float(np.mean([h["loss"] for h in recent])),
                "avg_convergence_score": float(
                    np.mean([h["convergence_score"] for h in recent])
                ),
                "convergence_trend": _trend(
                    [h["convergence_score"] for h in recent]
                ),
            },
            "early_stopping": {
                "patience": self.patience,
                "min_delta": self.min_delta,
                "should_stop": stop,
                "stop_reason": reason,
            },
        }

    def reset(self) -> None:
        self.accuracy_history.clear()
        self.loss_history.clear()
        self.weight_change_history.clear()
        self.convergence_history.clear()
        self.best_accuracy = 0.0
        self.best_loss = float("inf")
        self.rounds_without_improvement = 0
        self.converged = False
        self._prev = None


class AdaptiveConvergenceDetector(ConvergenceDetector):
    """Variance-adaptive threshold (ref: AdaptiveConvergenceDetector,
    convergence.py:330-407): high recent-score variance relaxes the
    threshold (up to 2× initial), low variance tightens it (down to
    0.1× initial)."""

    def __init__(self, *args, adaptation_rate: float = 0.1, **kwargs):
        super().__init__(*args, **kwargs)
        self.initial_threshold = self.convergence_threshold
        self.adaptation_rate = adaptation_rate

    def update(self, obs: RoundObservation) -> ConvergenceMetrics:
        m = super().update(obs)
        self._adapt()
        return m

    def _adapt(self) -> None:
        if len(self.convergence_history) < 5:
            return
        recent = [h["convergence_score"]
                  for h in list(self.convergence_history)[-5:]]
        var = float(np.var(recent))
        if var > 0.01:
            self.convergence_threshold = min(
                self.initial_threshold * 2,
                self.convergence_threshold * (1 + self.adaptation_rate),
            )
        else:
            self.convergence_threshold = max(
                self.initial_threshold * 0.1,
                self.convergence_threshold * (1 - self.adaptation_rate),
            )


def analyze_convergence_patterns(
    score_series: List[float], window: int = 5
) -> Dict[str, Any]:
    """Offline convergence-series analysis (ref:
    analyze_convergence_patterns, convergence.py:410-502): trend, volatility,
    rounds-to-converge estimate."""
    if len(score_series) < 2:
        return {"message": "insufficient data"}
    arr = np.asarray(score_series, np.float64)
    slope = float(np.polyfit(np.arange(len(arr)), arr, 1)[0])
    recent = arr[-window:]
    return {
        "trend": _trend(arr.tolist()),
        "slope": slope,
        "volatility": float(np.std(recent)),
        "current_score": float(arr[-1]),
        "best_score": float(arr.min()),
        "estimated_rounds_to_converge": (
            int(math.ceil(arr[-1] / -slope)) if slope < -1e-9 else None
        ),
    }


def _trend(values: List[float]) -> str:
    """ref: _calculate_trend, convergence.py:299-313."""
    if len(values) < 2:
        return "insufficient_data"
    slope = float(np.polyfit(np.arange(len(values)), values, 1)[0])
    if slope < -0.001:
        return "improving"
    if slope > 0.001:
        return "degrading"
    return "stable"
