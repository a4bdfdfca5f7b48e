"""Privacy and security validation harness (port of
``fl_tpu.validation.privacy_validator``).

Parity target: src/validation/privacy_validator.py —

- PrivacyValidator (:65-320): statistical check that the observed noise
  matches the Gaussian-mechanism σ within [0.5×, 2×] (ref :104-108), the
  exact budget-accounting test (:166-208) and the split-budget guarantee
  test (:214-291);
- SecurityValidator (:321-503): data-leakage heuristics, model-inversion
  and membership-inference risk estimates;
- ComprehensiveValidator (:505-633) and the canonical
  validate_mnist_federated_learning entry (:635-684).

The noise test drives the production DP path itself
(``fl_tpu_torch.ops.dp.clip_noise_matrix``: K3 on a card), and the
guarantee test ``fl.privacy.create_privacy_engine``'s releases (K3 at
scale 1), so on a card they measure what production runs. ``device``:
None is the card.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from fl_tpu_torch.core import prng
from fl_tpu_torch.core.mesh import resolve_device
from fl_tpu_torch.core.types import PrivacyConfig
from fl_tpu_torch.fl import privacy as dp
from fl_tpu_torch.ops.dp import clip_noise_matrix

logger = logging.getLogger(__name__)


class PrivacyValidator:
    """ref: PrivacyValidator, privacy_validator.py:65-320."""

    def __init__(self, noise_ratio_bounds=(0.5, 2.0), device=None):
        # ref: acceptance band at privacy_validator.py:104-108
        self.noise_ratio_bounds = noise_ratio_bounds
        self.device = device

    def validate_differential_privacy(
        self,
        epsilon: float = 1.0,
        delta: float = 1e-5,
        max_norm: float = 1.0,
        dim: int = 65536,
        trials: int = 4,
        seed: int = 0,
        use_pallas: Optional[bool] = None,
    ) -> Dict[str, Any]:
        """Observed noise std vs expected σ within [0.5×, 2×]
        (ref: validate_differential_privacy :72-164): ``trials`` releases
        of a (trials, dim) matrix through ``clip_noise_matrix``."""
        device = resolve_device("PrivacyValidator", self.device, None)
        root = prng.root_seed(seed)
        ratios: List[float] = []
        for t in range(trials):
            tseed = prng.fold(root, t)
            base = torch.randn((trials, dim), device=device,
                               generator=prng.generator(tseed, device)) * 0.001
            seeds = prng.client_seeds_of(prng.fold(tseed, 99), trials)
            noisy, sens, sigma = clip_noise_matrix(
                base, seeds, epsilon, delta, max_norm,
                use_pallas=use_pallas)
            observed = (noisy - base).std(1)
            ratios.extend((observed / sigma).cpu().tolist())
        lo, hi = self.noise_ratio_bounds
        passed = all(lo < r < hi for r in ratios)
        result = {
            "test": "differential_privacy_noise",
            "passed": passed,
            "epsilon": epsilon,
            "delta": delta,
            "expected_sigma_factor": dp.gaussian_sigma(1.0, epsilon, delta),
            "observed_ratio_min": min(ratios),
            "observed_ratio_max": max(ratios),
            "bounds": self.noise_ratio_bounds,
        }
        logger.info("DP noise validation: %s (ratios %.3f..%.3f)",
                    "PASS" if passed else "FAIL",
                    result["observed_ratio_min"],
                    result["observed_ratio_max"])
        return result

    def validate_privacy_budget_tracking(self) -> Dict[str, Any]:
        """Exact additive accounting (ref: validate_privacy_budget_tracking
        :166-208)."""
        tracker = dp.PrivacyBudgetTracker(1.0, 1e-5)
        spends = [(0.2, 2e-6), (0.3, 3e-6), (0.1, 1e-6)]
        for eps, dlt in spends:
            tracker.consume_budget(eps, dlt)
        status = tracker.get_budget_status()
        expected_eps = sum(e for e, _ in spends)
        expected_dlt = sum(d for _, d in spends)
        ok_eps = math.isclose(status["consumed_epsilon"], expected_eps,
                              rel_tol=1e-12)
        ok_dlt = math.isclose(status["consumed_delta"], expected_dlt,
                              rel_tol=1e-9)
        ok_exhaust = (not tracker.is_budget_exhausted(0.4, 4e-6)
                      and tracker.is_budget_exhausted(0.5, 1e-6))
        return {
            "test": "privacy_budget_tracking",
            "passed": ok_eps and ok_dlt and ok_exhaust,
            "consumed_epsilon": status["consumed_epsilon"],
            "expected_epsilon": expected_eps,
            "operations": status["operations_count"],
        }

    def test_privacy_guarantees(self, splits: int = 5) -> Dict[str, Any]:
        """Split-budget guarantee test: ε split k ways noises k times and
        exhausts exactly (ref: test_privacy_guarantees :214-291)."""
        device = resolve_device("PrivacyValidator", self.device, None)
        total_eps, total_delta = 1.0, 1e-5
        engine = dp.create_privacy_engine(total_eps, total_delta,
                                          device=device)
        eps_r, delta_r = total_eps / splits, total_delta / splits
        grads = {"w": torch.full((1024,), 1e-3, device=device)}
        results = []
        for _ in range(splits):
            noisy = engine.add_noise(grads, eps_r, delta_r)
            results.append(bool(torch.isfinite(noisy["w"]).all()))
        exhausted_after = engine.budget_tracker.is_budget_exhausted(
            eps_r, delta_r)
        overdraw_refused = False
        try:
            engine.add_noise(grads, eps_r, delta_r)
        except dp.PrivacyError:
            overdraw_refused = True
        return {
            "test": "split_budget_guarantees",
            "passed": all(results) and exhausted_after and overdraw_refused,
            "splits": splits,
            "noised_ok": all(results),
            "exhausted_after_splits": exhausted_after,
            "overdraw_refused": overdraw_refused,
        }


class SecurityValidator:
    """Leakage/inference risk heuristics
    (ref: SecurityValidator, privacy_validator.py:321-503)."""

    def check_data_leakage(self, update_weights: Dict[str, Any],
                           raw_samples: np.ndarray) -> Dict[str, Any]:
        """Heuristic: no raw-sample block should appear (near-)verbatim in
        any weight tensor (ref: leakage patterns :328-452)."""
        flat_samples = np.asarray(raw_samples, np.float32).reshape(-1)
        suspicious = []
        probe = flat_samples[: min(256, flat_samples.size)]
        pn = float(np.linalg.norm(probe)) or 1.0
        for name, w in update_weights.items():
            if isinstance(w, torch.Tensor):
                w = w.detach().cpu().numpy()
            arr = np.asarray(w, np.float32).reshape(-1)
            if arr.size < probe.size:
                continue
            # correlation of the probe with a same-length prefix slice
            window = arr[: probe.size]
            denom = (np.linalg.norm(window) * pn) or 1.0
            corr = float(np.dot(window, probe) / denom)
            if abs(corr) > 0.99:
                suspicious.append(name)
        return {
            "test": "data_leakage",
            "passed": not suspicious,
            "suspicious_tensors": suspicious,
        }

    def estimate_model_inversion_risk(self, epsilon: float,
                                      num_params: int,
                                      num_samples: int) -> Dict[str, Any]:
        """ref: :454-476 — ε-keyed risk score modulated by the
        params/samples ratio."""
        base = min(1.0, epsilon / 10.0)
        overparam = min(1.0, num_params / max(num_samples, 1) / 100.0)
        risk = min(1.0, 0.7 * base + 0.3 * overparam)
        return {
            "test": "model_inversion_risk",
            "risk_score": risk,
            "risk_level": ("low" if risk < 0.3 else
                           "medium" if risk < 0.7 else "high"),
        }

    def estimate_membership_inference_risk(self, epsilon: float,
                                           delta: float) -> Dict[str, Any]:
        """ref: :477-503 — the (ε, δ)-DP bound on membership advantage:
        adv ≤ e^ε − 1 + δ (tight for small ε)."""
        advantage = min(1.0, math.exp(epsilon) - 1.0 + delta)
        return {
            "test": "membership_inference_risk",
            "max_advantage_bound": advantage,
            "risk_level": ("low" if advantage < 0.5 else
                           "medium" if advantage < 2.0 else "high"),
        }


class ComprehensiveValidator:
    """All-in-one runner (ref: ComprehensiveValidator,
    privacy_validator.py:505-633)."""

    def __init__(self, device=None):
        self.privacy = PrivacyValidator(device=device)
        self.security = SecurityValidator()

    def run_all(self, privacy_config: Optional[PrivacyConfig] = None,
                use_pallas: Optional[bool] = None) -> Dict[str, Any]:
        cfg = privacy_config or PrivacyConfig(1.0, 1e-5)
        results = {
            "noise": self.privacy.validate_differential_privacy(
                cfg.epsilon, cfg.delta, cfg.max_grad_norm,
                use_pallas=use_pallas,
            ),
            "budget": self.privacy.validate_privacy_budget_tracking(),
            "guarantees": self.privacy.test_privacy_guarantees(),
            "inversion": self.security.estimate_model_inversion_risk(
                cfg.epsilon, 421_642, 60_000),
            "membership": self.security.estimate_membership_inference_risk(
                cfg.epsilon, cfg.delta),
        }
        results["all_passed"] = all(
            r.get("passed", True) for r in results.values()
            if isinstance(r, dict)
        )
        return results


def validate_mnist_federated_learning(
    num_clients: int = 3,
    num_rounds: int = 2,
    use_pallas: Optional[bool] = None,
    device=None,
    **sim_kwargs: Any,
) -> Dict[str, Any]:
    """Canonical validation entry: run a small DP MNIST simulation and the
    full validator battery (ref: validate_mnist_federated_learning,
    privacy_validator.py:635-684)."""
    from fl_tpu_torch.orchestration.simulation import run_mnist_simulation

    sim_kwargs.setdefault("n_train_synth", 2048)
    sim_kwargs.setdefault("n_test_synth", 512)
    sim_kwargs.setdefault("local_epochs", 1)
    sim = run_mnist_simulation(num_clients=num_clients,
                               num_rounds=num_rounds,
                               target_accuracy=0.999, device=device,
                               **sim_kwargs)
    checks = ComprehensiveValidator(device=device).run_all(
        use_pallas=use_pallas)
    return {
        "simulation": {
            "rounds_completed": sim["rounds_completed"],
            "final_accuracy": sim["final_accuracy"],
            "epsilon_spent": sim["total_epsilon_spent"],
        },
        "validation": checks,
        "passed": checks["all_passed"] and sim["rounds_completed"] > 0,
    }
