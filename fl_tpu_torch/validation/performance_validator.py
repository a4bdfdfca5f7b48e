"""Performance and scalability validation (port of
``fl_tpu.validation.performance_validator``).

Parity target: src/validation/performance_validator.py — the requirement
constants (:95-102: max latency 5000 ms, min throughput 10 rps, min
accuracy 0.91, 25% latency-reduction target, 50-client cap) and the
baseline / scalability (5→50 clients) / load / stress (1.5×) / endurance
battery. Every test drives the port's round engine on ``device`` (None:
the card), so the numbers are measurements. A round's latency is read
between two host clocks, each taken after the device's queue has drained
(``torch.cuda.synchronize``), so that the clock does not stop at the
first asynchronous launch.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class PerformanceRequirements:
    """ref: requirement constants, performance_validator.py:95-102."""

    max_latency_ms: float = 5000.0
    min_throughput_rps: float = 10.0
    min_accuracy: float = 0.91
    latency_reduction_target: float = 0.25
    max_clients: int = 50


class PerformanceValidator:
    """ref: PerformanceValidator, performance_validator.py:86-180+."""

    def __init__(self,
                 requirements: Optional[PerformanceRequirements] = None,
                 samples_per_client: int = 64,
                 local_epochs: int = 1,
                 batch_size: int = 32,
                 device=None):
        self.req = requirements or PerformanceRequirements()
        self.samples_per_client = samples_per_client
        self.local_epochs = local_epochs
        self.batch_size = batch_size
        self.device = device
        self._engines: Dict[int, Any] = {}

    def _engine(self, num_clients: int):
        if num_clients in self._engines:
            return self._engines[num_clients]
        from fl_tpu_torch.data import load_dataset, make_federated_arrays
        from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
        from fl_tpu_torch.models import create_model
        from fl_tpu_torch.orchestration import (
            FederatedRoundEngine,
            RoundEngineConfig,
        )

        splits = load_dataset(
            "mnist",
            n_train_synth=num_clients * self.samples_per_client,
            n_test_synth=256,
        )
        arrays = make_federated_arrays(
            splits, num_clients=num_clients, strategy="iid",
            samples_per_client=self.samples_per_client, seed=0,
        )
        eng = FederatedRoundEngine(
            create_model("simple_cnn"), arrays,
            RoundEngineConfig(
                training=FederatedTrainingConfig(
                    local_epochs=self.local_epochs,
                    batch_size=self.batch_size,
                ),
                max_clients=num_clients, seed=0,
            ),
            device=self.device,
        )
        self._engines[num_clients] = eng
        return eng

    @staticmethod
    def _clock(eng) -> float:
        """The host clock after the engine's device has drained."""
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        return time.perf_counter()

    def _round_ms(self, eng) -> float:
        t0 = self._clock(eng)
        eng.run_round(evaluate=False)
        return (self._clock(eng) - t0) * 1000.0

    def _measure_round(self, num_clients: int,
                       rounds: int = 5) -> Dict[str, float]:
        eng = self._engine(num_clients)
        eng.run_round(evaluate=False)  # warm-up
        t0 = self._clock(eng)
        for _ in range(rounds):
            eng.run_round(evaluate=False)
        dt = (self._clock(eng) - t0) / rounds
        return {
            "round_latency_ms": dt * 1000.0,
            "rounds_per_sec": 1.0 / dt,
            "client_updates_per_sec": num_clients / dt,
        }

    # -- the battery -----------------------------------------------------------
    def run_baseline_test(self, num_clients: int = 5) -> Dict[str, Any]:
        """Small-population latency baseline (ref: baseline section)."""
        m = self._measure_round(num_clients)
        passed = m["round_latency_ms"] <= self.req.max_latency_ms
        return {"test": "baseline", "num_clients": num_clients,
                "passed": passed, **m}

    def run_scalability_test(
        self, client_counts: Optional[List[int]] = None
    ) -> Dict[str, Any]:
        """5→50 client ramp (ref: scalability section): latency must grow
        sublinearly in clients."""
        counts = client_counts or [5, 10, 25, 50]
        series = {c: self._measure_round(c) for c in counts}
        lat = [series[c]["round_latency_ms"] for c in counts]
        scale = counts[-1] / counts[0]
        latency_growth = lat[-1] / lat[0] if lat[0] > 0 else float("inf")
        passed = (latency_growth <= scale
                  and lat[-1] <= self.req.max_latency_ms)
        return {
            "test": "scalability",
            "passed": passed,
            "client_counts": counts,
            "latencies_ms": lat,
            "latency_growth": latency_growth,
            "client_scale": scale,
            "series": series,
        }

    def run_load_test(self, num_clients: int = 50,
                      rounds: int = 10) -> Dict[str, Any]:
        """Sustained max-population rounds (ref: load section)."""
        eng = self._engine(num_clients)
        eng.run_round(evaluate=False)
        latencies = [self._round_ms(eng) for _ in range(rounds)]
        p50, p95 = np.percentile(latencies, [50, 95])
        throughput = num_clients / (np.mean(latencies) / 1000.0)
        passed = bool(p95 <= self.req.max_latency_ms
                      and throughput >= self.req.min_throughput_rps)
        return {
            "test": "load", "passed": passed, "rounds": rounds,
            "latency_p50_ms": float(p50), "latency_p95_ms": float(p95),
            "client_updates_per_sec": float(throughput),
        }

    def run_stress_test(self) -> Dict[str, Any]:
        """1.5× the required max clients (ref: stress section)."""
        n = int(self.req.max_clients * 1.5)
        m = self._measure_round(n, rounds=3)
        return {
            "test": "stress", "num_clients": n,
            "passed": m["round_latency_ms"] <= self.req.max_latency_ms,
            **m,
        }

    def run_endurance_test(self, duration_s: float = 60.0,
                           num_clients: int = 10) -> Dict[str, Any]:
        """Sustained rounds over wall-clock (ref: 30-min endurance
        section; latency drift must stay bounded)."""
        eng = self._engine(num_clients)
        eng.run_round(evaluate=False)
        latencies = []
        deadline = time.time() + duration_s
        while time.time() < deadline:
            latencies.append(self._round_ms(eng))
        half = max(1, len(latencies) // 2)
        drift = (np.mean(latencies[half:]) / np.mean(latencies[:half])
                 if len(latencies) >= 2 else 1.0)
        return {
            "test": "endurance",
            "passed": bool(drift < 1.5),
            "rounds_completed": len(latencies),
            "latency_drift": float(drift),
            "mean_latency_ms": float(np.mean(latencies)) if latencies else 0,
        }

    def run_all(self, endurance_s: float = 30.0) -> Dict[str, Any]:
        results = {
            "baseline": self.run_baseline_test(),
            "scalability": self.run_scalability_test(),
            "load": self.run_load_test(),
            "stress": self.run_stress_test(),
            "endurance": self.run_endurance_test(endurance_s),
        }
        results["all_passed"] = all(r["passed"] for r in results.values())
        results["requirements"] = self.req.__dict__
        return results
