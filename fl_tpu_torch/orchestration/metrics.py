"""Coordinator metrics collection (port of
``fl_tpu.orchestration.metrics``, copied: host code only).

Parity target: src/coordinator/metrics_tracker.py — RoundMetrics (:21-43),
ClientMetrics (:45-63), SystemMetrics (:65-81), MetricsCollector (:83-462:
round lifecycle recording, per-client aggregates, training-progress series,
ETA estimation, JSON export) and MetricsTracker (:465-551: periodic system
sampling). System sampling uses psutil when present and degrades gracefully.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Any, Deque, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


@dataclass
class RoundMetrics:
    """ref: RoundMetrics, metrics_tracker.py:21-43."""

    round_number: int
    started_at: float
    completed_at: Optional[float] = None
    participating_clients: int = 0
    total_samples: int = 0
    avg_training_loss: float = 0.0
    global_accuracy: float = 0.0
    convergence_score: float = 0.0
    aggregation_time_s: float = 0.0
    success: bool = True

    @property
    def duration_s(self) -> float:
        return (self.completed_at or time.time()) - self.started_at


@dataclass
class ClientMetrics:
    """ref: ClientMetrics, metrics_tracker.py:45-63."""

    client_id: str
    rounds_participated: int = 0
    total_samples: int = 0
    avg_loss: float = 0.0
    avg_accuracy: float = 0.0
    last_seen: float = field(default_factory=time.time)
    failures: int = 0


@dataclass
class SystemMetrics:
    """ref: SystemMetrics, metrics_tracker.py:65-81."""

    timestamp: float
    cpu_percent: float = 0.0
    memory_percent: float = 0.0
    disk_percent: float = 0.0
    net_bytes_sent: int = 0
    net_bytes_recv: int = 0
    device_count: int = 0


def sample_system_metrics() -> SystemMetrics:
    """psutil-backed sample; zeros when psutil is unavailable
    (ref: get_system_metrics, metrics_tracker.py:284-326). The device
    count is ``torch.cuda.device_count()``."""
    m = SystemMetrics(timestamp=time.time())
    try:
        import psutil

        m.cpu_percent = psutil.cpu_percent(interval=None)
        m.memory_percent = psutil.virtual_memory().percent
        m.disk_percent = psutil.disk_usage("/").percent
        net = psutil.net_io_counters()
        m.net_bytes_sent = net.bytes_sent
        m.net_bytes_recv = net.bytes_recv
    except Exception:
        pass
    try:
        import torch

        m.device_count = torch.cuda.device_count()
    except Exception:
        pass
    return m


class MetricsCollector:
    """ref: MetricsCollector, metrics_tracker.py:83-462."""

    def __init__(self, max_history: int = 1000):
        self._lock = threading.RLock()
        self.round_metrics: Deque[RoundMetrics] = deque(maxlen=max_history)
        self.client_metrics: Dict[str, ClientMetrics] = {}
        self.system_metrics: Deque[SystemMetrics] = deque(maxlen=max_history)
        self._open_rounds: Dict[int, RoundMetrics] = {}
        self.started_at = time.time()

    # -- round lifecycle (ref :124-283) ----------------------------------------
    def start_round(self, round_number: int) -> None:
        with self._lock:
            self._open_rounds[round_number] = RoundMetrics(
                round_number=round_number, started_at=time.time()
            )

    def record_client_update(self, round_number: int, client_id: str,
                             num_samples: int, loss: float,
                             accuracy: float = 0.0) -> None:
        with self._lock:
            rm = self._open_rounds.get(round_number)
            if rm is not None:
                rm.participating_clients += 1
                rm.total_samples += num_samples
            cm = self.client_metrics.setdefault(
                client_id, ClientMetrics(client_id=client_id)
            )
            n = cm.rounds_participated
            cm.avg_loss = (cm.avg_loss * n + loss) / (n + 1)
            cm.avg_accuracy = (cm.avg_accuracy * n + accuracy) / (n + 1)
            cm.rounds_participated += 1
            cm.total_samples += num_samples
            cm.last_seen = time.time()

    def record_client_failure(self, client_id: str) -> None:
        with self._lock:
            cm = self.client_metrics.setdefault(
                client_id, ClientMetrics(client_id=client_id)
            )
            cm.failures += 1

    def complete_round(self, round_number: int, avg_training_loss: float,
                       global_accuracy: float, convergence_score: float,
                       aggregation_time_s: float = 0.0,
                       success: bool = True) -> None:
        with self._lock:
            rm = self._open_rounds.pop(round_number, None)
            if rm is None:
                rm = RoundMetrics(round_number=round_number,
                                  started_at=time.time())
            rm.completed_at = time.time()
            rm.avg_training_loss = avg_training_loss
            rm.global_accuracy = global_accuracy
            rm.convergence_score = convergence_score
            rm.aggregation_time_s = aggregation_time_s
            rm.success = success
            self.round_metrics.append(rm)

    def record_system_sample(self) -> SystemMetrics:
        m = sample_system_metrics()
        with self._lock:
            self.system_metrics.append(m)
        return m

    # -- queries (ref :328-462) ----------------------------------------------------
    def get_training_progress(self) -> Dict[str, Any]:
        with self._lock:
            rounds = list(self.round_metrics)
        if not rounds:
            return {"rounds_completed": 0}
        acc = [r.global_accuracy for r in rounds]
        losses = [r.avg_training_loss for r in rounds]
        return {
            "rounds_completed": len(rounds),
            "latest_accuracy": acc[-1],
            "best_accuracy": max(acc),
            "latest_loss": losses[-1],
            "accuracy_series": acc[-50:],
            "loss_series": losses[-50:],
            "avg_round_duration_s": float(
                np.mean([r.duration_s for r in rounds[-10:]])
            ),
            "estimated_completion": self._estimate_completion(),
        }

    def _estimate_completion(self, target_accuracy: float = 0.91,
                             max_rounds: int = 100) -> Optional[float]:
        """Linear-trend ETA (ref: _estimate_completion_time,
        metrics_tracker.py:442-462)."""
        with self._lock:
            rounds = list(self.round_metrics)[-10:]
        if len(rounds) < 3:
            return None
        acc = np.asarray([r.global_accuracy for r in rounds])
        slope = float(np.polyfit(np.arange(len(acc)), acc, 1)[0])
        if slope <= 1e-6 or acc[-1] >= target_accuracy:
            return None
        rounds_left = min(max_rounds, (target_accuracy - acc[-1]) / slope)
        avg_dur = float(np.mean([r.duration_s for r in rounds]))
        return time.time() + rounds_left * avg_dur

    def get_client_summary(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {cid: asdict(cm) for cid, cm in self.client_metrics.items()}

    def get_system_summary(self) -> Dict[str, Any]:
        with self._lock:
            samples = list(self.system_metrics)[-20:]
        if not samples:
            return {}
        return {
            "cpu_percent": float(np.mean([s.cpu_percent for s in samples])),
            "memory_percent": float(
                np.mean([s.memory_percent for s in samples])
            ),
            "disk_percent": samples[-1].disk_percent,
            "device_count": samples[-1].device_count,
            "uptime_s": time.time() - self.started_at,
        }

    def export_json(self, filepath: str) -> None:
        """ref: export_metrics, metrics_tracker.py:~420."""
        with self._lock:
            payload = {
                "exported_at": time.time(),
                "rounds": [asdict(r) for r in self.round_metrics],
                "clients": {c: asdict(m)
                            for c, m in self.client_metrics.items()},
                "system": [asdict(s) for s in list(self.system_metrics)[-100:]],
            }
        with open(filepath, "w") as f:
            json.dump(payload, f, indent=2)


class MetricsTracker:
    """Background system sampler (ref: MetricsTracker,
    metrics_tracker.py:465-551, 10 s loop :533)."""

    def __init__(self, collector: Optional[MetricsCollector] = None,
                 interval_s: float = 10.0):
        self.collector = collector or MetricsCollector()
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fl-metrics")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.collector.record_system_sample()
            except Exception as e:
                logger.warning("system metrics sample failed: %s", e)
