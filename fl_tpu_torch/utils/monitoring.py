"""System monitoring with threshold alerting (port of
``fl_tpu.utils.monitoring``).

Parity target: src/shared/monitoring.py: SystemMetrics (:20),
TrainingMetrics (:35), CommunicationMetrics (:49), Alert (:61),
MetricsCollector with a background collection loop (:75-165) and the
AlertManager with the default rules CPU>80 / memory>85 / disk>90 /
latency>5000 ms plus callbacks (the reference file's tail is corrupted
from :166; the rule set and the PerformanceMonitor composition follow its
legible intent). ``psutil`` is optional: without it a sample reads 0.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional

logger = logging.getLogger(__name__)


@dataclass
class SystemMetrics:
    """ref: monitoring.py:20-33."""

    timestamp: float
    cpu_percent: float = 0.0
    memory_percent: float = 0.0
    memory_used_mb: float = 0.0
    disk_percent: float = 0.0
    network_bytes_sent: int = 0
    network_bytes_recv: int = 0


@dataclass
class TrainingMetrics:
    """ref: monitoring.py:35-47."""

    timestamp: float
    round_number: int
    loss: float
    accuracy: float
    clients: int
    duration_s: float


@dataclass
class CommunicationMetrics:
    """ref: monitoring.py:49-59."""

    timestamp: float
    operation: str  # e.g. "submit_update", "get_model"
    latency_ms: float
    payload_bytes: int
    success: bool


@dataclass
class Alert:
    """ref: monitoring.py:61-73."""

    name: str
    severity: str  # "warning" | "critical"
    message: str
    metric_value: float
    threshold: float
    timestamp: float = field(default_factory=time.time)


@dataclass
class AlertRule:
    name: str
    metric: str  # attribute name on SystemMetrics / "latency_ms"
    threshold: float
    severity: str = "warning"
    comparator: str = "gt"

    def check(self, value: float) -> bool:
        return value > self.threshold if self.comparator == "gt" \
            else value < self.threshold


# default thresholds (ref intent: CPU>80, mem>85, disk>90, latency>5000ms)
DEFAULT_RULES = [
    AlertRule("high_cpu", "cpu_percent", 80.0, "warning"),
    AlertRule("high_memory", "memory_percent", 85.0, "warning"),
    AlertRule("high_disk", "disk_percent", 90.0, "critical"),
    AlertRule("high_latency", "latency_ms", 5000.0, "warning"),
]


def collect_system_metrics() -> SystemMetrics:
    """ref: collect_system_metrics, monitoring.py:132-160 (psutil-gated)."""
    m = SystemMetrics(timestamp=time.time())
    try:
        import psutil

        m.cpu_percent = psutil.cpu_percent(interval=None)
        vm = psutil.virtual_memory()
        m.memory_percent = vm.percent
        m.memory_used_mb = vm.used / (1024 * 1024)
        m.disk_percent = psutil.disk_usage("/").percent
        net = psutil.net_io_counters()
        m.network_bytes_sent = net.bytes_sent
        m.network_bytes_recv = net.bytes_recv
    except Exception:
        pass
    return m


class AlertManager:
    """Threshold rules -> Alert objects -> callbacks."""

    def __init__(self, rules: Optional[List[AlertRule]] = None):
        self.rules = list(rules if rules is not None else DEFAULT_RULES)
        self.callbacks: List[Callable[[Alert], None]] = []
        self.alert_history: Deque[Alert] = deque(maxlen=200)

    def add_rule(self, rule: AlertRule) -> None:
        self.rules.append(rule)

    def on_alert(self, callback: Callable[[Alert], None]) -> None:
        self.callbacks.append(callback)

    def evaluate(self, metrics: Dict[str, float]) -> List[Alert]:
        fired: List[Alert] = []
        for rule in self.rules:
            value = metrics.get(rule.metric)
            if value is None:
                continue
            if rule.check(value):
                alert = Alert(
                    name=rule.name, severity=rule.severity,
                    message=(f"{rule.metric}={value:.1f} exceeds "
                             f"{rule.threshold}"),
                    metric_value=value, threshold=rule.threshold,
                )
                fired.append(alert)
                self.alert_history.append(alert)
                for cb in self.callbacks:
                    try:
                        cb(alert)
                    except Exception as e:
                        logger.error("alert callback failed: %s", e)
        return fired


class MetricsCollector:
    """Background system collector (ref: MetricsCollector,
    monitoring.py:75-165, _collection_loop :122)."""

    def __init__(self, interval_s: float = 10.0, max_history: int = 1000):
        self.interval_s = interval_s
        self.system_history: Deque[SystemMetrics] = deque(maxlen=max_history)
        self.training_history: Deque[TrainingMetrics] = deque(
            maxlen=max_history)
        self.communication_history: Deque[CommunicationMetrics] = deque(
            maxlen=max_history)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.RLock()

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._collection_loop,
                                        daemon=True, name="fl-monitor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _collection_loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample()

    def sample(self) -> SystemMetrics:
        m = collect_system_metrics()
        with self._lock:
            self.system_history.append(m)
        return m

    def record_training(self, m: TrainingMetrics) -> None:
        with self._lock:
            self.training_history.append(m)

    def record_communication(self, m: CommunicationMetrics) -> None:
        with self._lock:
            self.communication_history.append(m)

    def latest(self) -> Optional[SystemMetrics]:
        with self._lock:
            return self.system_history[-1] if self.system_history else None


class PerformanceMonitor:
    """Collector + alerting composition (ref intent: PerformanceMonitor)."""

    def __init__(self, interval_s: float = 10.0,
                 rules: Optional[List[AlertRule]] = None):
        self.collector = MetricsCollector(interval_s=interval_s)
        self.alerts = AlertManager(rules)

    def start(self) -> None:
        self.collector.start()

    def stop(self) -> None:
        self.collector.stop()

    def check(self) -> List[Alert]:
        """Sample now and evaluate the alert rules."""
        m = self.collector.sample()
        latency = None
        with self.collector._lock:
            if self.collector.communication_history:
                latency = self.collector.communication_history[-1].latency_ms
        metrics = {
            "cpu_percent": m.cpu_percent,
            "memory_percent": m.memory_percent,
            "disk_percent": m.disk_percent,
        }
        if latency is not None:
            metrics["latency_ms"] = latency
        return self.alerts.evaluate(metrics)
