"""Client-side resource monitoring + training-config adaptation (port of
``fl_tpu.services.capability_adapter``).

Parity target: src/client/capability_adapter.py — ResourceMetrics (:31),
ResourceMonitor (:56-253: psutil background sampling), CapabilityAdapter
(:255-551: adapt batch/epochs/lr to live CPU/memory/accelerator pressure —
halve batch when CPU > 80% (ref :351-368), shrink when memory > 85%
(ref :370-386), and reassess the compute-power class (ref :540-551)).

"GPU monitoring" (pynvml, ref :184+) reads the memory of the adapter's
CUDA device through ``torch.cuda``: reserved bytes over the card's total.
On the CPU there is no accelerator reading.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Any, Deque, Optional

import torch

from fl_tpu_torch.core.types import ComputePowerLevel
from fl_tpu_torch.fl.local_training import FederatedTrainingConfig

logger = logging.getLogger(__name__)

CPU_HIGH = 80.0     # ref :351
MEM_HIGH = 85.0     # ref :370
ACCEL_MEM_HIGH = 90.0


@dataclasses.dataclass
class ResourceMetrics:
    """ref: ResourceMetrics, capability_adapter.py:31-54."""

    timestamp: float
    cpu_percent: float = 0.0
    memory_percent: float = 0.0
    memory_available_mb: float = 0.0
    accelerator_memory_percent: Optional[float] = None
    cpu_cores: int = 1


def sample_resources(device=None) -> ResourceMetrics:
    """ref: _collect_metrics, capability_adapter.py:184-253. ``device``:
    the CUDA device whose memory is read (None: the current one, when
    there is a card)."""
    m = ResourceMetrics(timestamp=time.time())
    try:
        import psutil

        m.cpu_percent = psutil.cpu_percent(interval=None)
        vm = psutil.virtual_memory()
        m.memory_percent = vm.percent
        m.memory_available_mb = vm.available / (1024 * 1024)
        m.cpu_cores = psutil.cpu_count() or 1
    except Exception:
        pass
    dev = None if device is None else torch.device(device)
    if (dev is None or dev.type == "cuda") and torch.cuda.is_available():
        total = torch.cuda.get_device_properties(dev).total_memory
        m.accelerator_memory_percent = (
            100.0 * torch.cuda.memory_reserved(dev) / total)
    return m


class ResourceMonitor:
    """Background sampler (ref: ResourceMonitor,
    capability_adapter.py:56-253)."""

    def __init__(self, interval_s: float = 5.0, max_history: int = 200,
                 device=None):
        self.interval_s = interval_s
        self.device = device
        self.history: Deque[ResourceMetrics] = deque(maxlen=max_history)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.RLock()

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fl-resource-monitor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample()

    def sample(self) -> ResourceMetrics:
        m = sample_resources(self.device)
        with self._lock:
            self.history.append(m)
        return m

    def latest(self) -> ResourceMetrics:
        with self._lock:
            return (self.history[-1] if self.history
                    else sample_resources(self.device))


class CapabilityAdapter:
    """ref: CapabilityAdapter, capability_adapter.py:255-551."""

    def __init__(self, monitor: Optional[ResourceMonitor] = None):
        self.monitor = monitor or ResourceMonitor()
        self.adaptation_log: list = []

    # -- config adaptation (ref: adapt_training_config :294-404) -----------------
    def adapt_training_config(
        self, config: FederatedTrainingConfig,
        metrics: Optional[ResourceMetrics] = None,
    ) -> FederatedTrainingConfig:
        m = metrics or self.monitor.latest()
        batch = config.batch_size
        epochs = config.local_epochs
        lr = config.learning_rate
        reasons = []

        if m.cpu_percent > CPU_HIGH:  # ref: _adapt_for_cpu :351-368
            batch = max(8, batch // 2)
            reasons.append(f"cpu {m.cpu_percent:.0f}% > {CPU_HIGH}")
        if m.memory_percent > MEM_HIGH:  # ref: _adapt_for_memory :370-386
            batch = max(8, batch // 2)
            epochs = max(1, epochs - 1)
            reasons.append(f"memory {m.memory_percent:.0f}% > {MEM_HIGH}")
        if (m.accelerator_memory_percent is not None
                and m.accelerator_memory_percent > ACCEL_MEM_HIGH):
            # ref: _adapt_for_gpu :388-404, mapped to accelerator memory
            batch = max(8, batch // 2)
            reasons.append(
                f"accelerator memory {m.accelerator_memory_percent:.0f}%"
            )

        if reasons:
            self.adaptation_log.append({
                "timestamp": time.time(), "reasons": reasons,
                "batch": (config.batch_size, batch),
                "epochs": (config.local_epochs, epochs),
            })
            logger.info("adapted training config (%s): batch %d->%d, "
                        "epochs %d->%d", "; ".join(reasons),
                        config.batch_size, batch, config.local_epochs, epochs)
        return dataclasses.replace(config, batch_size=batch,
                                   local_epochs=epochs, learning_rate=lr)

    # -- compute-power reassessment (ref: _assess_compute_power :540-551) -------
    def assess_compute_power(
        self, metrics: Optional[ResourceMetrics] = None
    ) -> ComputePowerLevel:
        m = metrics or self.monitor.latest()
        has_accel = m.accelerator_memory_percent is not None
        if has_accel or m.cpu_cores >= 8:
            level = ComputePowerLevel.HIGH
        elif m.cpu_cores >= 4:
            level = ComputePowerLevel.MEDIUM
        else:
            level = ComputePowerLevel.LOW
        # sustained pressure downgrades the class
        if m.cpu_percent > CPU_HIGH or m.memory_percent > MEM_HIGH:
            level = {
                ComputePowerLevel.HIGH: ComputePowerLevel.MEDIUM,
                ComputePowerLevel.MEDIUM: ComputePowerLevel.LOW,
                ComputePowerLevel.LOW: ComputePowerLevel.LOW,
            }[level]
        return level

    def update_capabilities(self, capabilities) -> Any:
        """Refresh a ClientCapabilities from live metrics
        (ref: update_capabilities :506-538)."""
        capabilities.compute_power = self.assess_compute_power()
        return capabilities
