"""Cross-service data model (port of ``fl_tpu.core.types``).

The host-side payload types that flow between the round manager, the
services layer (gRPC) and the harnesses. Parity target:
``src/shared/models.py:13-170`` in the reference. Weights are flat
``{path: array}`` dicts whose values are numpy arrays or torch tensors:
the aggregator's averaged leaves stay tensors on its device and become
numpy only at the wire (:func:`weights_like`).

The round engines' state (stacked client params, seeds) does not use these
classes; they are the host and wire representation only.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

# A model's weights as a flat mapping of parameter path -> array
# (ref: ModelWeights alias, src/shared/models.py:168)
ModelWeights = Dict[str, Any]
ClientID = str
RoundNumber = int


class ComputePowerLevel(enum.Enum):
    """Client compute class used for capability-adaptive round configs.

    ref: src/shared/models.py:13-17 and the proto enum ComputePowerLevel
    (proto/federated_learning.proto:66-71).
    """

    LOW = "low"
    MEDIUM = "medium"
    HIGH = "high"


@dataclass
class PrivacyConfig:
    """Differential-privacy parameters. ref: src/shared/models.py:20-37.

    ``epsilon``/``delta`` are the (ε, δ) budget per noising operation,
    ``max_grad_norm`` the L2 clipping bound C, ``noise_multiplier`` the
    σ/C ratio used by the DP-SGD mode (the delta-clipping mode derives σ
    from the Gaussian-mechanism formula instead).
    """

    epsilon: float
    delta: float
    max_grad_norm: float = 1.0
    noise_multiplier: float = 1.0

    def __post_init__(self) -> None:
        if self.epsilon <= 0:
            raise ValueError("Epsilon must be positive")
        if self.delta < 0 or self.delta >= 1:
            raise ValueError("Delta must be in [0, 1)")
        if self.max_grad_norm <= 0:
            raise ValueError("Max gradient norm must be positive")
        if self.noise_multiplier < 0:
            raise ValueError("Noise multiplier must be non-negative")


@dataclass
class ClientCapabilities:
    """Client compute/network capability report. ref: src/shared/models.py:40-47."""

    compute_power: ComputePowerLevel
    network_bandwidth: int  # Mbps
    available_samples: int
    supported_models: List[str] = field(default_factory=list)
    privacy_requirements: Optional[PrivacyConfig] = None


@dataclass
class TrainingMetrics:
    """Per-client local-training metrics. ref: src/shared/models.py:90-97.

    ``additional_metrics`` maps onto the proto's open-ended
    ``map<string, double>`` field (proto/federated_learning.proto:151),
    the carrier of extension signals such as wire adaptive clipping's
    DP-noised clipped-count indicator (``adaptive_clip_indicator``)."""

    loss: float
    accuracy: float
    epochs_completed: int
    training_time: float
    samples_processed: int
    additional_metrics: Dict[str, float] = field(default_factory=dict)


@dataclass
class ModelUpdate:
    """A client's (possibly DP-noised, possibly compressed) update for one
    round. ref: src/shared/models.py:50-72."""

    client_id: ClientID
    round_number: RoundNumber
    model_weights: ModelWeights
    num_samples: int
    training_loss: float
    privacy_budget_used: float = 0.0
    compression_ratio: float = 1.0
    timestamp: float = field(default_factory=time.time)
    training_metrics: Optional[TrainingMetrics] = None

    def validate(self) -> bool:
        """Integrity bounds-check mirroring ModelUpdate.validate
        (ref: src/shared/models.py:62-72)."""
        if not self.client_id or self.round_number < 0:
            return False
        if self.num_samples <= 0 or self.training_loss < 0:
            return False
        if not (0 <= self.privacy_budget_used <= 1):
            return False
        if not (0 <= self.compression_ratio <= 1):
            return False
        return True


@dataclass
class GlobalModel:
    """Aggregated global model + round metadata. ref: src/shared/models.py:75-87."""

    round_number: RoundNumber
    model_weights: ModelWeights
    accuracy_metrics: Dict[str, float] = field(default_factory=dict)
    participating_clients: List[ClientID] = field(default_factory=list)
    convergence_score: float = 0.0
    created_at: float = field(default_factory=time.time)

    def get_accuracy(self, dataset: str = "test") -> Optional[float]:
        return self.accuracy_metrics.get(f"{dataset}_accuracy")


@dataclass
class RegistrationResponse:
    """ref: src/shared/models.py:100-106."""

    success: bool
    client_id: ClientID
    message: str
    global_model_version: int


@dataclass
class ModelResponse:
    """ref: src/shared/models.py:109-115."""

    success: bool
    model_weights: Optional[ModelWeights]
    round_number: RoundNumber
    message: str


@dataclass
class AckResponse:
    """ref: src/shared/models.py:118-123."""

    success: bool
    message: str
    next_round_eta: Optional[float] = None


@dataclass
class RoundConfig:
    """Per-round hyperparameters pushed to clients.
    ref: src/shared/models.py:126-135 + proto RoundConfig
    (proto/federated_learning.proto:170-181)."""

    round_number: RoundNumber = 0
    min_clients: int = 2
    max_clients: int = 50
    local_epochs: int = 5
    batch_size: int = 32
    learning_rate: float = 0.001
    timeout_seconds: int = 300
    optimizer_type: str = "adam"
    privacy_config: Optional[PrivacyConfig] = None
    additional_params: Dict[str, str] = field(default_factory=dict)


@dataclass
class TrainingStatus:
    """Coordinator-side training progress snapshot.
    ref: src/shared/models.py:138-146."""

    current_round: RoundNumber
    active_clients: int
    round_progress: float  # 0.0 to 1.0
    global_accuracy: float
    convergence_score: float
    estimated_completion: Optional[float] = None


@dataclass
class CompressedUpdate:
    """Compressed wire form of a ModelUpdate. ref: src/shared/models.py:149-164."""

    client_id: ClientID
    round_number: RoundNumber
    compressed_weights: bytes
    compression_metadata: Dict[str, Any]
    original_size: int
    compressed_size: int

    @property
    def compression_ratio(self) -> float:
        if self.original_size == 0:
            return 0.0
        return self.compressed_size / self.original_size


def to_numpy(value) -> np.ndarray:
    """One weight as a host numpy array: a tensor (on any device) is
    detached and copied to the host, anything else goes through
    ``np.asarray``."""
    if hasattr(value, "detach"):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def weights_like(weights: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Materialize a weights mapping on the host as numpy (device -> host
    copy)."""
    return {k: to_numpy(v) for k, v in weights.items()}
