"""Host-side configuration types of the port.

:class:`PrivacyConfig` and :class:`ComputePowerLevel` are ported so far
(``fl_tpu.core.types``); the wire payload classes follow with the
services layer.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


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
