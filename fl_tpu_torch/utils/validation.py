"""Payload validators: model updates, global models, privacy configs,
client capabilities (a copy of ``fl_tpu.utils.validation``).

Parity target: src/shared/validation.py — NaN/Inf/magnitude checks on
weights (|w| ≤ 10, ref :72-99), timestamp skew bounds (24 h past / 5 min
future, ref :101-112), structural compatibility (same keys + shapes,
ref :256-283), and round-config sanity checks (ref :285-315). Weights may be numpy arrays or torch tensors on any
device; the checks read them on the host.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from fl_tpu_torch.core.types import (
    ClientCapabilities,
    GlobalModel,
    ModelUpdate,
    PrivacyConfig,
    to_numpy,
)

logger = logging.getLogger(__name__)

MAX_ABS_WEIGHT = 10.0  # ref: validation.py magnitude bound
MAX_PAST_SKEW_S = 24 * 3600.0  # ref: 24h past tolerance
MAX_FUTURE_SKEW_S = 5 * 60.0  # ref: 5min future tolerance


class ValidationError(Exception):
    pass


def _weights_finite_and_bounded(weights: Mapping[str, Any],
                                max_abs: float = MAX_ABS_WEIGHT
                                ) -> Optional[str]:
    for name, w in weights.items():
        arr = to_numpy(w)
        if not np.all(np.isfinite(arr)):
            return f"non-finite values in {name}"
        if np.abs(arr).max(initial=0.0) > max_abs:
            return f"weight magnitude exceeds {max_abs} in {name}"
    return None


class ModelUpdateValidator:
    """ref: ModelUpdateValidator, src/shared/validation.py:21-112.

    ``max_abs_weight`` is configurable because DP-noised updates can
    legitimately exceed the reference's fixed bound of 10: Gaussian noise
    with σ ≈ C·√(2·ln(1.25/δ))/ε over ~4·10⁵ elements has an expected max of
    several σ, which at small ε lands above 10 (the reference would reject
    its own DP clients here). DP deployments should widen the bound; see
    ``services.grpc_server.FederatedLearningServicer``.
    """

    def __init__(self, max_abs_weight: float = MAX_ABS_WEIGHT):
        self.max_abs_weight = max_abs_weight

    def validate_model_update(self, update: ModelUpdate) -> bool:
        try:
            if not update.validate():
                logger.warning("Update %s failed basic field validation",
                               update.client_id)
                return False
            # DP-noised updates are unbounded by construction (the client
            # declares its spend via privacy_budget_used): keep the
            # NaN/Inf check, skip the magnitude bound. Non-DP updates keep
            # the reference's bound.
            max_abs = (float("inf") if update.privacy_budget_used > 0
                       else self.max_abs_weight)
            err = _weights_finite_and_bounded(update.model_weights, max_abs)
            if err:
                logger.warning("Update %s rejected: %s", update.client_id, err)
                return False
            if not self._validate_timestamp(update.timestamp):
                logger.warning("Update %s rejected: timestamp out of bounds",
                               update.client_id)
                return False
            return True
        except Exception as e:
            logger.error("Update validation error for %s: %s",
                         getattr(update, "client_id", "?"), e)
            return False

    @staticmethod
    def _validate_timestamp(ts: float) -> bool:
        now = time.time()
        return (now - MAX_PAST_SKEW_S) <= ts <= (now + MAX_FUTURE_SKEW_S)


def dp_widened_validator(privacy: PrivacyConfig) -> ModelUpdateValidator:
    """The coordinator's validator under a DP round config: the |w| bound
    widened to 10 + 8σ, σ = C·√(2·ln(1.25/δ))/ε the Gaussian mechanism's
    noise at the config's (ε, δ, C), so that DP-noised updates pass (ref:
    the servicer's default aggregator,
    ``fl_tpu/services/grpc_server.py:84-104``)."""
    sigma = (privacy.max_grad_norm
             * math.sqrt(2 * math.log(1.25 / privacy.delta))
             / privacy.epsilon)
    return ModelUpdateValidator(max_abs_weight=10.0 + 8.0 * sigma)


class GlobalModelValidator:
    """ref: GlobalModelValidator, src/shared/validation.py:114-161."""

    def validate_global_model(self, model: GlobalModel) -> bool:
        try:
            if model.round_number < 0:
                return False
            if not model.model_weights:
                return False
            if _weights_finite_and_bounded(model.model_weights):
                return False
            if not (0.0 <= model.convergence_score <= 1.0):
                return False
            for k, v in model.accuracy_metrics.items():
                if "accuracy" in k and not (0.0 <= v <= 1.0):
                    return False
            return True
        except Exception:
            return False


class PrivacyConfigValidator:
    """ref: PrivacyConfigValidator, src/shared/validation.py:163-209."""

    def validate_privacy_config(self, config: PrivacyConfig) -> bool:
        try:
            if config.epsilon <= 0 or config.epsilon > 100:
                return False
            if config.delta <= 0 or config.delta >= 1:
                return False
            if config.max_grad_norm <= 0 or config.max_grad_norm > 100:
                return False
            if config.noise_multiplier < 0:
                return False
            return True
        except Exception:
            return False


class ClientCapabilitiesValidator:
    """ref: ClientCapabilitiesValidator, src/shared/validation.py:211-254."""

    def validate_capabilities(self, caps: ClientCapabilities) -> bool:
        try:
            if caps.network_bandwidth <= 0:
                return False
            if caps.available_samples <= 0:
                return False
            if caps.privacy_requirements is not None:
                if not PrivacyConfigValidator().validate_privacy_config(
                    caps.privacy_requirements
                ):
                    return False
            return True
        except Exception:
            return False


def _shape(w) -> tuple:
    """A weight's shape without copying a tensor to the host."""
    return tuple(w.shape) if hasattr(w, "shape") else tuple(np.shape(w))


def validate_model_compatibility(
    weights_a: Mapping[str, Any], weights_b: Mapping[str, Any]
) -> None:
    """Same parameter paths + shapes, or raise
    (ref: validate_model_compatibility, src/shared/validation.py:256-283)."""
    ka, kb = set(weights_a), set(weights_b)
    if ka != kb:
        raise ValidationError(
            f"Weight keys differ: {sorted(ka.symmetric_difference(kb))[:5]}"
        )
    for k in ka:
        sa = _shape(weights_a[k])
        sb = _shape(weights_b[k])
        if sa != sb:
            raise ValidationError(f"Shape mismatch for {k}: {sa} vs {sb}")


def validate_training_round_config(config: Dict[str, Any]) -> List[str]:
    """Returns a list of problems (empty = valid); ref:
    validate_training_round_config, src/shared/validation.py:285-315."""
    problems: List[str] = []
    if config.get("min_clients", 1) < 1:
        problems.append("min_clients must be >= 1")
    if config.get("max_clients", 1) < config.get("min_clients", 1):
        problems.append("max_clients must be >= min_clients")
    if config.get("local_epochs", 1) < 1:
        problems.append("local_epochs must be >= 1")
    if config.get("batch_size", 1) < 1:
        problems.append("batch_size must be >= 1")
    lr = config.get("learning_rate", 1e-3)
    if not (0 < lr <= 1):
        problems.append("learning_rate must be in (0, 1]")
    if config.get("timeout_seconds", 1) <= 0:
        problems.append("timeout_seconds must be positive")
    return problems
