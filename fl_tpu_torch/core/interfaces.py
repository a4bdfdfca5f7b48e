"""Service contracts as ``typing.Protocol``s (port of
``fl_tpu.core.interfaces``).

The seven contracts of the reference's ABCs (Coordinator-, Client- and
AggregationService, Model, DataLoader, PrivacyEngine, Compression). They
are structural: an implementation conforms by shape, with no base class,
and ``runtime_checkable`` lets tests assert conformance with
``isinstance``. The types are the port's (``fl_tpu_torch.core.types``);
a weight or a gradient may be a tensor on any device or a numpy array.
"""

from __future__ import annotations

from typing import (
    Any,
    Dict,
    List,
    Optional,
    Protocol,
    Tuple,
    runtime_checkable,
)

from fl_tpu_torch.core.types import (
    ClientCapabilities,
    GlobalModel,
    ModelUpdate,
    RoundConfig,
    TrainingStatus,
)


@runtime_checkable
class CoordinatorServiceProtocol(Protocol):
    """ref: CoordinatorServiceInterface, interfaces.py:17-44."""

    def register_client(self, client_id: str,
                        info: Optional[Dict[str, Any]] = None) -> None: ...

    def submit_update(self, update: ModelUpdate) -> bool: ...

    def get_training_status(self) -> Dict[str, Any]: ...


@runtime_checkable
class ClientServiceProtocol(Protocol):
    """ref: ClientServiceInterface, interfaces.py:46-73."""

    def initialize(self) -> None: ...

    def start_training(self) -> None: ...

    def stop_training(self) -> None: ...

    def get_status(self) -> Dict[str, Any]: ...


@runtime_checkable
class AggregationServiceProtocol(Protocol):
    """ref: AggregationServiceInterface, interfaces.py:75-97."""

    def aggregate_updates(self, updates: List[ModelUpdate],
                          weights: Optional[List[float]] = None
                          ) -> GlobalModel: ...

    def validate_update(self, update: ModelUpdate) -> bool: ...

    def calculate_convergence_metrics(
        self, old_model: Optional[GlobalModel],
        new_model: Optional[GlobalModel]) -> float: ...


@runtime_checkable
class ModelProtocol(Protocol):
    """ref: ModelInterface, interfaces.py:99-121."""

    def get_model_weights(self, variables: Any) -> Dict[str, Any]: ...

    def set_model_weights(self, variables: Any,
                          weights: Dict[str, Any]) -> Any: ...

    def get_parameter_count(self, variables: Any) -> int: ...


@runtime_checkable
class DataLoaderProtocol(Protocol):
    """ref: DataLoaderInterface, interfaces.py:123-140."""

    def get_client_dataset(self, client_id: int) -> Any: ...

    def get_test_set(self) -> Tuple[Any, Any]: ...


@runtime_checkable
class PrivacyEngineProtocol(Protocol):
    """ref: PrivacyEngineInterface, interfaces.py:142-164."""

    def add_noise(self, gradients: Any, epsilon: float,
                  delta: float) -> Any: ...

    def clip_gradients(self, gradients: Any, max_norm: float) -> Any: ...

    def validate_privacy_parameters(self, epsilon: float,
                                    delta: float) -> bool: ...


@runtime_checkable
class CompressionProtocol(Protocol):
    """ref: CompressionInterface, interfaces.py:166-182."""

    def compress_weights(self, weights: Any
                         ) -> Tuple[bytes, Dict[str, Any]]: ...

    def decompress_weights(self, payload: bytes,
                           metadata: Dict[str, Any]) -> Any: ...


__all__ = [
    "CoordinatorServiceProtocol",
    "ClientServiceProtocol",
    "AggregationServiceProtocol",
    "ModelProtocol",
    "DataLoaderProtocol",
    "PrivacyEngineProtocol",
    "CompressionProtocol",
    "ClientCapabilities",
    "RoundConfig",
    "TrainingStatus",
]
