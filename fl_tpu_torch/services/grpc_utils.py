"""Proto <-> dataclass converters and gRPC method plumbing (port of
``fl_tpu.services.grpc_utils``).

Parity target: src/shared/grpc_utils.py (ProtobufConverter :33-244). The
reference's weight path is torch.save→hex-str→utf8-bytes into the proto
bytes field (grpc_utils.py:126-127, decode :171); this package speaks
BOTH:

- when *sending*, the configured codec decides (npz native, torch for
  reference interop) and bytes go into the field raw (no hex inflation);
- when *receiving*, the deserializer auto-detects: raw npz, raw torch, or
  the reference's hex-encoded-torch (decoded transparently), so reference
  clients work unmodified.

Stubs and service handlers are built with grpc's generic API
(`unary_unary` + `method_handlers_generic_handler`) from a single RPC
table, functionally identical to generated *_pb2_grpc code: the nine RPCs
of the round and the five of secure aggregation, the reference package's
table. Weight tensors on any device are copied to the host at the wire.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Optional

from fl_tpu_torch.core.types import (
    ClientCapabilities,
    ComputePowerLevel,
    GlobalModel,
    ModelUpdate,
    PrivacyConfig,
    RoundConfig,
    TrainingMetrics,
    TrainingStatus,
)
from fl_tpu_torch.services import federated_learning_pb2 as pb
from fl_tpu_torch.services.serialization import (
    NATIVE_CODEC,
    ModelWeightSerializer,
)

logger = logging.getLogger(__name__)

SERVICE_NAME = "federated_learning.FederatedLearning"

# RPC name -> (request message class, response message class)
RPC_TABLE = {
    "RegisterClient": (pb.ClientRegistration, pb.RegistrationResponse),
    "UpdateClientCapabilities": (pb.ClientCapabilities, pb.UpdateResponse),
    "GetTrainingStatus": (pb.StatusRequest, pb.TrainingStatus),
    "GetGlobalModel": (pb.ModelRequest, pb.ModelResponse),
    "SubmitModelUpdate": (pb.ModelUpdate, pb.UpdateAck),
    "JoinTrainingRound": (pb.RoundJoinRequest, pb.RoundJoinResponse),
    "GetRoundConfig": (pb.RoundConfigRequest, pb.RoundConfig),
    "HealthCheck": (pb.HealthRequest, pb.HealthResponse),
    "GetMetrics": (pb.MetricsRequest, pb.MetricsResponse),
    # the service extension beyond the reference's 9 RPCs (additive,
    # wire-compatible): Bonawitz secure aggregation, i.e. roster
    # distribution, the encrypted Shamir share ferry, the survivor reveal
    "GetSecAggRoster": (pb.SecAggRosterRequest, pb.SecAggRoster),
    "SubmitSecAggShares": (pb.SecAggShareUpload, pb.UpdateResponse),
    "GetSecAggShares": (pb.SecAggRosterRequest, pb.SecAggShareDownload),
    "GetSecAggReveal": (pb.SecAggRevealRequest, pb.SecAggRevealInfo),
    "SubmitSecAggReveal": (pb.SecAggRevealUpload, pb.UpdateResponse),
}

# channel options matching the reference's tuning
# (grpc_server.py:537-545, grpc_client.py:94-103)
GRPC_OPTIONS = [
    ("grpc.max_send_message_length", 100 * 1024 * 1024),
    ("grpc.max_receive_message_length", 100 * 1024 * 1024),
    ("grpc.keepalive_time_ms", 30_000),
    ("grpc.keepalive_timeout_ms", 5_000),
    ("grpc.keepalive_permit_without_calls", True),
    ("grpc.http2.max_pings_without_data", 0),
]

_POWER_TO_PB = {
    ComputePowerLevel.LOW: pb.COMPUTE_POWER_LOW,
    ComputePowerLevel.MEDIUM: pb.COMPUTE_POWER_MEDIUM,
    ComputePowerLevel.HIGH: pb.COMPUTE_POWER_HIGH,
}
_PB_TO_POWER = {v: k for k, v in _POWER_TO_PB.items()}


def _looks_hex(data: bytes) -> bool:
    """Reference payloads are utf-8 hex strings inside the bytes field
    (grpc_utils.py:126-127)."""
    if not data or len(data) % 2:
        return False
    sample = data[:64]
    return all(c in b"0123456789abcdefABCDEF" for c in sample)


class ProtobufConverter:
    """Dataclass <-> proto mapping (ref: ProtobufConverter,
    grpc_utils.py:33-244)."""

    def __init__(self, codec: str = NATIVE_CODEC, hex_wire: bool = False):
        self.serializer = ModelWeightSerializer(codec)
        # hex_wire=True reproduces the reference's hex-in-bytes quirk for
        # byte-identical traffic against reference peers
        self.hex_wire = hex_wire

    # -- weights field -------------------------------------------------------
    def weights_to_bytes(self, weights) -> bytes:
        if self.hex_wire:
            return self.serializer.serialize_weights_hex(weights).encode()
        return self.serializer.serialize_weights(weights)

    def weights_from_bytes(self, data: bytes):
        if _looks_hex(data):
            return self.serializer.deserialize_weights_hex(data.decode())
        return self.serializer.deserialize_weights(data)

    # -- privacy config (ref :41-68) ------------------------------------------
    @staticmethod
    def privacy_config_to_proto(cfg: Optional[PrivacyConfig]) -> pb.PrivacyConfig:
        if cfg is None:
            return pb.PrivacyConfig()
        return pb.PrivacyConfig(
            epsilon=cfg.epsilon, delta=cfg.delta,
            max_grad_norm=cfg.max_grad_norm,
            noise_multiplier=cfg.noise_multiplier,
        )

    @staticmethod
    def privacy_config_from_proto(p: pb.PrivacyConfig) -> Optional[PrivacyConfig]:
        if p.epsilon <= 0:
            return None
        return PrivacyConfig(
            epsilon=p.epsilon, delta=p.delta,
            max_grad_norm=p.max_grad_norm or 1.0,
            noise_multiplier=p.noise_multiplier,
        )

    # -- capabilities (ref :70-118) ----------------------------------------------
    def client_capabilities_to_proto(self, caps: ClientCapabilities
                                     ) -> pb.ClientCapabilities:
        return pb.ClientCapabilities(
            compute_power=_POWER_TO_PB.get(caps.compute_power,
                                           pb.COMPUTE_POWER_MEDIUM),
            network_bandwidth_mbps=caps.network_bandwidth,
            available_samples=caps.available_samples,
            supported_models=list(caps.supported_models),
            privacy_requirements=self.privacy_config_to_proto(
                caps.privacy_requirements
            ),
        )

    def client_capabilities_from_proto(self, p: pb.ClientCapabilities
                                       ) -> ClientCapabilities:
        return ClientCapabilities(
            compute_power=_PB_TO_POWER.get(p.compute_power,
                                           ComputePowerLevel.MEDIUM),
            network_bandwidth=p.network_bandwidth_mbps,
            available_samples=p.available_samples,
            supported_models=list(p.supported_models),
            privacy_requirements=self.privacy_config_from_proto(
                p.privacy_requirements
            ),
        )

    # -- model update (ref :120-189) ------------------------------------------------
    def model_update_to_proto(self, update: ModelUpdate) -> pb.ModelUpdate:
        msg = pb.ModelUpdate(
            client_id=update.client_id,
            round_number=update.round_number,
            model_weights=self.weights_to_bytes(update.model_weights),
            num_samples=update.num_samples,
            training_loss=update.training_loss,
            privacy_budget_used=update.privacy_budget_used,
            compression_ratio=update.compression_ratio,
            timestamp=int(update.timestamp),
        )
        if update.training_metrics is not None:
            tm = update.training_metrics
            msg.training_metrics.CopyFrom(pb.TrainingMetrics(
                loss=tm.loss, accuracy=tm.accuracy,
                epochs_completed=tm.epochs_completed,
                training_time_seconds=tm.training_time,
                samples_processed=tm.samples_processed,
                additional_metrics={k: float(v) for k, v
                                    in tm.additional_metrics.items()},
            ))
        return msg

    def model_update_from_proto(self, p: pb.ModelUpdate) -> ModelUpdate:
        metrics = None
        if p.HasField("training_metrics"):
            tm = p.training_metrics
            metrics = TrainingMetrics(
                loss=tm.loss, accuracy=tm.accuracy,
                epochs_completed=tm.epochs_completed,
                training_time=tm.training_time_seconds,
                samples_processed=tm.samples_processed,
                additional_metrics=dict(tm.additional_metrics),
            )
        return ModelUpdate(
            client_id=p.client_id,
            round_number=p.round_number,
            model_weights=self.weights_from_bytes(p.model_weights),
            num_samples=p.num_samples,
            training_loss=p.training_loss,
            privacy_budget_used=p.privacy_budget_used,
            compression_ratio=p.compression_ratio,
            timestamp=float(p.timestamp) or time.time(),
            training_metrics=metrics,
        )

    # -- global model (ref :191-245) --------------------------------------------------
    def global_model_to_proto(self, model: GlobalModel,
                              message: str = "OK") -> pb.ModelResponse:
        data = self.weights_to_bytes(model.model_weights)
        resp = pb.ModelResponse(
            success=True, message=message, model_weights=data,
            round_number=model.round_number,
        )
        resp.metadata.model_size_bytes = len(data)
        for k, v in model.accuracy_metrics.items():
            resp.metadata.accuracy_metrics[k] = float(v)
        return resp

    def global_model_from_proto(self, p: pb.ModelResponse) -> GlobalModel:
        return GlobalModel(
            round_number=p.round_number,
            model_weights=self.weights_from_bytes(p.model_weights),
            accuracy_metrics=dict(p.metadata.accuracy_metrics),
        )

    # -- round config ------------------------------------------------------------------
    def round_config_to_proto(self, cfg: RoundConfig) -> pb.RoundConfig:
        msg = pb.RoundConfig(
            round_number=cfg.round_number,
            min_clients=cfg.min_clients,
            max_clients=cfg.max_clients,
            local_epochs=cfg.local_epochs,
            batch_size=cfg.batch_size,
            learning_rate=cfg.learning_rate,
            timeout_seconds=cfg.timeout_seconds,
            optimizer_type=cfg.optimizer_type,
        )
        if cfg.privacy_config is not None:
            msg.privacy_config.CopyFrom(
                self.privacy_config_to_proto(cfg.privacy_config)
            )
        for k, v in cfg.additional_params.items():
            msg.additional_params[k] = v
        return msg

    def round_config_from_proto(self, p: pb.RoundConfig) -> RoundConfig:
        return RoundConfig(
            round_number=p.round_number,
            min_clients=p.min_clients or 2,
            max_clients=p.max_clients or 50,
            local_epochs=p.local_epochs or 5,
            batch_size=p.batch_size or 32,
            learning_rate=p.learning_rate or 1e-3,
            timeout_seconds=p.timeout_seconds or 300,
            optimizer_type=p.optimizer_type or "adam",
            privacy_config=self.privacy_config_from_proto(p.privacy_config),
            additional_params=dict(p.additional_params),
        )

    # -- training status ---------------------------------------------------------------
    @staticmethod
    def training_status_to_proto(s: TrainingStatus,
                                 round_status: int = pb.ROUND_STATUS_WAITING
                                 ) -> pb.TrainingStatus:
        return pb.TrainingStatus(
            current_round=s.current_round,
            active_clients=s.active_clients,
            round_progress=s.round_progress,
            global_accuracy=s.global_accuracy,
            convergence_score=s.convergence_score,
            estimated_completion=int(s.estimated_completion or 0),
            round_status=round_status,
        )

    @staticmethod
    def training_status_from_proto(p: pb.TrainingStatus) -> TrainingStatus:
        return TrainingStatus(
            current_round=p.current_round,
            active_clients=p.active_clients,
            round_progress=p.round_progress,
            global_accuracy=p.global_accuracy,
            convergence_score=p.convergence_score,
            estimated_completion=float(p.estimated_completion) or None,
        )


# ---------------------------------------------------------------------------
# generic-API stubs/handlers (replaces generated *_pb2_grpc)
# ---------------------------------------------------------------------------

def make_stub(channel) -> Dict[str, Any]:
    """Build {rpc_name: callable} from a grpc channel."""
    stubs = {}
    for name, (req_cls, resp_cls) in RPC_TABLE.items():
        stubs[name] = channel.unary_unary(
            f"/{SERVICE_NAME}/{name}",
            request_serializer=req_cls.SerializeToString,
            response_deserializer=resp_cls.FromString,
        )
    return stubs


def make_service_handler(servicer) -> Any:
    """Build a generic gRPC handler from any object exposing the RPC
    methods of :data:`RPC_TABLE` (request, context) -> response."""
    import grpc

    handlers = {}
    for name, (req_cls, resp_cls) in RPC_TABLE.items():
        method = getattr(servicer, name)
        handlers[name] = grpc.unary_unary_rpc_method_handler(
            method,
            request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString,
        )
    return grpc.method_handlers_generic_handler(SERVICE_NAME, handlers)
