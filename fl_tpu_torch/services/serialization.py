"""Weight and payload serialization for the wire (port of
``fl_tpu.services.serialization``).

Parity target: src/shared/serialization.py. The reference's payload path is
``torch.save → bytes → .hex() string → UTF-8 bytes`` (serialization.py:27-79
+ grpc_utils.py:126-127) — a pickle-based format with a 2× hex inflation.
This module provides:

- the **native codec**: numpy ``.npz`` (safe, zero-copy-ish), the default
  between this package's peers;
- the **interop codec**: torch.save/torch.load including the hex-string
  quirk, byte-compatible with reference clients/coordinators (torch is
  always there in the port). Loading uses ``weights_only=True`` so untrusted reference payloads cannot execute
  pickle gadgets — strictly safer than the reference's plain torch.load
  (serialization.py:51-79) while accepting the same bytes.

Plus dict-level (de)serializers for ModelUpdate / GlobalModel matching the
reference's JSON envelope layout (serialization.py:82-225).
"""

from __future__ import annotations

import io
import json
import logging
import time
from typing import Any, Dict, Mapping

import numpy as np
import torch

from fl_tpu_torch.core.types import to_numpy

logger = logging.getLogger(__name__)

ModelWeightsNP = Dict[str, np.ndarray]

NATIVE_CODEC = "npz"
INTEROP_CODEC = "torch"


class SerializationError(Exception):
    pass


class ModelWeightSerializer:
    """weights dict <-> bytes (ref: ModelWeightSerializer,
    serialization.py:24-79)."""

    def __init__(self, codec: str = NATIVE_CODEC):
        if codec not in (NATIVE_CODEC, INTEROP_CODEC):
            raise SerializationError(f"Unknown codec: {codec}")
        self.codec = codec

    # -- bytes ---------------------------------------------------------------
    def serialize_weights(self, weights: Mapping[str, Any]) -> bytes:
        np_weights = {k: to_numpy(v) for k, v in weights.items()}
        if self.codec == NATIVE_CODEC:
            buf = io.BytesIO()
            np.savez(buf, **np_weights)
            return buf.getvalue()
        return self._torch_save(np_weights)

    def deserialize_weights(self, data: bytes) -> ModelWeightsNP:
        """Auto-detects the codec: npz archives are ZIP files whose entries
        are all ``.npy``; torch zipfile-v2 payloads contain ``data.pkl``;
        anything else is treated as a legacy torch pickle."""
        if data[:4] == b"PK\x03\x04":
            import zipfile

            with zipfile.ZipFile(io.BytesIO(data)) as zf:
                names = zf.namelist()
            if names and all(n.endswith(".npy") for n in names):
                with np.load(io.BytesIO(data), allow_pickle=False) as z:
                    return {k: z[k] for k in z.files}
        if data[:1] == b"\x80" and b"compressed_data" in data[:4096]:
            # the reference's COMPRESSED wire package: a raw pickle of
            # {'compressed_data': ..., 'metadata': {...}} (reference
            # src/shared/compression.py:396-414). Executing arbitrary
            # pickle from the wire is a code-execution risk, so this
            # package rejects the format BY DESIGN — detected here by the embedded
            # dict-key byte markers, without unpickling anything.
            raise SerializationError(
                "compressed pickle package format is not supported (it "
                "requires executing untrusted pickle); disable client-side "
                "compression (compression_enabled: false) and resend the "
                "weights uncompressed as torch state_dict or npz")
        return self._torch_load(data)

    # -- hex transport form (the reference's wire quirk,
    #    serialization.py:105 + grpc_utils.py:126-127,171) -------------------
    def serialize_weights_hex(self, weights: Mapping[str, Any]) -> str:
        return self.serialize_weights(weights).hex()

    def deserialize_weights_hex(self, hex_str: str) -> ModelWeightsNP:
        return self.deserialize_weights(bytes.fromhex(hex_str))

    # -- torch interop ---------------------------------------------------------
    @staticmethod
    def _torch_save(np_weights: ModelWeightsNP) -> bytes:
        buf = io.BytesIO()
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in np_weights.items()}, buf)
        return buf.getvalue()

    @staticmethod
    def _torch_load(data: bytes) -> ModelWeightsNP:
        obj = torch.load(io.BytesIO(data), map_location="cpu",
                         weights_only=True)
        if not isinstance(obj, dict):
            raise SerializationError("torch payload is not a weights dict")
        return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
                for k, v in obj.items()}


class ModelUpdateSerializer:
    """ModelUpdate <-> JSON-able dict with hex weights
    (ref: ModelUpdateSerializer, serialization.py:82-155)."""

    def __init__(self, codec: str = NATIVE_CODEC):
        self.weights = ModelWeightSerializer(codec)

    def serialize_model_update(self, update) -> Dict[str, Any]:
        return {
            "client_id": update.client_id,
            "round_number": update.round_number,
            "model_weights": self.weights.serialize_weights_hex(
                update.model_weights
            ),
            "num_samples": update.num_samples,
            "training_loss": update.training_loss,
            "privacy_budget_used": update.privacy_budget_used,
            "compression_ratio": update.compression_ratio,
            "timestamp": update.timestamp,
        }

    def deserialize_model_update(self, data: Dict[str, Any]):
        from fl_tpu_torch.core.types import ModelUpdate

        return ModelUpdate(
            client_id=data["client_id"],
            round_number=int(data["round_number"]),
            model_weights=self.weights.deserialize_weights_hex(
                data["model_weights"]
            ),
            num_samples=int(data["num_samples"]),
            training_loss=float(data["training_loss"]),
            privacy_budget_used=float(data.get("privacy_budget_used", 0.0)),
            compression_ratio=float(data.get("compression_ratio", 1.0)),
            timestamp=float(data.get("timestamp", time.time())),
        )


class GlobalModelSerializer:
    """GlobalModel <-> JSON-able dict (ref: GlobalModelSerializer,
    serialization.py:156-225)."""

    def __init__(self, codec: str = NATIVE_CODEC):
        self.weights = ModelWeightSerializer(codec)

    def serialize_global_model(self, model) -> Dict[str, Any]:
        return {
            "round_number": model.round_number,
            "model_weights": self.weights.serialize_weights_hex(
                model.model_weights
            ),
            "accuracy_metrics": dict(model.accuracy_metrics),
            "participating_clients": list(model.participating_clients),
            "convergence_score": model.convergence_score,
            "created_at": model.created_at,
        }

    def deserialize_global_model(self, data: Dict[str, Any]):
        from fl_tpu_torch.core.types import GlobalModel

        return GlobalModel(
            round_number=int(data["round_number"]),
            model_weights=self.weights.deserialize_weights_hex(
                data["model_weights"]
            ),
            accuracy_metrics={k: float(v)
                              for k, v in data.get("accuracy_metrics", {}).items()},
            participating_clients=list(data.get("participating_clients", [])),
            convergence_score=float(data.get("convergence_score", 0.0)),
            created_at=float(data.get("created_at", time.time())),
        )


class CompactSerializer:
    """Raw-bytes envelope codec for whole messages
    (ref: CompactSerializer, serialization.py:226-281 — which uses raw
    pickle; here: JSON header + npz body, safe against untrusted input)."""

    @staticmethod
    def serialize(obj: Dict[str, Any]) -> bytes:
        header = json.dumps(obj, default=str).encode()
        return len(header).to_bytes(4, "big") + header

    @staticmethod
    def deserialize(data: bytes) -> Dict[str, Any]:
        n = int.from_bytes(data[:4], "big")
        return json.loads(data[4: 4 + n].decode())


def validate_serialization_roundtrip(
    weights: Mapping[str, Any], codec: str = NATIVE_CODEC
) -> bool:
    """Exact-roundtrip check (ref: validate_serialization_roundtrip,
    serialization.py:282-310)."""
    try:
        ser = ModelWeightSerializer(codec)
        restored = ser.deserialize_weights(ser.serialize_weights(weights))
        if set(restored) != set(weights):
            return False
        return all(
            np.array_equal(to_numpy(weights[k]), restored[k])
            for k in weights
        )
    except Exception as e:
        logger.error("serialization roundtrip failed: %s", e)
        return False
