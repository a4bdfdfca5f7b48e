"""Client-side gRPC connector (port of ``fl_tpu.services.grpc_client``).

Parity target: src/client/grpc_client.py — FederatedLearningClient (:32-512:
connection management with keepalive + 100MB message caps, RPC wrappers,
retry with exponential backoff + jitter on UNAVAILABLE/DEADLINE_EXCEEDED)
and ClientConnectionManager (:514-634: heartbeat loop + auto-reconnect).

``grpc`` and the protobuf messages are imported where they are first
needed (``connect``, the RPC wrappers, the converter), as the reference
imports ``grpc``: the module imports, and a client is constructed, on a
machine without ``grpcio`` or ``protobuf``.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Any, Callable, Dict, Optional

from fl_tpu_torch.core.types import (
    ClientCapabilities,
    GlobalModel,
    ModelUpdate,
    RoundConfig,
    TrainingStatus,
)

logger = logging.getLogger(__name__)


def _pb():
    """The protobuf messages (imported at first use)."""
    from fl_tpu_torch.services import federated_learning_pb2

    return federated_learning_pb2


class GRPCClientError(Exception):
    pass


class FederatedLearningClient:
    """ref: FederatedLearningClient, grpc_client.py:32-512."""

    def __init__(
        self,
        host: str = "localhost",
        port: int = 50051,
        client_id: str = "client",
        max_retries: int = 3,
        base_backoff_s: float = 0.5,
        timeout_s: float = 30.0,
        converter=None,
        tls_root_cert_path: Optional[str] = None,
        tls_cert_path: Optional[str] = None,
        tls_key_path: Optional[str] = None,
    ):
        """``tls_root_cert_path`` switches to a TLS channel (the reference
        uses insecure channels only — grpc_client.py:94); adding
        ``tls_cert_path``/``tls_key_path`` presents a client certificate
        (mTLS against a coordinator that requires client auth)."""
        self.host = host
        self.port = port
        self.client_id = client_id
        self.max_retries = max_retries
        self.base_backoff_s = base_backoff_s
        self.timeout_s = timeout_s
        self._converter = converter
        if (tls_cert_path or tls_key_path) and not tls_root_cert_path:
            raise ValueError(
                "partial TLS config: a client certificate needs "
                "tls_root_cert_path too — refusing to silently connect "
                "insecurely")
        if bool(tls_cert_path) != bool(tls_key_path):
            raise ValueError("tls_cert_path and tls_key_path must both be "
                             "set (or both unset)")
        self.tls_root_cert_path = tls_root_cert_path
        self.tls_cert_path = tls_cert_path
        self.tls_key_path = tls_key_path
        self._channel = None
        self._stubs: Dict[str, Any] = {}

    @property
    def converter(self):
        """The :class:`~fl_tpu_torch.services.grpc_utils.ProtobufConverter`
        (built at first use)."""
        if self._converter is None:
            from fl_tpu_torch.services.grpc_utils import ProtobufConverter

            self._converter = ProtobufConverter()
        return self._converter

    # -- connection (ref :79-133) ------------------------------------------
    def connect(self) -> None:
        import grpc

        from fl_tpu_torch.services.grpc_utils import GRPC_OPTIONS, make_stub

        address = f"{self.host}:{self.port}"
        if self.tls_root_cert_path:
            with open(self.tls_root_cert_path, "rb") as f:
                root = f.read()
            key = cert = None
            if self.tls_cert_path and self.tls_key_path:
                with open(self.tls_key_path, "rb") as f:
                    key = f.read()
                with open(self.tls_cert_path, "rb") as f:
                    cert = f.read()
            creds = grpc.ssl_channel_credentials(
                root_certificates=root, private_key=key,
                certificate_chain=cert,
            )
            self._channel = grpc.secure_channel(address, creds,
                                                options=GRPC_OPTIONS)
        else:
            self._channel = grpc.insecure_channel(address,
                                                  options=GRPC_OPTIONS)
        self._stubs = make_stub(self._channel)

    def close(self) -> None:
        if self._channel is not None:
            self._channel.close()
            self._channel = None
            self._stubs = {}

    @property
    def connected(self) -> bool:
        return bool(self._stubs)

    def __enter__(self):
        self.connect()
        return self

    def __exit__(self, *exc):
        self.close()

    # -- retry wrapper (ref: _call_with_retry, grpc_client.py:447-491) ------
    def _call(self, rpc_name: str, request) -> Any:
        import grpc

        if not self._stubs:
            raise GRPCClientError("not connected")
        last_err: Optional[Exception] = None
        for attempt in range(self.max_retries + 1):
            try:
                return self._stubs[rpc_name](request, timeout=self.timeout_s)
            except grpc.RpcError as e:
                code = e.code()
                if code not in (grpc.StatusCode.UNAVAILABLE,
                                grpc.StatusCode.DEADLINE_EXCEEDED):
                    raise GRPCClientError(
                        f"{rpc_name} failed: {code.name}: {e.details()}"
                    ) from e
                last_err = e
                if attempt < self.max_retries:
                    backoff = self.base_backoff_s * (2 ** attempt)
                    backoff *= 1.0 + random.random() * 0.25  # jitter
                    logger.warning("%s %s; retry %d/%d in %.2fs",
                                   rpc_name, code.name, attempt + 1,
                                   self.max_retries, backoff)
                    time.sleep(backoff)
        raise GRPCClientError(
            f"{rpc_name} failed after {self.max_retries} retries"
        ) from last_err

    # -- RPC wrappers ---------------------------------------------------------
    def register(self, capabilities: ClientCapabilities,
                 client_version: str = "fl-tpu/0.1.0",
                 metadata: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        """ref: grpc_client.py:135-178. ``metadata`` rides the proto's
        registration map (e.g. the secure-aggregation public key)."""
        pb = _pb()
        req = pb.ClientRegistration(
            client_id=self.client_id,
            client_version=client_version,
        )
        if metadata:
            for k, v in metadata.items():
                req.metadata[k] = v
        req.capabilities.CopyFrom(
            self.converter.client_capabilities_to_proto(capabilities)
        )
        resp = self._call("RegisterClient", req)
        if not resp.success:
            raise GRPCClientError(f"registration rejected: {resp.message}")
        self.client_id = resp.assigned_client_id or self.client_id
        return {
            "client_id": self.client_id,
            "global_model_version": resp.global_model_version,
            "supported_models": list(resp.server_info.supported_models),
            "server_version": resp.server_info.server_version,
        }

    def get_secagg_roster(self, round_number: int):
        """Fetch the round's frozen secure-aggregation roster snapshot.

        Returns (ready, info) where info is a dict with ``peers``
        ([(client_id, public_key_bytes)] sorted), ``nonce`` (the freeze
        nonce every mask seed must fold in), ``threshold`` (Shamir t) and
        ``frac_bits`` (fixed-point precision).
        """
        pb = _pb()
        resp = self._call("GetSecAggRoster", pb.SecAggRosterRequest(
            client_id=self.client_id, round_number=round_number,
        ))
        info = {
            "peers": [(p.client_id, bytes(p.public_key))
                      for p in resp.peers],
            "nonce": bytes(resp.roster_nonce),
            "threshold": int(resp.threshold),
            "frac_bits": int(resp.frac_bits),
            "round_number": int(resp.round_number),
        }
        return bool(resp.ready), info

    def submit_secagg_shares(self, round_number: int, roster_nonce: bytes,
                             bundles) -> bool:
        """Phase 1: upload encrypted Shamir share bundles
        ([(to_client_id, ciphertext)])."""
        pb = _pb()
        req = pb.SecAggShareUpload(client_id=self.client_id,
                                   round_number=round_number,
                                   roster_nonce=roster_nonce)
        for to_cid, blob in bundles:
            req.shares.add(from_client_id=self.client_id,
                           to_client_id=to_cid, ciphertext=blob)
        resp = self._call("SubmitSecAggShares", req)
        if not resp.success:
            raise GRPCClientError(f"share upload rejected: {resp.message}")
        return True

    def get_secagg_shares(self, round_number: int):
        """Phase 1 pickup: (ready, [(from_client_id, ciphertext)])."""
        pb = _pb()
        resp = self._call("GetSecAggShares", pb.SecAggRosterRequest(
            client_id=self.client_id, round_number=round_number,
        ))
        return (bool(resp.ready),
                [(s.from_client_id, bytes(s.ciphertext))
                 for s in resp.shares])

    def get_secagg_reveal(self, round_number: int):
        """Phase 3 poll: (ready, survivors, dropped, roster_nonce)."""
        pb = _pb()
        resp = self._call("GetSecAggReveal", pb.SecAggRevealRequest(
            client_id=self.client_id, round_number=round_number,
        ))
        return (bool(resp.ready), list(resp.survivors),
                list(resp.dropped), bytes(resp.roster_nonce))

    def submit_secagg_reveal(self, round_number: int, roster_nonce: bytes,
                             items) -> bool:
        """Phase 3: reveal reconstruction shares
        ([(subject_id, is_key_share, share_bytes)]). Returns False (no
        raise) when the server already advanced past the round — a
        straggler reveal after aggregation fired is not an error."""
        pb = _pb()
        req = pb.SecAggRevealUpload(client_id=self.client_id,
                                    round_number=round_number,
                                    roster_nonce=roster_nonce)
        for subject, is_key, blob in items:
            req.shares.add(subject_client_id=subject,
                           is_key_share=is_key, share=blob)
        resp = self._call("SubmitSecAggReveal", req)
        return bool(resp.success)

    def get_global_model(self, round_number: int = -1,
                         model_type: str = "") -> GlobalModel:
        """ref: grpc_client.py:180-227."""
        pb = _pb()
        resp = self._call("GetGlobalModel", pb.ModelRequest(
            client_id=self.client_id, round_number=round_number,
            model_type=model_type,
        ))
        if not resp.success:
            raise GRPCClientError(f"GetGlobalModel failed: {resp.message}")
        return self.converter.global_model_from_proto(resp)

    def submit_model_update(self, update: ModelUpdate) -> Dict[str, Any]:
        """ref: grpc_client.py:229-268."""
        resp = self._call("SubmitModelUpdate",
                          self.converter.model_update_to_proto(update))
        return {"success": resp.success, "message": resp.message,
                "round_status": resp.round_status}

    def join_training_round(self, requested_round: int = -1) -> RoundConfig:
        """ref: grpc_client.py:270-329."""
        pb = _pb()
        resp = self._call("JoinTrainingRound", pb.RoundJoinRequest(
            client_id=self.client_id, requested_round=requested_round,
        ))
        if not resp.success:
            raise GRPCClientError(f"JoinTrainingRound failed: {resp.message}")
        cfg = self.converter.round_config_from_proto(resp.round_config)
        return cfg

    def get_round_config(self, round_number: int = -1) -> RoundConfig:
        pb = _pb()
        resp = self._call("GetRoundConfig", pb.RoundConfigRequest(
            client_id=self.client_id, round_number=round_number,
        ))
        return self.converter.round_config_from_proto(resp)

    def get_training_status(self) -> TrainingStatus:
        """ref: grpc_client.py:331-370."""
        pb = _pb()
        resp = self._call("GetTrainingStatus",
                          pb.StatusRequest(client_id=self.client_id))
        return self.converter.training_status_from_proto(resp)

    def health_check(self) -> bool:
        """ref: grpc_client.py:372-395."""
        try:
            pb = _pb()
            resp = self._call("HealthCheck",
                              pb.HealthRequest(service_name="coordinator"))
            return resp.healthy
        except Exception:
            return False


class ClientConnectionManager:
    """Heartbeat + auto-reconnect supervisor
    (ref: ClientConnectionManager, grpc_client.py:514-634)."""

    def __init__(self, client: FederatedLearningClient,
                 heartbeat_interval_s: float = 30.0,
                 on_status: Optional[Callable[[TrainingStatus], None]] = None):
        self.client = client
        self.heartbeat_interval_s = heartbeat_interval_s
        self.on_status = on_status
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.healthy = False

    def start(self) -> None:
        self.client.connect()
        self.healthy = self.client.health_check()
        self._stop.clear()
        self._thread = threading.Thread(target=self._heartbeat_loop,
                                        daemon=True, name="fl-heartbeat")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        self.client.close()

    def _heartbeat_loop(self) -> None:
        """Status poll as heartbeat; reconnect with backoff on failure
        (ref :551-618)."""
        failures = 0
        while not self._stop.wait(self.heartbeat_interval_s):
            try:
                status = self.client.get_training_status()
                self.healthy = True
                failures = 0
                if self.on_status is not None:
                    self.on_status(status)
            except Exception as e:
                failures += 1
                self.healthy = False
                logger.warning("heartbeat failed (%d): %s", failures, e)
                try:
                    self.client.close()
                    time.sleep(min(30.0, 2.0 ** failures))
                    self.client.connect()
                except Exception as re:
                    logger.error("reconnect failed: %s", re)
