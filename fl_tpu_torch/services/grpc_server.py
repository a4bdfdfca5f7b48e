"""Coordinator gRPC service (port of ``fl_tpu.services.grpc_server``).

Parity target: src/coordinator/grpc_server.py (FederatedLearningServicer
:35-506 + CoordinatorGRPCServer :509-581). Implements the 9 RPCs of the
round in federated_learning.proto: client registry, per-round pending-update
collection, threshold-triggered FedAvg aggregation, lazy initial global
model, round advancement, health + metrics, wire adaptive clipping, and
the service extension: Bonawitz secure aggregation over the wire
(``services.secagg_wire``; roster, share ferry, survivor reveal) with
distributed DP over it, and restart resume from
``services.persistence.CoordinatorPersistence``.

As in the reference:
- aggregation runs on a single-worker executor (the submitter is not
  blocked);
- the arithmetic is ``fl.fedavg.FedAvgAggregator`` on the servicer's
  device (the card unless ``device="cpu"``), so a GPU host serving remote
  clients aggregates on the card;
- weights auto-detect the wire codec (npz | torch | hex-torch), so
  unmodified reference clients interoperate;
- a secure round's aggregate is unmasked on the host (numpy on the ring
  mod 2^32) and then moves to the aggregator's device, where the plain
  round's average lives.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time
from concurrent import futures
from typing import Dict, Optional

import numpy as np

from fl_tpu_torch.core.mesh import resolve_device
from fl_tpu_torch.core.types import (
    GlobalModel,
    RoundConfig,
    TrainingStatus,
    to_numpy,
)
from fl_tpu_torch.fl.convergence import ConvergenceDetector, RoundObservation
from fl_tpu_torch.fl.distributed_dp import (
    DistributedDPPlan,
    check_no_wraparound,
    distributed_epsilon,
    host_decode_average,
)
from fl_tpu_torch.fl.fedavg import (
    FedAvgAggregator,
    FedAvgError,
    weight_tensor,
)
from fl_tpu_torch.fl.privacy import adaptive_clip_delta_multiplier
from fl_tpu_torch.services import federated_learning_pb2 as pb
from fl_tpu_torch.services.grpc_utils import (
    GRPC_OPTIONS,
    ProtobufConverter,
    make_service_handler,
)
from fl_tpu_torch.services.secagg_wire import (
    PUBKEY_METADATA_KEY as SECAGG_PUBKEY_KEY,
)
from fl_tpu_torch.services.secagg_wire import SecAggServerRound
from fl_tpu_torch.utils.validation import dp_widened_validator

logger = logging.getLogger(__name__)

SERVER_VERSION = "fl-tpu/0.1.0"


class FederatedLearningServicer:
    """The 9-RPC coordinator servicer
    (ref: FederatedLearningServicer, grpc_server.py:35-506)."""

    def __init__(
        self,
        round_config: Optional[RoundConfig] = None,
        model_name: str = "simple_cnn",
        converter: Optional[ProtobufConverter] = None,
        aggregator: Optional[FedAvgAggregator] = None,
        persistence=None,
        secure_aggregation: bool = False,
        secagg_threshold: Optional[int] = None,
        secagg_grace_s: float = 60.0,
        distributed_dp: bool = False,
        ddp_bits: int = 14,
        adaptive_clipping: bool = False,
        clip_target_quantile: float = 0.5,
        clip_learning_rate: float = 0.2,
        clip_count_stddev: float = 0.5,
        device=None,
    ):
        """``device``: where the default aggregator reduces and the lazy
        initial model is drawn; None is the card.

        ``secure_aggregation=True`` switches the round protocol to Bonawitz
        CCS'17 double-masked uploads (``services.secagg_wire``): a roster
        of registered public keys is frozen per round with a fresh nonce,
        clients exchange encrypted Shamir shares through the coordinator,
        payloads arrive masked mod 2^32 (content validation is skipped:
        that is the point), and after the survivor set freezes the
        coordinator reconstructs exactly the aggregate. A client that dies
        AFTER the share phase no longer voids the round: with >=
        ``secagg_threshold`` survivors (default ceil(2n/3)) the round
        completes on the survivors' data. ``secagg_grace_s`` is how long
        the coordinator waits for straggler payloads after the first one
        arrives before declaring dropouts."""
        self.round_config = round_config or RoundConfig()
        self.model_name = model_name
        self.converter = converter or ProtobufConverter()
        self.device = resolve_device("FederatedLearningServicer", device,
                                     None)
        if aggregator is None:
            pc = self.round_config.privacy_config
            # DP-noised updates can exceed the default |w| <= 10 bound:
            # widen it to cover ~8 sigma of the Gaussian mechanism's noise
            aggregator = FedAvgAggregator(
                min_clients=self.round_config.min_clients,
                max_clients=self.round_config.max_clients,
                validator=(dp_widened_validator(pc) if pc is not None
                           else None),
                device=self.device,
            )
        self.aggregator = aggregator
        self.detector = ConvergenceDetector()

        self._lock = threading.RLock()
        self.clients: Dict[str, Dict] = {}
        self.current_round = 0
        self.pending_updates: Dict[int, Dict[str, object]] = {}
        self.global_model: Optional[GlobalModel] = None
        self.round_start_time = time.time()
        self.metrics_history: Dict[str, list] = {"round_time": [],
                                                 "clients_per_round": [],
                                                 "train_loss": []}
        self._agg_pool = futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="fl-aggregate"
        )
        self._aggregating = False

        self.secure_aggregation = secure_aggregation
        self.secagg_threshold = secagg_threshold
        self.secagg_grace_s = float(secagg_grace_s)
        # distributed DP over the wire (fl.distributed_dp): clients ship
        # clipped+gridded+Skellam-noised INTEGER deltas through the masked
        # pipeline; aggregation decodes only the modular sum and applies
        # the average delta to the current global model. Clients must run
        # FederatedTrainer(distributed_dp=True) with the SAME ddp_bits and
        # PrivacyConfig. Epsilon is accounted per round at the realized
        # survivor count (self.ddp_epsilon_total).
        self.distributed_dp = bool(distributed_dp)
        self.ddp_bits = int(ddp_bits)
        self.ddp_epsilon_total = 0.0
        if self.distributed_dp:
            if not secure_aggregation:
                raise ValueError(
                    "distributed_dp requires secure_aggregation=True")
            if self.round_config.privacy_config is None:
                raise ValueError(
                    "distributed_dp needs round_config.privacy_config "
                    "(clip norm + noise multiplier shared with clients)")
        # wire adaptive clipping (Andrew et al. 2021 over the deployment
        # path; the round engine has its twin): clients running
        # FederatedTrainer(adaptive_clipping=True) clip to the C this
        # coordinator broadcasts in RoundConfig.privacy_config and ship a
        # locally DP-noised clipped-count indicator b̃_i in
        # training_metrics.additional_metrics; after each aggregation the
        # geometric quantile tracker moves C toward the
        # ``clip_target_quantile`` of client delta norms. Privacy is
        # charged entirely client-side (the joint (Δ, b) release is one
        # Gaussian mechanism at the per-round (ε, δ), Thm 1), so this
        # coordinator runs only the PUBLIC control loop.
        self.adaptive_clipping = bool(adaptive_clipping)
        self.clip_target_quantile = float(clip_target_quantile)
        self.clip_learning_rate = float(clip_learning_rate)
        # σ_b is a shared deployment parameter: the server needs it only to
        # keep the auto-validator's |w| bound in step with the clients'
        # INFLATED delta noise z_Δ·C as C moves
        self.clip_count_stddev = float(clip_count_stddev)
        if self.adaptive_clipping:
            if self.round_config.privacy_config is None:
                raise ValueError(
                    "adaptive_clipping needs round_config.privacy_config "
                    "(it steers privacy_config.max_grad_norm)")
            if self.distributed_dp:
                raise ValueError(
                    "adaptive_clipping cannot compose with distributed_dp: "
                    "the integer pipeline's quantization grid is derived "
                    "from a FIXED clip norm shared at plan time")
            if secure_aggregation:
                raise ValueError(
                    "adaptive_clipping cannot compose with "
                    "secure_aggregation: training metrics (the indicator "
                    "channel) are withheld under secagg by design")
            if not (0.0 < self.clip_target_quantile < 1.0):
                raise ValueError("clip_target_quantile must be in (0, 1)")
            if self.clip_learning_rate <= 0.0:
                raise ValueError("clip_learning_rate must be positive")
            # fail now, not mid-aggregation: Thm 1 needs 2σ_b > z
            pc = self.round_config.privacy_config
            _zd = adaptive_clip_delta_multiplier(
                math.sqrt(2 * math.log(1.25 / pc.delta)) / pc.epsilon,
                self.clip_count_stddev)
            # adaptive clients noise at the INFLATED z_Δ·C from round 1:
            # keep the auto-validator's |w| bound consistent from the start
            _v = getattr(self.aggregator, "validator", None)
            if _v is not None and hasattr(_v, "max_abs_weight"):
                _v.max_abs_weight = max(
                    _v.max_abs_weight, 10.0 + 8.0 * _zd * pc.max_grad_norm)
        # round_number -> SecAggServerRound. The roster inside is a freeze-
        # time SNAPSHOT of (client_id, pubkey) pairs: every roster fetcher
        # sees the same key for the same peer even if a client re-registers
        # mid-round (divergent keys would silently corrupt the unmasked
        # aggregate).
        self.secagg_rounds: Dict[int, SecAggServerRound] = {}

        # restart resume (services.persistence.CoordinatorPersistence):
        # pick up at the round after the newest persisted global model
        # (ref: GlobalModelModel rows, src/shared/database.py:190-219)
        self.persistence = persistence
        if persistence is not None:
            restored = persistence.load_latest()
            if restored is not None:
                round_number, model = restored
                self.global_model = model
                self.current_round = round_number + 1
                # restore the distributed-DP privacy ledger (persisted in
                # the model's metrics): a restart must not reset ε
                self.ddp_epsilon_total = float(
                    model.accuracy_metrics.get("ddp_epsilon_total", 0.0))
                logger.info(
                    "resumed from persisted global model of round %d "
                    "-> serving round %d", round_number, self.current_round)

    def close(self) -> None:
        """Shut the aggregation executor down, waiting for a running
        aggregation."""
        self._agg_pool.shutdown(wait=True)

    # ------------------------------------------------------------------ RPCs
    def RegisterClient(self, request: pb.ClientRegistration, context):
        """ref: grpc_server.py:66-134."""
        client_id = request.client_id or f"client_{len(self.clients)}"
        with self._lock:
            # secagg key-continuity guard: a re-registration that would
            # CHANGE the stored pubkey while a frozen roster references this
            # client is rejected — the rest of the roster has already
            # derived pair masks from the old key, and accepting a new one
            # would (a) desynchronize mask cancellation and (b) let an
            # unauthenticated peer hijack a victim's client_id to collude
            # with the coordinator (see docs/security: bind client_id to
            # the mTLS client certificate for full protection).
            if self.secure_aggregation:
                old_pub = (self.clients.get(client_id) or {}).get(
                    "secagg_pubkey")
                new_hex = request.metadata.get(SECAGG_PUBKEY_KEY, "")
                changes_key = (old_pub is not None
                               and new_hex != old_pub.hex())
                in_live_roster = any(
                    client_id in rnd.roster_ids
                    for rnd in self.secagg_rounds.values()
                )
                if changes_key and in_live_roster:
                    logger.warning(
                        "rejecting re-registration of %s: it would replace "
                        "the secagg pubkey while a frozen roster references "
                        "it", client_id)
                    return pb.RegistrationResponse(
                        success=False,
                        message=("client_id is referenced by a live "
                                 "secure-aggregation roster; re-register "
                                 "with the original key or wait for the "
                                 "round to complete"),
                        assigned_client_id=client_id,
                    )
                if changes_key:
                    logger.warning(
                        "secagg pubkey for %s replaced on re-registration "
                        "(no live roster references it); without mTLS "
                        "client-identity binding this is unauthenticated",
                        client_id)
            self.clients[client_id] = {
                "capabilities": self.converter.client_capabilities_from_proto(
                    request.capabilities
                ),
                "state": pb.CLIENT_STATE_REGISTERED,
                "registered_at": time.time(),
                "last_seen": time.time(),
                "rounds_participated": 0,
                "last_loss": 0.0,
                "last_accuracy": 0.0,
            }
            pubkey_hex = request.metadata.get(SECAGG_PUBKEY_KEY, "")
            if pubkey_hex:
                try:
                    pub = bytes.fromhex(pubkey_hex)
                    if len(pub) != 32:
                        raise ValueError(f"{len(pub)} bytes, want 32")
                    self.clients[client_id]["secagg_pubkey"] = pub
                except ValueError as e:
                    # a malformed key in the roster would crash every honest
                    # client's X25519 exchange — reject it here
                    logger.warning("client %s sent an invalid secagg "
                                   "pubkey (%s); ignoring", client_id, e)
        logger.info("registered client %s (total %d)", client_id,
                    len(self.clients))
        resp = pb.RegistrationResponse(
            success=True,
            message="registered",
            assigned_client_id=client_id,
            global_model_version=self.current_round,
        )
        resp.server_info.server_version = SERVER_VERSION
        resp.server_info.supported_models.extend(
            ["simple_cnn", "cifar10_cnn", "federated_resnet",
             "lightweight_mobilenet"]
        )
        resp.server_info.supported_datasets.extend(["mnist", "cifar10"])
        if self.round_config.privacy_config is not None:
            resp.server_info.default_privacy_config.CopyFrom(
                self.converter.privacy_config_to_proto(
                    self.round_config.privacy_config
                )
            )
        return resp

    def UpdateClientCapabilities(self, request: pb.ClientCapabilities, context):
        return pb.UpdateResponse(success=True, message="capabilities noted")

    def GetGlobalModel(self, request: pb.ModelRequest, context):
        """ref: grpc_server.py:136-176 (+ lazy initial model :433-463)."""
        with self._lock:
            if self.global_model is None:
                self.global_model = self._create_initial_global_model()
            model = self.global_model
            self._touch(request.client_id)
        return self.converter.global_model_to_proto(model)

    def SubmitModelUpdate(self, request: pb.ModelUpdate, context):
        """ref: grpc_server.py:178-236 — collect under lock, trigger
        aggregation when min_clients reached."""
        try:
            update = self.converter.model_update_from_proto(request)
        except Exception as e:
            logger.error("undecodable update from %s: %s", request.client_id, e)
            return pb.UpdateAck(success=False,
                                message=f"undecodable update: {e}")
        with self._lock:
            if self.secure_aggregation:
                self._maybe_reset_stalled_secagg_round()
            if update.round_number != self.current_round:
                return pb.UpdateAck(
                    success=False,
                    message=(f"stale round {update.round_number}, current is "
                             f"{self.current_round}"),
                    round_status=pb.ROUND_STATUS_IN_PROGRESS,
                )
            if self.secure_aggregation:
                rnd = self.secagg_rounds.get(self.current_round)
                if rnd is None:
                    return pb.UpdateAck(
                        success=False,
                        message="no frozen secagg roster for this round; "
                                "fetch GetSecAggRoster first",
                        round_status=pb.ROUND_STATUS_IN_PROGRESS,
                    )
                if update.client_id not in rnd.roster_ids:
                    return pb.UpdateAck(
                        success=False,
                        message=(f"{update.client_id} is not in the round "
                                 f"{self.current_round} secagg roster — a "
                                 "non-roster masked payload cannot cancel"),
                        round_status=pb.ROUND_STATUS_IN_PROGRESS,
                    )
            bucket = self.pending_updates.setdefault(self.current_round, {})
            bucket[update.client_id] = update
            self._touch(update.client_id,
                        state=pb.CLIENT_STATE_WAITING,
                        loss=update.training_loss)
            n_pending = len(bucket)
            if self.secure_aggregation:
                # aggregation fires from the REVEAL phase, not here; a
                # complete roster freezes the survivor set immediately
                # (no dropouts -> no grace wait)
                if rnd.first_payload_time is None:
                    rnd.first_payload_time = time.time()
                if (rnd.survivors is None
                        and set(rnd.roster_ids).issubset(bucket.keys())):
                    rnd.freeze_survivors(bucket.keys())
                should_aggregate = False
            else:
                should_aggregate = (
                    n_pending >= self.round_config.min_clients
                    and not self._aggregating
                )
            if should_aggregate:
                self._aggregating = True
        if should_aggregate:
            self._agg_pool.submit(self._perform_aggregation,
                                  self.current_round)
        return pb.UpdateAck(
            success=True,
            message=f"update accepted ({n_pending} pending)",
            round_status=(pb.ROUND_STATUS_AGGREGATING if should_aggregate
                          else pb.ROUND_STATUS_IN_PROGRESS),
        )

    def JoinTrainingRound(self, request: pb.RoundJoinRequest, context):
        """ref: grpc_server.py:238-289."""
        with self._lock:
            self._touch(request.client_id, state=pb.CLIENT_STATE_TRAINING)
            cfg = self._current_round_config()
        resp = pb.RoundJoinResponse(
            success=True,
            message=f"joined round {self.current_round}",
            assigned_round=self.current_round,
        )
        resp.round_config.CopyFrom(self.converter.round_config_to_proto(cfg))
        return resp

    def GetRoundConfig(self, request: pb.RoundConfigRequest, context):
        """ref: grpc_server.py:291-318."""
        with self._lock:
            return self.converter.round_config_to_proto(
                self._current_round_config()
            )

    def GetTrainingStatus(self, request: pb.StatusRequest, context):
        """ref: grpc_server.py:320-365."""
        with self._lock:
            pending = len(self.pending_updates.get(self.current_round, {}))
            active = sum(
                1 for c in self.clients.values()
                if time.time() - c["last_seen"] < 120
            )
            status = TrainingStatus(
                current_round=self.current_round,
                active_clients=active,
                round_progress=min(
                    1.0, pending / max(self.round_config.min_clients, 1)
                ),
                global_accuracy=(
                    self.global_model.get_accuracy() or 0.0
                    if self.global_model else 0.0
                ),
                convergence_score=(
                    self.global_model.convergence_score
                    if self.global_model else 0.0
                ),
            )
            round_status = (pb.ROUND_STATUS_AGGREGATING if self._aggregating
                            else pb.ROUND_STATUS_IN_PROGRESS if pending
                            else pb.ROUND_STATUS_WAITING)
            msg = self.converter.training_status_to_proto(status, round_status)
            for cid, c in self.clients.items():
                msg.client_statuses.append(pb.ClientStatus(
                    client_id=cid,
                    state=c["state"],
                    last_loss=c["last_loss"],
                    last_accuracy=c["last_accuracy"],
                    last_update_time=int(c["last_seen"]),
                    rounds_participated=c["rounds_participated"],
                ))
            return msg

    def HealthCheck(self, request: pb.HealthRequest, context):
        """ref: grpc_server.py:367-390."""
        resp = pb.HealthResponse(healthy=True, status="serving",
                                 timestamp=int(time.time()))
        resp.details["version"] = SERVER_VERSION
        resp.details["current_round"] = str(self.current_round)
        resp.details["registered_clients"] = str(len(self.clients))
        return resp

    def _maybe_reset_stalled_secagg_round(self):
        """Stall recovery (lock held by caller): if the round has exceeded
        the configured timeout without reaching an unmaskable state (share
        phase incomplete, sub-threshold survivors, reveals missing), drop
        the round's protocol state so the next roster request freezes a
        fresh roster with a FRESH NONCE — retry masks are therefore always
        new. Checked lazily on the RPC paths rather than by a watchdog
        thread."""
        if not self.secure_aggregation:
            return
        rn = self.current_round
        rnd = self.secagg_rounds.get(rn)
        if rnd is None or self._aggregating:
            return
        timeout = float(self.round_config.timeout_seconds or 300)
        if time.time() - self.round_start_time <= timeout:
            return
        logger.warning(
            "secagg round %d timed out (shares_ready=%s survivors=%s "
            "reveals_ok=%s); clearing for retry with a fresh roster+nonce",
            rn, rnd.shares_ready(), rnd.survivors, rnd.can_unmask())
        self.pending_updates.pop(rn, None)
        self.secagg_rounds.pop(rn, None)
        self.round_start_time = time.time()

    def GetSecAggRoster(self, request: pb.SecAggRosterRequest, context):
        """Secure-aggregation roster (service extension): freezes the set of
        pubkey-bearing clients for the round once min_clients are present,
        then serves the same frozen snapshot (ids, keys, nonce, threshold)
        to every caller."""
        if not self.secure_aggregation:
            return pb.SecAggRoster(
                ready=False,
                message="secure aggregation is not enabled on this "
                        "coordinator",
            )
        with self._lock:
            self._maybe_reset_stalled_secagg_round()
            rn = self.current_round
            rnd = self.secagg_rounds.get(rn)
            if rnd is None:
                # only recently-seen keyed clients, capped at max_clients —
                # an idle registrant in the roster would deadlock the round.
                # The snapshot pairs each id with the pubkey AS OF freeze
                # time; later re-registrations cannot skew what peers see.
                now = time.time()
                keyed = sorted(
                    (cid, bytes(c["secagg_pubkey"]))
                    for cid, c in self.clients.items()
                    if c.get("secagg_pubkey") and now - c["last_seen"] < 120
                )[: self.round_config.max_clients]
                if len(keyed) >= self.round_config.min_clients:
                    rnd = SecAggServerRound(
                        rn, keyed, threshold=self.secagg_threshold)
                    self.secagg_rounds[rn] = rnd
                    self.round_start_time = now
                    logger.info(
                        "secagg roster frozen for round %d (t=%d): %s",
                        rn, rnd.threshold, rnd.roster_ids)
            resp = pb.SecAggRoster(ready=rnd is not None, round_number=rn)
            if rnd is None:
                resp.message = "roster not yet frozen (waiting for keys)"
            else:
                for cid, pub in rnd.roster:
                    resp.peers.add(client_id=cid, public_key=pub)
                resp.roster_nonce = rnd.nonce
                resp.threshold = rnd.threshold
                resp.frac_bits = rnd.frac_bits
            return resp

    def _secagg_round_for(self, round_number: int, nonce: bytes):
        """Look up the round's protocol state and bind the caller's nonce
        to it (a stale-nonce request belongs to a purged roster)."""
        rnd = self.secagg_rounds.get(round_number)
        if rnd is None:
            raise ValueError(f"no live secagg roster for round "
                             f"{round_number}")
        if nonce and bytes(nonce) != rnd.nonce:
            raise ValueError("roster nonce mismatch: your roster was "
                             "purged; re-fetch GetSecAggRoster")
        return rnd

    def SubmitSecAggShares(self, request: pb.SecAggShareUpload, context):
        """Phase 1 ferry: store client i's encrypted share bundles."""
        try:
            with self._lock:
                rnd = self._secagg_round_for(request.round_number,
                                             request.roster_nonce)
            rnd.add_share_upload(
                request.client_id,
                [(s.to_client_id, bytes(s.ciphertext))
                 for s in request.shares])
            return pb.UpdateResponse(success=True, message="shares stored")
        except ValueError as e:
            return pb.UpdateResponse(success=False, message=str(e))

    def GetSecAggShares(self, request: pb.SecAggRosterRequest, context):
        """Phase 1 pickup: the bundles addressed to the caller, served only
        once EVERY roster member's shares arrived."""
        try:
            with self._lock:
                self._maybe_reset_stalled_secagg_round()
                rnd = self._secagg_round_for(request.round_number, b"")
        except ValueError as e:
            return pb.SecAggShareDownload(ready=False, message=str(e))
        if not rnd.shares_ready():
            return pb.SecAggShareDownload(
                ready=False, message="waiting for peers' shares")
        resp = pb.SecAggShareDownload(ready=True)
        for from_cid, blob in rnd.shares_for(request.client_id):
            resp.shares.add(from_client_id=from_cid,
                            to_client_id=request.client_id,
                            ciphertext=blob)
        return resp

    def GetSecAggReveal(self, request: pb.SecAggRevealRequest, context):
        """Phase 3 poll: survivor/dropped sets, frozen lazily once every
        roster payload arrived OR the grace window after the first payload
        elapsed with >= threshold submissions."""
        try:
            with self._lock:
                self._maybe_reset_stalled_secagg_round()
                rnd = self._secagg_round_for(request.round_number, b"")
                if rnd.survivors is None and rnd.shares_ready():
                    bucket = self.pending_updates.get(request.round_number,
                                                      {})
                    submitted = set(bucket) & set(rnd.roster_ids)
                    complete = submitted == set(rnd.roster_ids)
                    grace_over = (
                        rnd.first_payload_time is not None
                        and time.time() - rnd.first_payload_time
                        > self.secagg_grace_s
                    )
                    if complete or (grace_over
                                    and len(submitted) >= rnd.threshold):
                        rnd.freeze_survivors(submitted)
                        if len(submitted) < self.round_config.min_clients:
                            logger.warning(
                                "secagg round %d proceeding with %d "
                                "survivors (< min_clients=%d) after "
                                "dropout", request.round_number,
                                len(submitted),
                                self.round_config.min_clients)
        except ValueError as e:
            return pb.SecAggRevealInfo(ready=False, message=str(e))
        if rnd.survivors is None:
            return pb.SecAggRevealInfo(
                ready=False, message="survivor set not frozen yet")
        return pb.SecAggRevealInfo(
            ready=True, roster_nonce=rnd.nonce,
            survivors=rnd.survivors, dropped=rnd.dropped)

    def SubmitSecAggReveal(self, request: pb.SecAggRevealUpload, context):
        """Phase 3 collection; triggers unmasking+aggregation once the
        reveal threshold is met."""
        try:
            with self._lock:
                rnd = self._secagg_round_for(request.round_number,
                                             request.roster_nonce)
            rnd.add_reveal(
                request.client_id,
                [(s.subject_client_id, s.is_key_share, bytes(s.share))
                 for s in request.shares])
        except ValueError as e:
            return pb.UpdateResponse(success=False, message=str(e))
        with self._lock:
            fire = (rnd.can_unmask() and not self._aggregating
                    and request.round_number == self.current_round)
            if fire:
                self._aggregating = True
        if fire:
            self._agg_pool.submit(self._perform_aggregation,
                                  request.round_number)
        return pb.UpdateResponse(success=True, message="reveal stored")

    def GetMetrics(self, request: pb.MetricsRequest, context):
        """ref: grpc_server.py:392-431."""
        resp = pb.MetricsResponse(success=True)
        with self._lock:
            for name, series in self.metrics_history.items():
                if request.metric_names and name not in request.metric_names:
                    continue
                data = pb.MetricData(metric_name=name)
                for ts, value in series[-100:]:
                    data.points.append(pb.MetricPoint(timestamp=int(ts),
                                                      value=float(value)))
                resp.metrics[name].CopyFrom(data)
        return resp

    # ------------------------------------------------------------- internals
    def _touch(self, client_id: str, state: Optional[int] = None,
               loss: Optional[float] = None) -> None:
        c = self.clients.get(client_id)
        if c is None:
            return
        c["last_seen"] = time.time()
        if state is not None:
            c["state"] = state
        if loss is not None:
            c["last_loss"] = loss

    def _current_round_config(self) -> RoundConfig:
        return dataclasses.replace(self.round_config,
                                   round_number=self.current_round)

    def _create_initial_global_model(self) -> GlobalModel:
        """Lazy round-0 model (ref: grpc_server.py:433-463): the port's
        ``create_model`` drawn from seed 0 on the servicer's device, kept
        as numpy (the wire's form)."""
        from fl_tpu_torch.models import create_model, init_variables
        from fl_tpu_torch.models.factory import get_model_weights

        model = create_model(self.model_name)
        variables = init_variables(model, seed=0, device=self.device)
        weights = {k: to_numpy(v)
                   for k, v in get_model_weights(variables).items()}
        logger.info("created initial %s global model (%d tensors)",
                    self.model_name, len(weights))
        return GlobalModel(round_number=0, model_weights=weights)

    def _ddp_plan(self, dim: int, roster_len: int):
        """Distributed-DP decode plan for a wire round, and the int32
        headroom certificate the round engine makes at config time: a
        large-roster/high-bits deployment would silently wrap the modular
        sum and decode garbage, so it is refused instead."""
        pc = self.round_config.privacy_config
        plan = DistributedDPPlan(
            clip_norm=float(pc.max_grad_norm),
            bits=self.ddp_bits, dim=dim,
            expected_clients=roster_len,
            noise_multiplier=float(pc.noise_multiplier))
        check_no_wraparound(plan, roster_len)
        return plan

    def _adapted_clip_norm(self, updates) -> Optional[float]:
        """Geometric quantile-tracking step for wire adaptive clipping
        (Andrew et al. 2021, Alg. 1 — same update rule as the tested
        ``fl.privacy.geometric_clip_update``, host-arithmetic twin):
        average the clients' locally-noised clipped-count indicators b̃_i
        and move C ← C·exp(−η_C·(b̄ − γ)). Returns None when no update in
        the round carried an indicator (legacy / non-adaptive clients), so
        mixed fleets leave C untouched rather than steering it on silence.
        """
        vals = [
            u.training_metrics.additional_metrics["adaptive_clip_indicator"]
            for u in updates
            if u.training_metrics is not None
            and "adaptive_clip_indicator"
            in u.training_metrics.additional_metrics
        ]
        if not vals:
            return None
        pc = self.round_config.privacy_config
        frac = float(np.mean(vals))
        return float(pc.max_grad_norm * math.exp(
            -self.clip_learning_rate * (frac - self.clip_target_quantile)))

    def _apply_clip_norm(self, new_clip_norm: float) -> None:
        """Commit an adapted clip norm: broadcast it to clients via the
        per-round RoundConfig.privacy_config and keep the auto-validator's
        |w| bound in step with the clients' z_Δ·C delta noise (caller
        holds the lock)."""
        pc = self.round_config.privacy_config
        self.round_config = dataclasses.replace(
            self.round_config,
            privacy_config=dataclasses.replace(
                pc, max_grad_norm=new_clip_norm))
        validator = getattr(self.aggregator, "validator", None)
        if validator is not None and hasattr(validator, "max_abs_weight"):
            z = math.sqrt(2 * math.log(1.25 / pc.delta)) / pc.epsilon
            z_delta = adaptive_clip_delta_multiplier(
                z, self.clip_count_stddev)
            validator.max_abs_weight = (
                10.0 + 8.0 * z_delta * new_clip_norm)
        self.metrics_history.setdefault("clip_norm", []).append(
            (time.time(), new_clip_norm))
        logger.info("adaptive clipping: C -> %.6g", new_clip_norm)

    def _on_device(self, model: GlobalModel) -> GlobalModel:
        """A host-decoded aggregate's weights moved to the servicer's
        device, where the plain round's average lives."""
        model.model_weights = {k: weight_tensor(v, self.device)
                               for k, v in model.model_weights.items()}
        return model

    def _secure_aggregate(self, rnd: SecAggServerRound, updates,
                          prev_model: Optional[GlobalModel]) -> GlobalModel:
        """The secure round's aggregate (ref: grpc_server.py:760-813):
        strip the masks and decode on the host, then move it to the
        device. Under distributed DP the decoded quantity is the modular
        INTEGER sum (the only one the protocol ever exposes): its average
        delta is applied to the current global model and ε is charged at
        the realized survivor count."""
        if not self.distributed_dp:
            # reconstruct self masks + dropped clients' pair masks, strip
            # them, decode the fixed-point weighted sum
            return self._on_device(rnd.unmask_aggregate(updates))
        if prev_model is None:
            raise ValueError(
                "distributed_dp aggregation needs an existing "
                "global model (deltas apply to it)")
        summed, survivors = rnd.unmask_integer_sum(updates)
        pc = self.round_config.privacy_config
        prev = {k: to_numpy(v).astype(np.float32)
                for k, v in prev_model.model_weights.items()}
        dim = int(sum(v.size for v in prev.values()))
        plan = self._ddp_plan(dim, len(rnd.roster_ids))
        avg_delta = host_decode_average(summed, plan)
        new_model = GlobalModel(
            round_number=rnd.round_number,
            model_weights={k: prev[k] + avg_delta[k] for k in avg_delta},
            accuracy_metrics={},
            participating_clients=survivors,
            convergence_score=0.0)
        eps_round = distributed_epsilon(plan, 1, pc.delta,
                                        realized=len(survivors))
        self.ddp_epsilon_total += eps_round
        # the privacy ledger must survive coordinator restarts: it rides
        # in the persisted model's metrics (restored in __init__ with the
        # round number)
        new_model.accuracy_metrics["ddp_epsilon_total"] = \
            self.ddp_epsilon_total
        logger.info(
            "distributed-DP round %d: %d survivors, eps_round=%.4f, "
            "eps_total=%.4f", rnd.round_number, len(survivors), eps_round,
            self.ddp_epsilon_total)
        return self._on_device(new_model)

    def _perform_aggregation(self, round_number: int) -> None:
        """ref: grpc_server.py:750-895 — aggregate (plain or secure),
        convergence, advance, persist."""
        t0 = time.time()
        try:
            with self._lock:
                updates = list(
                    self.pending_updates.get(round_number, {}).values()
                )
                prev_model = self.global_model
                rnd = self.secagg_rounds.get(round_number)
            if self.secure_aggregation:
                if rnd is None:
                    raise ValueError(f"secagg state for round "
                                     f"{round_number} vanished")
                updates = [u for u in updates
                           if u.client_id in set(rnd.survivors or ())]
                new_model = self._secure_aggregate(rnd, updates, prev_model)
            else:
                new_model = self.aggregator.aggregate_updates(updates)
            score = self.aggregator.calculate_convergence_metrics(
                prev_model, new_model
            )
            new_model.convergence_score = score
            new_clip_norm = (self._adapted_clip_norm(updates)
                             if self.adaptive_clipping else None)
            if prev_model is not None:
                # carry forward only metrics this aggregation did NOT
                # produce (e.g. an externally-set test_accuracy) — copying
                # all of prev's metrics would freeze train_accuracy at its
                # round-1 value forever
                for k, v in prev_model.accuracy_metrics.items():
                    new_model.accuracy_metrics.setdefault(k, v)
            avg_loss = float(np.mean([u.training_loss for u in updates]))
            self.detector.update(RoundObservation(
                round_number=round_number,
                accuracy=new_model.get_accuracy() or 0.0,
                loss=avg_loss,
            ))
            with self._lock:
                self.global_model = new_model
                self.current_round = round_number + 1
                if new_clip_norm is not None:
                    self._apply_clip_norm(new_clip_norm)
                self.pending_updates.pop(round_number, None)
                self.secagg_rounds.pop(round_number, None)
                for u in updates:
                    c = self.clients.get(u.client_id)
                    if c:
                        c["rounds_participated"] += 1
                        c["state"] = pb.CLIENT_STATE_REGISTERED
                dt = time.time() - t0
                self.metrics_history["round_time"].append((time.time(), dt))
                self.metrics_history["clients_per_round"].append(
                    (time.time(), len(updates))
                )
                self.metrics_history["train_loss"].append(
                    (time.time(), avg_loss)
                )
                self.round_start_time = time.time()
            logger.info("round %d aggregated: %d clients in %.2fs -> round %d",
                        round_number, len(updates), dt, self.current_round)
            if self.persistence is not None:
                try:
                    self.persistence.save_global_model(new_model,
                                                       train_loss=avg_loss)
                except Exception:
                    logger.exception(
                        "failed to persist global model for round %d "
                        "(serving continues)", round_number)
        except FedAvgError as e:
            logger.error("aggregation failed for round %d: %s",
                         round_number, e)
            # purge updates that fail validation so they don't poison the
            # round — later submissions can still reach the threshold
            with self._lock:
                bucket = self.pending_updates.get(round_number, {})
                for cid in list(bucket):
                    if not self.aggregator.validate_update(bucket[cid]):
                        del bucket[cid]
                        logger.warning(
                            "dropped invalid update from %s (round %d)",
                            cid, round_number,
                        )
        except Exception:
            # the secure path raises ValueError/KeyError/shape errors on
            # malformed roster payloads; an unobserved executor future would
            # swallow them and every later submit would re-trigger the same
            # failing aggregation. Log loudly and clear the round so the
            # all-or-retry timeout path can recover with a fresh roster.
            logger.exception("aggregation crashed for round %d; clearing "
                             "the round's updates for retry", round_number)
            with self._lock:
                self.pending_updates.pop(round_number, None)
                self.secagg_rounds.pop(round_number, None)
                self.round_start_time = time.time()
        finally:
            with self._lock:
                self._aggregating = False


class CoordinatorGRPCServer:
    """gRPC server wrapper (ref: CoordinatorGRPCServer,
    grpc_server.py:509-581)."""

    def __init__(self, servicer: Optional[FederatedLearningServicer] = None,
                 host: str = "0.0.0.0", port: int = 50051,
                 max_workers: int = 10,
                 tls_cert_path: Optional[str] = None,
                 tls_key_path: Optional[str] = None,
                 tls_client_ca_path: Optional[str] = None):
        """``tls_cert_path``/``tls_key_path`` enable TLS (the reference
        serves insecure channels only — grpc_server.py:547); adding
        ``tls_client_ca_path`` requires client certificates (mTLS)."""
        self.servicer = servicer or FederatedLearningServicer()
        self.host = host
        self.port = port
        self.max_workers = max_workers
        if bool(tls_cert_path) != bool(tls_key_path):
            raise ValueError(
                "partial TLS config: tls_cert_path and tls_key_path must "
                "both be set (or both unset) — refusing to silently serve "
                "an insecure port")
        if tls_client_ca_path and not tls_cert_path:
            raise ValueError("tls_client_ca_path requires tls_cert_path + "
                             "tls_key_path")
        self.tls_cert_path = tls_cert_path
        self.tls_key_path = tls_key_path
        self.tls_client_ca_path = tls_client_ca_path
        self._server = None

    def start(self) -> int:
        import grpc

        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=self.max_workers),
            options=GRPC_OPTIONS,
        )
        self._server.add_generic_rpc_handlers(
            (make_service_handler(self.servicer),)
        )
        address = f"{self.host}:{self.port}"
        if self.tls_cert_path and self.tls_key_path:
            with open(self.tls_key_path, "rb") as f:
                key = f.read()
            with open(self.tls_cert_path, "rb") as f:
                cert = f.read()
            root = None
            if self.tls_client_ca_path:
                with open(self.tls_client_ca_path, "rb") as f:
                    root = f.read()
            creds = grpc.ssl_server_credentials(
                [(key, cert)], root_certificates=root,
                require_client_auth=root is not None,
            )
            bound = self._server.add_secure_port(address, creds)
        else:
            bound = self._server.add_insecure_port(address)
        if bound == 0:
            raise RuntimeError(f"could not bind {address}")
        self.port = bound
        self._server.start()
        logger.info("coordinator gRPC serving on %s:%d%s", self.host,
                    self.port,
                    " (TLS)" if self.tls_cert_path else "")
        return bound

    def stop(self, grace: float = 2.0) -> None:
        """Stop serving, then wait for the servicer's running
        aggregation."""
        if self._server is not None:
            self._server.stop(grace).wait()
            self._server = None
        self.servicer.close()

    def wait_for_termination(self, timeout: Optional[float] = None) -> None:
        if self._server is not None:
            self._server.wait_for_termination(timeout)
