"""Round lifecycle management for the deployment coordinator (port of
``fl_tpu.orchestration.round_manager``).

Parity target: src/coordinator/round_manager.py — RoundState/ClientState
machines (:27-47), TrainingRound (:49-170), RoundManager (:172-705) with its
1-second management tick (timeout watchdog + auto-start), client selection,
threshold- and timeout-triggered aggregation ("aggregate if min reached at
timeout, else fail the round", ref :630-648), and lifecycle callbacks.

This drives the REST API and the simulation harness; the gRPC servicer keeps
its own lighter round state, mirroring the reference's (documented)
duplication (SURVEY.md appendix).

Deliberate difference: ONE supervisor thread with an event-based tick
instead of the reference's per-concern daemon threads + RLock lattice.
The aggregation runs synchronously on the caller's thread, on the
aggregator's device (the card unless ``device="cpu"``).
"""

from __future__ import annotations

import enum
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from fl_tpu_torch.core.types import GlobalModel, ModelUpdate, RoundConfig
from fl_tpu_torch.fl.convergence import ConvergenceDetector, RoundObservation
from fl_tpu_torch.fl.fedavg import FedAvgAggregator, FedAvgError

logger = logging.getLogger(__name__)


class RoundState(enum.Enum):
    """ref: RoundState, round_manager.py:27-36."""

    WAITING = "waiting"
    STARTING = "starting"
    IN_PROGRESS = "in_progress"
    COLLECTING = "collecting"
    AGGREGATING = "aggregating"
    COMPLETED = "completed"
    FAILED = "failed"


class ClientRoundState(enum.Enum):
    """ref: ClientState, round_manager.py:38-47."""

    INVITED = "invited"
    JOINED = "joined"
    TRAINING = "training"
    SUBMITTED = "submitted"
    FAILED = "failed"
    DROPPED = "dropped"


@dataclass
class TrainingRound:
    """One round's mutable state (ref: TrainingRound,
    round_manager.py:49-170)."""

    round_number: int
    config: RoundConfig
    state: RoundState = RoundState.WAITING
    started_at: Optional[float] = None
    completed_at: Optional[float] = None
    selected_clients: List[str] = field(default_factory=list)
    client_states: Dict[str, ClientRoundState] = field(default_factory=dict)
    updates: Dict[str, ModelUpdate] = field(default_factory=dict)
    result_model: Optional[GlobalModel] = None
    failure_reason: Optional[str] = None

    def start(self, selected_clients: List[str]) -> None:
        self.selected_clients = list(selected_clients)
        self.client_states = {c: ClientRoundState.INVITED
                              for c in selected_clients}
        self.state = RoundState.IN_PROGRESS
        self.started_at = time.time()

    def submit_update(self, update: ModelUpdate) -> bool:
        """ref: round_manager.py:118-147."""
        if self.state not in (RoundState.IN_PROGRESS, RoundState.COLLECTING):
            return False
        self.updates[update.client_id] = update
        self.client_states[update.client_id] = ClientRoundState.SUBMITTED
        self.state = RoundState.COLLECTING
        return True

    def is_ready_for_aggregation(self) -> bool:
        """All selected clients submitted, or min reached and the rest
        failed/dropped (ref :148-170)."""
        if len(self.updates) >= len(self.selected_clients) > 0:
            return True
        pending = sum(
            1 for s in self.client_states.values()
            if s in (ClientRoundState.INVITED, ClientRoundState.JOINED,
                     ClientRoundState.TRAINING)
        )
        return pending == 0 and len(self.updates) >= self.config.min_clients

    def is_timed_out(self) -> bool:
        return (self.started_at is not None
                and self.state in (RoundState.IN_PROGRESS,
                                   RoundState.COLLECTING)
                and time.time() - self.started_at > self.config.timeout_seconds)

    @property
    def elapsed(self) -> float:
        if self.started_at is None:
            return 0.0
        return (self.completed_at or time.time()) - self.started_at


class RoundManager:
    """ref: RoundManager, round_manager.py:172-705."""

    def __init__(
        self,
        round_config: Optional[RoundConfig] = None,
        aggregator: Optional[FedAvgAggregator] = None,
        auto_start: bool = False,
        tick_interval_s: float = 1.0,
        max_history: int = 100,
        device=None,
    ):
        """``device``: where the default aggregator runs (None is the
        card); a given ``aggregator`` brings its own."""
        self.round_config = round_config or RoundConfig()
        self.aggregator = aggregator or FedAvgAggregator(
            min_clients=self.round_config.min_clients,
            max_clients=self.round_config.max_clients,
            device=device,
        )
        self.detector = ConvergenceDetector()
        self.auto_start = auto_start
        self.tick_interval_s = tick_interval_s
        self.max_history = max_history

        self._lock = threading.RLock()
        self.registered_clients: Dict[str, Dict[str, Any]] = {}
        self.current_round: Optional[TrainingRound] = None
        self.round_history: List[TrainingRound] = []
        self.global_model: Optional[GlobalModel] = None
        self.round_counter = 0

        self.on_round_complete: List[Callable[[TrainingRound], None]] = []
        self.on_round_failed: List[Callable[[TrainingRound], None]] = []

        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        """Start the management tick (ref: round_manager.py:224-243)."""
        self._stop.clear()
        self._thread = threading.Thread(target=self._management_loop,
                                        daemon=True, name="fl-round-manager")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=3)
            self._thread = None

    def _management_loop(self) -> None:
        """1-second tick: timeouts + auto-start
        (ref: _management_loop, round_manager.py:506-531)."""
        while not self._stop.wait(self.tick_interval_s):
            try:
                with self._lock:
                    rnd = self.current_round
                if rnd is not None and rnd.is_timed_out():
                    self._handle_round_timeout(rnd)
                elif rnd is not None and rnd.is_ready_for_aggregation():
                    self._trigger_aggregation(rnd)
                elif (rnd is None and self.auto_start
                      and len(self.registered_clients)
                      >= self.round_config.min_clients):
                    self.start_round()
            except Exception as e:  # keep the supervisor alive
                logger.error("round-manager tick failed: %s", e)

    # -- client registry --------------------------------------------------------
    def register_client(self, client_id: str,
                        info: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            self.registered_clients[client_id] = {
                "registered_at": time.time(),
                "rounds_participated": 0,
                **(info or {}),
            }

    def unregister_client(self, client_id: str) -> None:
        with self._lock:
            self.registered_clients.pop(client_id, None)
            if (self.current_round is not None
                    and client_id in self.current_round.client_states):
                self.current_round.client_states[client_id] = (
                    ClientRoundState.DROPPED
                )

    # -- round control ------------------------------------------------------------
    def start_round(self,
                    client_ids: Optional[List[str]] = None) -> TrainingRound:
        """ref: start_round + _select_clients_for_round,
        round_manager.py:300-360, 533-549."""
        with self._lock:
            if self.current_round is not None and self.current_round.state in (
                RoundState.IN_PROGRESS, RoundState.COLLECTING,
                RoundState.AGGREGATING,
            ):
                raise RuntimeError("a round is already in progress")
            selected = client_ids or self._select_clients()
            if len(selected) < self.round_config.min_clients:
                raise RuntimeError(
                    f"not enough clients: {len(selected)} < "
                    f"{self.round_config.min_clients}"
                )
            import dataclasses

            cfg = dataclasses.replace(self.round_config,
                                      round_number=self.round_counter)
            rnd = TrainingRound(round_number=self.round_counter, config=cfg)
            rnd.start(selected)
            self.current_round = rnd
            self.round_counter += 1
            logger.info("round %d started with %d clients",
                        rnd.round_number, len(selected))
            return rnd

    def _select_clients(self) -> List[str]:
        """Up to max_clients, preferring long-registered clients
        (ref: _select_clients_for_round :533-549)."""
        clients = sorted(self.registered_clients,
                         key=lambda c: self.registered_clients[c]
                         ["registered_at"])
        return clients[: self.round_config.max_clients]

    def submit_update(self, update: ModelUpdate) -> bool:
        with self._lock:
            rnd = self.current_round
            if rnd is None or update.round_number != rnd.round_number:
                return False
            accepted = rnd.submit_update(update)
            ready = accepted and rnd.is_ready_for_aggregation()
        if ready:
            self._trigger_aggregation(rnd)
        return accepted

    def mark_client_failed(self, client_id: str) -> None:
        with self._lock:
            rnd = self.current_round
            if rnd is not None and client_id in rnd.client_states:
                rnd.client_states[client_id] = ClientRoundState.FAILED

    # -- aggregation ---------------------------------------------------------------
    def _trigger_aggregation(self, rnd: TrainingRound) -> None:
        """ref: _trigger_aggregation + _perform_aggregation,
        round_manager.py:551-628 (synchronous here: the caller is either the
        supervisor tick or the last submitter; the heavy math is one device
        reduction, not worth a thread)."""
        with self._lock:
            if rnd.state == RoundState.AGGREGATING:
                return
            rnd.state = RoundState.AGGREGATING
        try:
            updates = list(rnd.updates.values())
            prev = self.global_model
            model = self.aggregator.aggregate_updates(updates)
            model.convergence_score = (
                self.aggregator.calculate_convergence_metrics(prev, model)
            )
            avg_loss = float(np.mean([u.training_loss for u in updates]))
            self.detector.update(RoundObservation(
                round_number=rnd.round_number,
                accuracy=model.get_accuracy() or 0.0,
                loss=avg_loss,
            ))
            with self._lock:
                rnd.result_model = model
                rnd.state = RoundState.COMPLETED
                rnd.completed_at = time.time()
                self.global_model = model
                for cid in rnd.updates:
                    if cid in self.registered_clients:
                        self.registered_clients[cid][
                            "rounds_participated"] += 1
                self._archive(rnd)
            for cb in self.on_round_complete:
                cb(rnd)
            logger.info("round %d completed (%d updates, %.2fs)",
                        rnd.round_number, len(updates), rnd.elapsed)
        except FedAvgError as e:
            self._fail_round(rnd, str(e))

    def _handle_round_timeout(self, rnd: TrainingRound) -> None:
        """Aggregate-if-min-reached else fail (ref: _handle_round_timeout,
        round_manager.py:630-648)."""
        logger.warning("round %d timed out after %.0fs (%d/%d updates)",
                       rnd.round_number, rnd.elapsed, len(rnd.updates),
                       len(rnd.selected_clients))
        for cid, state in rnd.client_states.items():
            if state in (ClientRoundState.INVITED, ClientRoundState.JOINED,
                         ClientRoundState.TRAINING):
                rnd.client_states[cid] = ClientRoundState.DROPPED
        if len(rnd.updates) >= rnd.config.min_clients:
            self._trigger_aggregation(rnd)
        else:
            self._fail_round(
                rnd, f"timeout with only {len(rnd.updates)} updates"
            )

    def _fail_round(self, rnd: TrainingRound, reason: str) -> None:
        with self._lock:
            rnd.state = RoundState.FAILED
            rnd.failure_reason = reason
            rnd.completed_at = time.time()
            self._archive(rnd)
        for cb in self.on_round_failed:
            cb(rnd)
        logger.error("round %d failed: %s", rnd.round_number, reason)

    def _archive(self, rnd: TrainingRound) -> None:
        if self.current_round is rnd:
            self.current_round = None
        self.round_history.append(rnd)
        if len(self.round_history) > self.max_history:
            self.round_history = self.round_history[-self.max_history:]

    # -- introspection (ref: get_training_status, round_manager.py:465-504) --
    def get_training_status(self) -> Dict[str, Any]:
        with self._lock:
            rnd = self.current_round
            completed = [r for r in self.round_history
                         if r.state == RoundState.COMPLETED]
            return {
                "current_round": (rnd.round_number if rnd
                                  else self.round_counter),
                "round_state": rnd.state.value if rnd else "idle",
                "round_progress": (
                    len(rnd.updates) / max(len(rnd.selected_clients), 1)
                    if rnd else 0.0
                ),
                "registered_clients": len(self.registered_clients),
                "active_round_clients": (len(rnd.selected_clients)
                                         if rnd else 0),
                "completed_rounds": len(completed),
                "failed_rounds": len(self.round_history) - len(completed),
                "global_accuracy": (
                    self.global_model.get_accuracy() or 0.0
                    if self.global_model else 0.0
                ),
                "convergence_score": (
                    self.global_model.convergence_score
                    if self.global_model else 0.0
                ),
                "avg_round_time": (
                    float(np.mean([r.elapsed for r in completed[-10:]]))
                    if completed else 0.0
                ),
            }

    def get_round_history(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [
                {
                    "round_number": r.round_number,
                    "state": r.state.value,
                    "clients": len(r.selected_clients),
                    "updates": len(r.updates),
                    "elapsed_s": r.elapsed,
                    "failure_reason": r.failure_reason,
                }
                for r in self.round_history
            ]
