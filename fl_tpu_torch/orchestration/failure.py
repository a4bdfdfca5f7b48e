"""Client failure detection and recovery policy (a copy of
``fl_tpu.orchestration.failure``; host code, no tensors).

Parity target: src/coordinator/failure_handler.py — FailureType (8 kinds,
:17-27), FailureAction (:29-37), ClientFailure (:39-85), ClientHealthTracker
(:87-254: health score, reliability, failure-pattern detection) and
FailureHandler (:256-659: policy table FailureType→Action, exclusion expiry,
healthy-client queries). Notable reference policies kept exactly:
PRIVACY_VIOLATION → permanent exclusion (ref :543-544); repeated same-type /
rapid / frequent-timeout patterns escalate (ref :181-211); temporary
exclusions expire after 1 h via the recovery monitor (ref :604-622).

Deliberate difference: exclusion expiry is checked lazily on every query
instead of a dedicated 60 s daemon thread (same observable behavior, no
thread).
"""

from __future__ import annotations

import enum
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


class FailureType(enum.Enum):
    """ref: FailureType, failure_handler.py:17-27."""

    CONNECTION_LOST = "connection_lost"
    TIMEOUT = "timeout"
    INVALID_UPDATE = "invalid_update"
    TRAINING_ERROR = "training_error"
    RESOURCE_EXHAUSTION = "resource_exhaustion"
    PRIVACY_VIOLATION = "privacy_violation"
    PROTOCOL_ERROR = "protocol_error"
    UNKNOWN = "unknown"


class FailureAction(enum.Enum):
    """ref: FailureAction, failure_handler.py:29-37."""

    RETRY = "retry"
    EXCLUDE_ROUND = "exclude_round"
    EXCLUDE_TEMPORARY = "exclude_temporary"
    EXCLUDE_PERMANENT = "exclude_permanent"
    REDUCE_LOAD = "reduce_load"


@dataclass
class ClientFailure:
    """ref: ClientFailure, failure_handler.py:39-85."""

    client_id: str
    failure_type: FailureType
    timestamp: float = field(default_factory=time.time)
    round_number: Optional[int] = None
    details: str = ""
    action_taken: Optional[FailureAction] = None


@dataclass
class ClientHealth:
    """Per-client health state (ref fields: ClientHealthTracker,
    failure_handler.py:87-254)."""

    client_id: str
    health_score: float = 1.0  # [0, 1]
    successes: int = 0
    failures: List[ClientFailure] = field(default_factory=list)
    excluded_until: Optional[float] = None  # None=active, inf=permanent

    @property
    def reliability(self) -> float:
        total = self.successes + len(self.failures)
        return self.successes / total if total else 1.0


# policy table (ref: _determine_action, failure_handler.py:513-556)
DEFAULT_POLICY: Dict[FailureType, FailureAction] = {
    FailureType.CONNECTION_LOST: FailureAction.RETRY,
    FailureType.TIMEOUT: FailureAction.EXCLUDE_ROUND,
    FailureType.INVALID_UPDATE: FailureAction.EXCLUDE_ROUND,
    FailureType.TRAINING_ERROR: FailureAction.RETRY,
    FailureType.RESOURCE_EXHAUSTION: FailureAction.REDUCE_LOAD,
    FailureType.PRIVACY_VIOLATION: FailureAction.EXCLUDE_PERMANENT,
    FailureType.PROTOCOL_ERROR: FailureAction.EXCLUDE_TEMPORARY,
    FailureType.UNKNOWN: FailureAction.RETRY,
}

TEMPORARY_EXCLUSION_S = 3600.0  # ref: 1-hour temporary exclusion
PATTERN_WINDOW_S = 300.0
HEALTH_DECAY = 0.15  # per failure
HEALTH_RECOVERY = 0.05  # per success


class ClientHealthTracker:
    """ref: ClientHealthTracker, failure_handler.py:87-254."""

    def __init__(self):
        self._lock = threading.RLock()
        self.clients: Dict[str, ClientHealth] = {}

    def _get(self, client_id: str) -> ClientHealth:
        return self.clients.setdefault(client_id,
                                       ClientHealth(client_id=client_id))

    def record_success(self, client_id: str) -> None:
        with self._lock:
            h = self._get(client_id)
            h.successes += 1
            h.health_score = min(1.0, h.health_score + HEALTH_RECOVERY)

    def record_failure(self, failure: ClientFailure) -> None:
        """ref: _update_health_score, failure_handler.py:212-254."""
        with self._lock:
            h = self._get(failure.client_id)
            h.failures.append(failure)
            if len(h.failures) > 100:
                h.failures = h.failures[-100:]
            penalty = HEALTH_DECAY
            if failure.failure_type == FailureType.PRIVACY_VIOLATION:
                penalty = 1.0
            h.health_score = max(0.0, h.health_score - penalty)

    def detect_failure_patterns(self, client_id: str) -> List[str]:
        """Repeated-type / rapid / frequent-timeout patterns
        (ref: detect_failure_patterns, failure_handler.py:181-211)."""
        with self._lock:
            h = self.clients.get(client_id)
            if h is None:
                return []
            now = time.time()
            recent = [f for f in h.failures
                      if now - f.timestamp < PATTERN_WINDOW_S]
        patterns: List[str] = []
        by_type: Dict[FailureType, int] = {}
        for f in recent:
            by_type[f.failure_type] = by_type.get(f.failure_type, 0) + 1
        for ftype, count in by_type.items():
            if count >= 3:
                patterns.append(f"repeated_{ftype.value}")
        if len(recent) >= 5:
            patterns.append("rapid_failures")
        if by_type.get(FailureType.TIMEOUT, 0) >= 2:
            patterns.append("frequent_timeouts")
        return patterns

    def get_health(self, client_id: str) -> Dict[str, Any]:
        with self._lock:
            h = self.clients.get(client_id)
            if h is None:
                return {"client_id": client_id, "health_score": 1.0,
                        "reliability": 1.0, "failures": 0, "excluded": False}
            return {
                "client_id": client_id,
                "health_score": h.health_score,
                "reliability": h.reliability,
                "failures": len(h.failures),
                "excluded": self._is_excluded(h),
                "patterns": self.detect_failure_patterns(client_id),
            }

    @staticmethod
    def _is_excluded(h: ClientHealth) -> bool:
        return h.excluded_until is not None and time.time() < h.excluded_until


class FailureHandler:
    """Policy engine (ref: FailureHandler, failure_handler.py:256-659)."""

    def __init__(self,
                 policy: Optional[Dict[FailureType, FailureAction]] = None,
                 temporary_exclusion_s: float = TEMPORARY_EXCLUSION_S):
        self.policy = dict(DEFAULT_POLICY)
        if policy:
            self.policy.update(policy)
        self.temporary_exclusion_s = temporary_exclusion_s
        self.tracker = ClientHealthTracker()
        self.failure_log: List[ClientFailure] = []
        self._lock = threading.RLock()

    # -- core entry point (ref: handle_failure, failure_handler.py:352-461) --
    def handle_failure(self, client_id: str, failure_type: FailureType,
                       round_number: Optional[int] = None,
                       details: str = "") -> FailureAction:
        failure = ClientFailure(client_id=client_id,
                                failure_type=failure_type,
                                round_number=round_number, details=details)
        self.tracker.record_failure(failure)
        action = self._determine_action(client_id, failure_type)
        failure.action_taken = action
        with self._lock:
            self.failure_log.append(failure)
            if len(self.failure_log) > 1000:
                self.failure_log = self.failure_log[-1000:]
        self._execute_action(client_id, action)
        logger.warning("client %s failure %s -> %s", client_id,
                       failure_type.value, action.value)
        return action

    def record_success(self, client_id: str) -> None:
        self.tracker.record_success(client_id)

    def _determine_action(self, client_id: str,
                          failure_type: FailureType) -> FailureAction:
        """Base policy escalated by detected patterns
        (ref: _determine_action :513-556)."""
        action = self.policy.get(failure_type, FailureAction.RETRY)
        patterns = self.tracker.detect_failure_patterns(client_id)
        if patterns and action in (FailureAction.RETRY,
                                   FailureAction.EXCLUDE_ROUND):
            action = FailureAction.EXCLUDE_TEMPORARY
        health = self.tracker.get_health(client_id)["health_score"]
        if health <= 0.0:
            action = FailureAction.EXCLUDE_PERMANENT
        return action

    def _execute_action(self, client_id: str, action: FailureAction) -> None:
        """ref: _execute_action :558-602."""
        with self.tracker._lock:
            h = self.tracker._get(client_id)
            if action == FailureAction.EXCLUDE_TEMPORARY:
                h.excluded_until = time.time() + self.temporary_exclusion_s
            elif action == FailureAction.EXCLUDE_PERMANENT:
                h.excluded_until = float("inf")
            elif action == FailureAction.EXCLUDE_ROUND:
                # round-scoped exclusions are enforced by the round manager;
                # record a short cool-down so selection skips the client now
                h.excluded_until = time.time() + 1.0

    # -- queries (ref: get_healthy_clients :463-511) ---------------------------
    def get_healthy_clients(self, candidates: List[str],
                            min_health: float = 0.3) -> List[str]:
        out = []
        for cid in candidates:
            info = self.tracker.get_health(cid)
            if not info["excluded"] and info["health_score"] >= min_health:
                out.append(cid)
        return out

    def get_excluded_clients(self) -> List[str]:
        with self.tracker._lock:
            return [cid for cid, h in self.tracker.clients.items()
                    if self.tracker._is_excluded(h)]

    def include_client(self, client_id: str) -> None:
        """Manual re-admission (REST /clients/<id>/include)."""
        with self.tracker._lock:
            h = self.tracker._get(client_id)
            h.excluded_until = None
            h.health_score = max(h.health_score, 0.5)

    def exclude_client(self, client_id: str,
                       permanent: bool = False) -> None:
        """Manual exclusion (REST /clients/<id>/exclude)."""
        with self.tracker._lock:
            h = self.tracker._get(client_id)
            h.excluded_until = (float("inf") if permanent
                                else time.time() + self.temporary_exclusion_s)

    def get_failure_statistics(self) -> Dict[str, Any]:
        """ref: get_failure_statistics (REST /failures/statistics)."""
        with self._lock:
            log = list(self.failure_log)
        by_type: Dict[str, int] = {}
        by_action: Dict[str, int] = {}
        for f in log:
            by_type[f.failure_type.value] = by_type.get(
                f.failure_type.value, 0) + 1
            if f.action_taken:
                by_action[f.action_taken.value] = by_action.get(
                    f.action_taken.value, 0) + 1
        return {
            "total_failures": len(log),
            "by_type": by_type,
            "by_action": by_action,
            "excluded_clients": self.get_excluded_clients(),
            "tracked_clients": len(self.tracker.clients),
        }
