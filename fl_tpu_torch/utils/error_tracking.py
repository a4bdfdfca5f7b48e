"""Central error tracking: categorization, dedup, pattern detection (port
of ``fl_tpu.utils.error_tracking``).

Parity target: src/shared/error_tracking.py: ErrorSeverity (:20),
ErrorCategory (:28), ErrorEvent (:42), ErrorPattern (:62), ErrorTracker
(:77+: track_error with 5-minute dedup, ≥3-similar-in-window pattern
detection) and ErrorHandler's auto-categorization by exception name +
message keywords plus the context-manager capture (the reference file is
corrupted from :103; the behavior follows its legible intent).
"""

from __future__ import annotations

import enum
import logging
import threading
import time
import traceback
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

logger = logging.getLogger(__name__)

DEDUP_WINDOW_S = 300.0  # ref: dedup within 5 min
PATTERN_THRESHOLD = 3   # ref: >=3 similar errors in the window


class ErrorSeverity(enum.Enum):
    """ref: ErrorSeverity, error_tracking.py:20-26."""

    LOW = "low"
    MEDIUM = "medium"
    HIGH = "high"
    CRITICAL = "critical"


class ErrorCategory(enum.Enum):
    """ref: ErrorCategory, error_tracking.py:28-40."""

    NETWORK = "network"
    PRIVACY = "privacy"
    VALIDATION = "validation"
    TRAINING = "training"
    AGGREGATION = "aggregation"
    RESOURCE = "resource"
    CONFIGURATION = "configuration"
    UNKNOWN = "unknown"


@dataclass
class ErrorEvent:
    """ref: ErrorEvent, error_tracking.py:42-60."""

    error_type: str
    message: str
    category: ErrorCategory
    severity: ErrorSeverity
    timestamp: float = field(default_factory=time.time)
    client_id: Optional[str] = None
    round_number: Optional[int] = None
    stack_trace: Optional[str] = None
    count: int = 1  # dedup counter

    @property
    def signature(self) -> str:
        return f"{self.category.value}:{self.error_type}:{self.message[:80]}"


@dataclass
class ErrorPattern:
    """ref: ErrorPattern, error_tracking.py:62-75."""

    signature: str
    count: int
    first_seen: float
    last_seen: float
    category: ErrorCategory


# keyword → category map for auto-categorization (ref: ErrorHandler intent)
_CATEGORY_KEYWORDS = {
    ErrorCategory.NETWORK: ("connection", "grpc", "socket", "unavailable",
                            "timeout", "refused", "unreachable"),
    ErrorCategory.PRIVACY: ("privacy", "epsilon", "budget", "noise", "dp"),
    ErrorCategory.VALIDATION: ("invalid", "validation", "shape", "nan",
                               "mismatch", "bounds"),
    ErrorCategory.TRAINING: ("training", "gradient", "loss", "optimizer",
                             "diverge"),
    ErrorCategory.AGGREGATION: ("aggregat", "fedavg", "insufficient"),
    ErrorCategory.RESOURCE: ("memory", "oom", "disk", "resource", "hbm",
                             "vmem"),
    ErrorCategory.CONFIGURATION: ("config", "yaml", "argument", "unknown "
                                  "model", "unsupported"),
}


def categorize_error(exc: BaseException) -> ErrorCategory:
    """Auto-categorize by exception class name + message keywords."""
    text = f"{type(exc).__name__} {exc}".lower()
    for category, keywords in _CATEGORY_KEYWORDS.items():
        if any(k in text for k in keywords):
            return category
    return ErrorCategory.UNKNOWN


def severity_for(category: ErrorCategory) -> ErrorSeverity:
    return {
        ErrorCategory.PRIVACY: ErrorSeverity.CRITICAL,
        ErrorCategory.AGGREGATION: ErrorSeverity.HIGH,
        ErrorCategory.RESOURCE: ErrorSeverity.HIGH,
        ErrorCategory.NETWORK: ErrorSeverity.MEDIUM,
        ErrorCategory.VALIDATION: ErrorSeverity.MEDIUM,
        ErrorCategory.TRAINING: ErrorSeverity.MEDIUM,
        ErrorCategory.CONFIGURATION: ErrorSeverity.LOW,
        ErrorCategory.UNKNOWN: ErrorSeverity.LOW,
    }[category]


class ErrorTracker:
    """ref: ErrorTracker, error_tracking.py:77-102+."""

    def __init__(self, max_history: int = 1000):
        self._lock = threading.RLock()
        self.events: Deque[ErrorEvent] = deque(maxlen=max_history)
        self._recent: Dict[str, ErrorEvent] = {}  # signature -> last event

    def track_error(
        self,
        exc: BaseException,
        client_id: Optional[str] = None,
        round_number: Optional[int] = None,
        category: Optional[ErrorCategory] = None,
        severity: Optional[ErrorSeverity] = None,
    ) -> ErrorEvent:
        cat = category or categorize_error(exc)
        event = ErrorEvent(
            error_type=type(exc).__name__,
            message=str(exc),
            category=cat,
            severity=severity or severity_for(cat),
            client_id=client_id,
            round_number=round_number,
            stack_trace=traceback.format_exc(),
        )
        with self._lock:
            prev = self._recent.get(event.signature)
            if prev and event.timestamp - prev.timestamp < DEDUP_WINDOW_S:
                prev.count += 1
                prev.timestamp = event.timestamp
                return prev
            self._recent[event.signature] = event
            self.events.append(event)
        logger.log(
            logging.CRITICAL if event.severity == ErrorSeverity.CRITICAL
            else logging.ERROR,
            "[%s/%s] %s: %s", event.category.value, event.severity.value,
            event.error_type, event.message,
        )
        return event

    def detect_error_patterns(self) -> List[ErrorPattern]:
        """≥3 similar events within the window (ref intent,
        _detect_error_patterns)."""
        now = time.time()
        with self._lock:
            recent = [e for e in self.events
                      if now - e.timestamp < DEDUP_WINDOW_S]
        by_sig: Dict[str, List[ErrorEvent]] = {}
        for e in recent:
            by_sig.setdefault(e.signature, []).append(e)
        patterns = []
        for sig, events in by_sig.items():
            total = sum(e.count for e in events)
            if total >= PATTERN_THRESHOLD:
                patterns.append(ErrorPattern(
                    signature=sig, count=total,
                    first_seen=min(e.timestamp for e in events),
                    last_seen=max(e.timestamp for e in events),
                    category=events[0].category,
                ))
        return patterns

    def get_error_summary(self) -> Dict[str, Any]:
        with self._lock:
            events = list(self.events)
        by_cat: Dict[str, int] = {}
        by_sev: Dict[str, int] = {}
        for e in events:
            by_cat[e.category.value] = by_cat.get(e.category.value, 0) + e.count
            by_sev[e.severity.value] = by_sev.get(e.severity.value, 0) + e.count
        return {
            "total_errors": sum(e.count for e in events),
            "unique_errors": len(events),
            "by_category": by_cat,
            "by_severity": by_sev,
            "patterns": [p.signature for p in self.detect_error_patterns()],
        }


class ErrorHandler:
    """Capture helper composing the tracker (ref: ErrorHandler +
    create_error_handler intent)."""

    def __init__(self, tracker: Optional[ErrorTracker] = None):
        self.tracker = tracker or ErrorTracker()

    @contextmanager
    def capture(self, client_id: Optional[str] = None,
                round_number: Optional[int] = None,
                reraise: bool = True):
        """Context manager: track any exception raised inside."""
        try:
            yield self.tracker
        except Exception as e:
            self.tracker.track_error(e, client_id=client_id,
                                     round_number=round_number)
            if reraise:
                raise


def create_error_handler() -> ErrorHandler:
    """Factory (ref: create_error_handler)."""
    return ErrorHandler()
