"""Structured JSON logging for federated services (port of
``fl_tpu.utils.logging_config``).

Parity target: src/shared/logging_config.py: JSONFormatter carrying FL
context fields (client_id / round_number / request_id, ref :16-60),
setup_logging with rotating 10MB×5 file handlers plus a separate error log
(ref :62-158), log_federated_event (ref :160-195) and MetricsLogger
(ref :197-…).
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import time
from pathlib import Path
from typing import Any, Dict, Optional

FL_CONTEXT_FIELDS = ("client_id", "round_number", "request_id", "service")


class JSONFormatter(logging.Formatter):
    """One JSON object per line (ref: JSONFormatter,
    logging_config.py:16-46)."""

    def __init__(self, service_name: str = "fl"):
        super().__init__()
        self.service_name = service_name

    def format(self, record: logging.LogRecord) -> str:
        payload: Dict[str, Any] = {
            "timestamp": record.created,
            "level": record.levelname,
            "logger": record.name,
            "service": self.service_name,
            "message": record.getMessage(),
        }
        for field in FL_CONTEXT_FIELDS:
            value = getattr(record, field, None)
            if value is not None:
                payload[field] = value
        if record.exc_info:
            payload["exception"] = self.formatException(record.exc_info)
        return json.dumps(payload, default=str)


class FederatedLearningFilter(logging.Filter):
    """Injects default FL context fields so the formatter never KeyErrors
    (ref: FederatedLearningFilter, logging_config.py:48-60)."""

    def __init__(self, service_name: str = "fl"):
        super().__init__()
        self.service_name = service_name

    def filter(self, record: logging.LogRecord) -> bool:
        if not hasattr(record, "service"):
            record.service = self.service_name
        return True


def setup_logging(
    level: str = "INFO",
    log_file: Optional[str] = None,
    service_name: str = "fl",
    json_console: bool = False,
    max_bytes: int = 10 * 1024 * 1024,
    backup_count: int = 5,
) -> logging.Logger:
    """Configure root logging (ref: setup_logging,
    logging_config.py:62-158): console handler, rotating main log, rotating
    error-only log."""
    root = logging.getLogger()
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    for h in list(root.handlers):
        root.removeHandler(h)

    flt = FederatedLearningFilter(service_name)

    console = logging.StreamHandler()
    if json_console:
        console.setFormatter(JSONFormatter(service_name))
    else:
        console.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"
        ))
    console.addFilter(flt)
    root.addHandler(console)

    if log_file:
        path = Path(log_file)
        path.parent.mkdir(parents=True, exist_ok=True)
        # rotating main log (ref :119-123)
        fh = logging.handlers.RotatingFileHandler(
            path, maxBytes=max_bytes, backupCount=backup_count
        )
        fh.setFormatter(JSONFormatter(service_name))
        fh.addFilter(flt)
        root.addHandler(fh)
        # separate error log (ref :138-147)
        eh = logging.handlers.RotatingFileHandler(
            path.with_suffix(".error" + path.suffix or ".log"),
            maxBytes=max_bytes, backupCount=backup_count,
        )
        eh.setLevel(logging.ERROR)
        eh.setFormatter(JSONFormatter(service_name))
        eh.addFilter(flt)
        root.addHandler(eh)
    return root


def log_federated_event(
    logger: logging.Logger,
    event: str,
    client_id: Optional[str] = None,
    round_number: Optional[int] = None,
    level: int = logging.INFO,
    **extra: Any,
) -> None:
    """Structured FL event (ref: log_federated_event,
    logging_config.py:160-195)."""
    logger.log(level, "%s %s", event,
               json.dumps(extra, default=str) if extra else "",
               extra={"client_id": client_id, "round_number": round_number})


class MetricsLogger:
    """Append-only JSONL metrics stream (ref: MetricsLogger,
    logging_config.py:197-…)."""

    def __init__(self, filepath: Optional[str] = None,
                 logger_name: str = "fl.metrics"):
        self.filepath = filepath
        self.logger = logging.getLogger(logger_name)
        if filepath:
            Path(filepath).parent.mkdir(parents=True, exist_ok=True)

    def log_metric(self, name: str, value: float,
                   tags: Optional[Dict[str, Any]] = None) -> None:
        record = {
            "timestamp": time.time(),
            "metric": name,
            "value": float(value),
            "tags": tags or {},
        }
        line = json.dumps(record, default=str)
        self.logger.info("metric %s=%s", name, value)
        if self.filepath:
            with open(self.filepath, "a") as f:
                f.write(line + "\n")

    def log_round_metrics(self, round_number: int,
                          metrics: Dict[str, float]) -> None:
        for name, value in metrics.items():
            self.log_metric(name, value, tags={"round": round_number})
