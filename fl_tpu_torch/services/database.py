"""Persistence layer for coordinator state (port of
``fl_tpu.services.database``).

Parity target: src/shared/database.py: the SQLAlchemy ORM models
TrainingRoundModel (:22), ClientUpdateModel (:66), ClientModel (:106),
ClientFailureModel (:158), GlobalModelModel (:190: weights on disk,
metadata in the DB), SystemMetricsModel (:222), DatabaseManager (:258) and
DatabaseRepository CRUD (:309-539), plus the factory/init helpers
(:541-573).

The schema and the repository surface are on stdlib ``sqlite3``, the
reference package's exact tables and columns, so a database file written
by either package is read by the other. The weights-on-disk convention is
kept: global model rows store ``model_path``.
"""

from __future__ import annotations

import json
import logging
import sqlite3
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS training_rounds (
    round_number INTEGER PRIMARY KEY,
    status TEXT NOT NULL,
    started_at REAL,
    completed_at REAL,
    participating_clients INTEGER DEFAULT 0,
    total_samples INTEGER DEFAULT 0,
    avg_training_loss REAL,
    global_accuracy REAL,
    convergence_score REAL,
    config_json TEXT
);
CREATE TABLE IF NOT EXISTS client_updates (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    client_id TEXT NOT NULL,
    round_number INTEGER NOT NULL,
    num_samples INTEGER,
    training_loss REAL,
    privacy_budget_used REAL,
    compression_ratio REAL,
    submitted_at REAL,
    UNIQUE(client_id, round_number)
);
CREATE TABLE IF NOT EXISTS clients (
    client_id TEXT PRIMARY KEY,
    registered_at REAL,
    last_seen REAL,
    compute_power TEXT,
    network_bandwidth INTEGER,
    available_samples INTEGER,
    rounds_participated INTEGER DEFAULT 0,
    status TEXT DEFAULT 'active'
);
CREATE TABLE IF NOT EXISTS client_failures (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    client_id TEXT NOT NULL,
    failure_type TEXT NOT NULL,
    action_taken TEXT,
    round_number INTEGER,
    occurred_at REAL,
    details TEXT
);
CREATE TABLE IF NOT EXISTS global_models (
    round_number INTEGER PRIMARY KEY,
    model_path TEXT NOT NULL,
    accuracy_metrics_json TEXT,
    convergence_score REAL,
    created_at REAL
);
CREATE TABLE IF NOT EXISTS system_metrics (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    recorded_at REAL,
    cpu_percent REAL,
    memory_percent REAL,
    disk_percent REAL,
    active_clients INTEGER
);
"""


def _parse_url(database_url: str) -> str:
    """Accepts sqlite:///path, sqlite:///:memory:, or a bare path."""
    if database_url.startswith("sqlite:///"):
        return database_url[len("sqlite:///"):]
    if database_url.startswith("sqlite://"):
        return database_url[len("sqlite://"):] or ":memory:"
    if database_url.startswith(("postgresql://", "mysql://")):
        raise ValueError(
            "only sqlite URLs are supported in this environment; got "
            f"{database_url.split('://')[0]}://"
        )
    return database_url


class DatabaseManager:
    """Connection + schema lifecycle (ref: DatabaseManager,
    database.py:258-307)."""

    def __init__(self, database_url: str = "sqlite:///fl_coordinator.db"):
        self.path = _parse_url(database_url)
        if self.path != ":memory:":
            Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        # single shared connection; sqlite serializes writes internally and
        # the coordinator funnels DB writes through one repository
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.RLock()

    def create_tables(self) -> None:
        with self._lock:
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    def execute(self, sql: str, params: tuple = ()) -> sqlite3.Cursor:
        with self._lock:
            cur = self._conn.execute(sql, params)
            self._conn.commit()
            return cur

    def query(self, sql: str, params: tuple = ()) -> List[Dict[str, Any]]:
        with self._lock:
            rows = self._conn.execute(sql, params).fetchall()
        return [dict(r) for r in rows]

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class DatabaseRepository:
    """CRUD per table (ref: DatabaseRepository, database.py:309-539)."""

    def __init__(self, manager: DatabaseManager):
        self.db = manager

    # -- rounds -------------------------------------------------------------
    def save_round(self, round_number: int, status: str,
                   started_at: Optional[float] = None,
                   completed_at: Optional[float] = None,
                   participating_clients: int = 0, total_samples: int = 0,
                   avg_training_loss: Optional[float] = None,
                   global_accuracy: Optional[float] = None,
                   convergence_score: Optional[float] = None,
                   config: Optional[Dict[str, Any]] = None) -> None:
        self.db.execute(
            """INSERT INTO training_rounds
               (round_number, status, started_at, completed_at,
                participating_clients, total_samples, avg_training_loss,
                global_accuracy, convergence_score, config_json)
               VALUES (?,?,?,?,?,?,?,?,?,?)
               ON CONFLICT(round_number) DO UPDATE SET
                 status=excluded.status,
                 completed_at=excluded.completed_at,
                 participating_clients=excluded.participating_clients,
                 total_samples=excluded.total_samples,
                 avg_training_loss=excluded.avg_training_loss,
                 global_accuracy=excluded.global_accuracy,
                 convergence_score=excluded.convergence_score""",
            (round_number, status, started_at, completed_at,
             participating_clients, total_samples, avg_training_loss,
             global_accuracy, convergence_score,
             json.dumps(config or {}, default=str)),
        )

    def get_round(self, round_number: int) -> Optional[Dict[str, Any]]:
        rows = self.db.query(
            "SELECT * FROM training_rounds WHERE round_number=?",
            (round_number,),
        )
        return rows[0] if rows else None

    def list_rounds(self, limit: int = 100) -> List[Dict[str, Any]]:
        return self.db.query(
            "SELECT * FROM training_rounds ORDER BY round_number DESC LIMIT ?",
            (limit,),
        )

    # -- client updates ---------------------------------------------------------
    def save_client_update(self, client_id: str, round_number: int,
                           num_samples: int, training_loss: float,
                           privacy_budget_used: float = 0.0,
                           compression_ratio: float = 1.0) -> None:
        self.db.execute(
            """INSERT OR REPLACE INTO client_updates
               (client_id, round_number, num_samples, training_loss,
                privacy_budget_used, compression_ratio, submitted_at)
               VALUES (?,?,?,?,?,?,?)""",
            (client_id, round_number, num_samples, training_loss,
             privacy_budget_used, compression_ratio, time.time()),
        )

    def get_round_updates(self, round_number: int) -> List[Dict[str, Any]]:
        return self.db.query(
            "SELECT * FROM client_updates WHERE round_number=?",
            (round_number,),
        )

    # -- clients --------------------------------------------------------------------
    def upsert_client(self, client_id: str, compute_power: str = "medium",
                      network_bandwidth: int = 0,
                      available_samples: int = 0,
                      status: str = "active") -> None:
        now = time.time()
        self.db.execute(
            """INSERT INTO clients
               (client_id, registered_at, last_seen, compute_power,
                network_bandwidth, available_samples, status)
               VALUES (?,?,?,?,?,?,?)
               ON CONFLICT(client_id) DO UPDATE SET
                 last_seen=excluded.last_seen,
                 compute_power=excluded.compute_power,
                 network_bandwidth=excluded.network_bandwidth,
                 available_samples=excluded.available_samples,
                 status=excluded.status""",
            (client_id, now, now, compute_power, network_bandwidth,
             available_samples, status),
        )

    def increment_participation(self, client_id: str) -> None:
        self.db.execute(
            """UPDATE clients SET rounds_participated = rounds_participated
               + 1, last_seen = ? WHERE client_id = ?""",
            (time.time(), client_id),
        )

    def get_client(self, client_id: str) -> Optional[Dict[str, Any]]:
        rows = self.db.query("SELECT * FROM clients WHERE client_id=?",
                             (client_id,))
        return rows[0] if rows else None

    def list_clients(self) -> List[Dict[str, Any]]:
        return self.db.query("SELECT * FROM clients ORDER BY registered_at")

    # -- failures ----------------------------------------------------------------------
    def save_failure(self, client_id: str, failure_type: str,
                     action_taken: Optional[str] = None,
                     round_number: Optional[int] = None,
                     details: str = "") -> None:
        self.db.execute(
            """INSERT INTO client_failures
               (client_id, failure_type, action_taken, round_number,
                occurred_at, details) VALUES (?,?,?,?,?,?)""",
            (client_id, failure_type, action_taken, round_number,
             time.time(), details),
        )

    def list_failures(self, client_id: Optional[str] = None,
                      limit: int = 100) -> List[Dict[str, Any]]:
        if client_id:
            return self.db.query(
                """SELECT * FROM client_failures WHERE client_id=?
                   ORDER BY occurred_at DESC LIMIT ?""",
                (client_id, limit),
            )
        return self.db.query(
            "SELECT * FROM client_failures ORDER BY occurred_at DESC LIMIT ?",
            (limit,),
        )

    # -- global models (weights on disk, ref database.py:190-219) ------------------
    def save_global_model(self, round_number: int, model_path: str,
                          accuracy_metrics: Optional[Dict[str, float]] = None,
                          convergence_score: float = 0.0) -> None:
        self.db.execute(
            """INSERT OR REPLACE INTO global_models
               (round_number, model_path, accuracy_metrics_json,
                convergence_score, created_at) VALUES (?,?,?,?,?)""",
            (round_number, model_path,
             json.dumps(accuracy_metrics or {}), convergence_score,
             time.time()),
        )

    def get_latest_global_model(self) -> Optional[Dict[str, Any]]:
        rows = self.db.query(
            "SELECT * FROM global_models ORDER BY round_number DESC LIMIT 1"
        )
        return rows[0] if rows else None

    # -- system metrics ---------------------------------------------------------------
    def save_system_metrics(self, cpu_percent: float, memory_percent: float,
                            disk_percent: float,
                            active_clients: int = 0) -> None:
        self.db.execute(
            """INSERT INTO system_metrics
               (recorded_at, cpu_percent, memory_percent, disk_percent,
                active_clients) VALUES (?,?,?,?,?)""",
            (time.time(), cpu_percent, memory_percent, disk_percent,
             active_clients),
        )


def create_database_manager(database_url: Optional[str] = None
                            ) -> DatabaseManager:
    """Factory (ref: create_database_manager, database.py:541-558)."""
    return DatabaseManager(database_url or "sqlite:///fl_coordinator.db")


def init_database(database_url: Optional[str] = None) -> DatabaseRepository:
    """Create tables + repository (ref: init_database, database.py:560-573)."""
    mgr = create_database_manager(database_url)
    mgr.create_tables()
    return DatabaseRepository(mgr)
