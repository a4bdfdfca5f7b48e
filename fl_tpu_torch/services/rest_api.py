"""REST management API for the coordinator (port of
``fl_tpu.services.rest_api``).

Parity target: src/coordinator/rest_api.py (CoordinatorAPI, ~25 Flask+CORS
endpoints, :22-147). The same route surface is served by a stdlib
``http.server`` ThreadingHTTPServer: no dependency, the reference
package's JSON responses, the same daemon-thread lifecycle. It reads the
port's ``RoundManager``, ``FailureHandler`` and ``MetricsCollector``, and
optionally the gRPC servicer's own round and client state.

Routes (ref: _register_routes, rest_api.py:63-104):
  GET  /health                         liveness
  GET  /status                         coordinator + training status
  GET  /training/status                round manager status
  POST /training/start                 start a round
  POST /training/stop                  stop current round (fail it)
  GET  /training/rounds                round history
  GET  /clients                        registered clients
  GET  /clients/<id>                   one client
  GET  /clients/<id>/health            failure-handler health view
  POST /clients/<id>/exclude           manual exclusion
  POST /clients/<id>/include           manual re-admission
  GET  /metrics                        training progress
  GET  /metrics/prometheus             Prometheus exposition text
  GET  /metrics/system                 system metrics
  GET  /metrics/training               training progress series
  GET  /metrics/clients                per-client aggregates
  POST /metrics/export                 export metrics JSON to disk
  GET  /config                         round config
  GET  /config/privacy                 privacy config
  POST /config/privacy                 update privacy config
  GET  /failures                       recent failures
  GET  /failures/statistics            failure statistics
  POST /admin/reset                    reset coordinator state
  GET  /admin/logs                     recent log records
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import tempfile
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import urlparse

from fl_tpu_torch.core.types import PrivacyConfig
from fl_tpu_torch.orchestration.failure import FailureHandler
from fl_tpu_torch.orchestration.metrics import MetricsCollector
from fl_tpu_torch.orchestration.round_manager import RoundManager

logger = logging.getLogger(__name__)

_RECENT_LOGS: deque = deque(maxlen=500)


class _LogCapture(logging.Handler):
    def emit(self, record: logging.LogRecord) -> None:
        _RECENT_LOGS.append({
            "time": record.created,
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        })


class CoordinatorAPI:
    """ref: CoordinatorAPI, rest_api.py:22-147."""

    def __init__(
        self,
        round_manager: Optional[RoundManager] = None,
        metrics: Optional[MetricsCollector] = None,
        failure_handler: Optional[FailureHandler] = None,
        host: str = "0.0.0.0",
        port: int = 8080,
        grpc_servicer=None,
    ):
        self.round_manager = round_manager or RoundManager()
        self.metrics = metrics or MetricsCollector()
        self.failure_handler = failure_handler or FailureHandler()
        # optional bridge to the gRPC servicer's own round/client state
        # (the reference keeps the two views fully disjoint — its REST API
        # cannot see gRPC-registered clients at all; SURVEY.md appendix)
        self.grpc_servicer = grpc_servicer
        self.host = host
        self.port = port
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.started_at = time.time()
        root = logging.getLogger()
        if not any(isinstance(h, _LogCapture) for h in root.handlers):
            root.addHandler(_LogCapture())

    # -- request dispatch -----------------------------------------------------
    def handle(self, method: str, path: str,
               body: Optional[Dict[str, Any]]) -> Tuple[int, Dict[str, Any]]:
        rm, fh, mc = self.round_manager, self.failure_handler, self.metrics
        parts = [p for p in path.split("/") if p]
        try:
            if method == "GET" and path == "/health":
                return 200, {"status": "healthy",
                             "uptime_s": time.time() - self.started_at,
                             "timestamp": time.time()}
            if method == "GET" and path == "/status":
                payload = {
                    "coordinator": "running",
                    "training": rm.get_training_status(),
                    "system": mc.get_system_summary(),
                }
                if self.grpc_servicer is not None:
                    s = self.grpc_servicer
                    payload["grpc"] = {
                        "current_round": s.current_round,
                        "registered_clients": sorted(s.clients),
                        "pending_updates": len(
                            s.pending_updates.get(s.current_round, {})
                        ),
                        "global_model_round": (
                            s.global_model.round_number
                            if s.global_model else None
                        ),
                    }
                return 200, payload
            if path == "/training/status" and method == "GET":
                return 200, rm.get_training_status()
            if path == "/training/start" and method == "POST":
                rnd = rm.start_round((body or {}).get("client_ids"))
                return 200, {"started": True,
                             "round_number": rnd.round_number,
                             "clients": rnd.selected_clients}
            if path == "/training/stop" and method == "POST":
                rnd = rm.current_round
                if rnd is None:
                    return 409, {"error": "no round in progress"}
                rm._fail_round(rnd, "stopped by operator")
                return 200, {"stopped": True, "round_number": rnd.round_number}
            if path == "/training/rounds" and method == "GET":
                return 200, {"rounds": rm.get_round_history()}

            if parts[:1] == ["clients"]:
                if len(parts) == 1 and method == "GET":
                    return 200, {"clients": {
                        cid: {k: v for k, v in info.items()
                              if isinstance(v, (int, float, str, bool))}
                        for cid, info in rm.registered_clients.items()
                    }}
                cid = parts[1]
                if len(parts) == 2 and method == "GET":
                    if cid not in rm.registered_clients:
                        return 404, {"error": f"unknown client {cid}"}
                    return 200, {"client_id": cid,
                                 **{k: v for k, v in
                                    rm.registered_clients[cid].items()
                                    if isinstance(v, (int, float, str, bool))},
                                 "health": fh.tracker.get_health(cid)}
                if parts[2] == "health" and method == "GET":
                    return 200, fh.tracker.get_health(cid)
                if parts[2] == "exclude" and method == "POST":
                    fh.exclude_client(
                        cid, permanent=bool((body or {}).get("permanent"))
                    )
                    return 200, {"excluded": cid}
                if parts[2] == "include" and method == "POST":
                    fh.include_client(cid)
                    return 200, {"included": cid}

            if path == "/metrics/prometheus" and method == "GET":
                # Prometheus exposition format (the reference configured a
                # 9090 metrics port but shipped no exporter — SURVEY.md §5.1)
                return 200, {"__raw_text__": self._prometheus_text()}
            if path == "/metrics" and method == "GET":
                return 200, mc.get_training_progress()
            if path == "/metrics/system" and method == "GET":
                return 200, mc.get_system_summary()
            if path == "/metrics/training" and method == "GET":
                return 200, mc.get_training_progress()
            if path == "/metrics/clients" and method == "GET":
                return 200, mc.get_client_summary()
            if path == "/metrics/export" and method == "POST":
                out = (body or {}).get("path", os.path.join(
                    tempfile.gettempdir(), "fl_tpu_metrics.json"))
                mc.export_json(out)
                return 200, {"exported": out}

            if path == "/config" and method == "GET":
                return 200, dataclasses.asdict(rm.round_config)
            if path == "/config/privacy" and method == "GET":
                pc = rm.round_config.privacy_config
                return 200, (dataclasses.asdict(pc) if pc
                             else {"privacy": "disabled"})
            if path == "/config/privacy" and method == "POST":
                try:
                    pc = PrivacyConfig(**(body or {}))
                except (TypeError, ValueError) as e:
                    return 400, {"error": str(e)}
                rm.round_config = dataclasses.replace(
                    rm.round_config, privacy_config=pc
                )
                return 200, dataclasses.asdict(pc)

            if path == "/failures" and method == "GET":
                return 200, {"failures": [
                    {"client_id": f.client_id,
                     "type": f.failure_type.value,
                     "action": f.action_taken.value if f.action_taken else None,
                     "round": f.round_number,
                     "timestamp": f.timestamp}
                    for f in fh.failure_log[-50:]
                ]}
            if path == "/failures/statistics" and method == "GET":
                return 200, fh.get_failure_statistics()

            if path == "/admin/reset" and method == "POST":
                rm.round_history.clear()
                rm.round_counter = 0
                rm.global_model = None
                rm.detector.reset()
                return 200, {"reset": True}
            if path == "/admin/logs" and method == "GET":
                return 200, {"logs": list(_RECENT_LOGS)[-100:]}

            return 404, {"error": f"no route {method} {path}"}
        except Exception as e:
            logger.exception("REST handler error")
            return 500, {"error": str(e)}

    def _prometheus_text(self) -> str:
        """Render coordinator metrics in Prometheus exposition format."""
        rm, mc = self.round_manager, self.metrics
        status = rm.get_training_status()
        sysm = mc.get_system_summary()
        prog = mc.get_training_progress()
        lines = [
            "# TYPE fl_current_round gauge",
            f"fl_current_round {status['current_round']}",
            "# TYPE fl_registered_clients gauge",
            f"fl_registered_clients {status['registered_clients']}",
            "# TYPE fl_completed_rounds counter",
            f"fl_completed_rounds {status['completed_rounds']}",
            "# TYPE fl_failed_rounds counter",
            f"fl_failed_rounds {status['failed_rounds']}",
            "# TYPE fl_global_accuracy gauge",
            f"fl_global_accuracy {status['global_accuracy']}",
            "# TYPE fl_convergence_score gauge",
            f"fl_convergence_score {status['convergence_score']}",
            "# TYPE fl_avg_round_time_seconds gauge",
            f"fl_avg_round_time_seconds {status['avg_round_time']}",
        ]
        if prog.get("rounds_completed"):
            lines += [
                "# TYPE fl_latest_loss gauge",
                f"fl_latest_loss {prog['latest_loss']}",
            ]
        if sysm:
            lines += [
                "# TYPE fl_cpu_percent gauge",
                f"fl_cpu_percent {sysm.get('cpu_percent', 0)}",
                "# TYPE fl_memory_percent gauge",
                f"fl_memory_percent {sysm.get('memory_percent', 0)}",
            ]
        return "\n".join(lines) + "\n"

    # -- server lifecycle (ref: start_server/_run_server,
    #    rest_api.py:106-147 — Flask in a daemon thread) --------------------
    def start_server(self) -> int:
        api = self

        class Handler(BaseHTTPRequestHandler):
            def _respond(self, method: str) -> None:
                length = int(self.headers.get("Content-Length") or 0)
                body = None
                if length:
                    try:
                        body = json.loads(self.rfile.read(length) or b"{}")
                    except json.JSONDecodeError:
                        self._write(400, {"error": "invalid JSON body"})
                        return
                path = urlparse(self.path).path.rstrip("/") or "/"
                code, payload = api.handle(method, path, body)
                self._write(code, payload)

            def _write(self, code: int, payload: Dict[str, Any]) -> None:
                if "__raw_text__" in payload:  # prometheus exposition
                    data = payload["__raw_text__"].encode()
                    self.send_response(code)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                data = json.dumps(payload, default=str).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Access-Control-Allow-Origin", "*")  # CORS
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802
                self._respond("GET")

            def do_POST(self):  # noqa: N802
                self._respond("POST")

            def log_message(self, fmt, *args):  # quiet access log
                logger.debug("REST %s", fmt % args)

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="fl-rest")
        self._thread.start()
        logger.info("REST management API on %s:%d", self.host, self.port)
        return self.port

    def stop_server(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
