"""``fl-coordinator`` command line (port of
``fl_tpu.services.coordinator_main``).

Parity target: src/coordinator/main.py: CLI (--config), YAML load, logging
setup, optional DB init via DATABASE_URL, starting RoundManager +
MetricsTracker + FailureHandler + gRPC + REST, idle loop, SIGINT/SIGTERM
shutdown in reverse start order (ref: CoordinatorService, main.py:64-172).
``--device`` picks where the servicer aggregates (the card by default):

    python -m fl_tpu_torch.services.coordinator_main --config coordinator.yaml
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


class CoordinatorService:
    """ref: CoordinatorService, coordinator/main.py:64-172."""

    def __init__(self, config: Dict[str, Any], device=None):
        """``device``: where the servicer and the round manager aggregate
        and the initial model is drawn; None is the card."""
        self.config = config
        self.device = device
        self._stop = threading.Event()
        self.grpc_server = None
        self.rest_api = None
        self.round_manager = None
        self.metrics_tracker = None
        self.failure_handler = None
        self.database = None

    def start(self) -> None:
        from fl_tpu_torch.orchestration.failure import FailureHandler
        from fl_tpu_torch.orchestration.metrics import MetricsTracker
        from fl_tpu_torch.orchestration.round_manager import RoundManager
        from fl_tpu_torch.services.config import round_config_from
        from fl_tpu_torch.services.grpc_server import (
            CoordinatorGRPCServer,
            FederatedLearningServicer,
        )
        from fl_tpu_torch.services.rest_api import CoordinatorAPI

        cfg = self.config
        round_config = round_config_from(cfg)
        server_cfg = cfg.get("server", {})
        training_cfg = cfg.get("training", {})

        # optional persistence (ref: main.py:107-110, plus the restart
        # resume the reference designed but never wired):
        # storage.model_dir enables full weight persistence + restart
        # resume; storage.database_url alone keeps the reference's
        # metadata-only DB behavior (no weights written to disk)
        storage_cfg = cfg.get("storage", {})
        db_url = storage_cfg.get("database_url")
        model_dir = storage_cfg.get("model_dir")
        persistence = None
        if model_dir:
            from fl_tpu_torch.services.persistence import CoordinatorPersistence

            persistence = CoordinatorPersistence(model_dir,
                                                 database_url=db_url)
            self.database = persistence.repository.db
        elif db_url:
            from fl_tpu_torch.services.database import create_database_manager

            self.database = create_database_manager(db_url)
            self.database.create_tables()

        self.round_manager = RoundManager(
            round_config=round_config,
            auto_start=bool(training_cfg.get("auto_start", False)),
            device=self.device,
        )
        self.round_manager.start()

        self.metrics_tracker = MetricsTracker()
        self.metrics_tracker.start()

        self.failure_handler = FailureHandler()

        aggregator = None
        agg_method = training_cfg.get("aggregation", "fedavg")
        if agg_method != "fedavg":
            # Byzantine-robust aggregation on the wire path (capability
            # extension; the rules are shift-equivariant so they apply
            # to the full weight dicts reference clients submit)
            from fl_tpu_torch.fl.robust_agg import RobustAggregator

            aggregator = RobustAggregator(
                method=agg_method,
                trim_k=int(training_cfg.get("trim_k", 1)),
                krum_f=int(training_cfg.get("krum_f", 1)),
                krum_m=int(training_cfg.get("krum_m", 1)),
                min_clients=int(training_cfg.get("min_clients", 2)),
                device=self.device,
            )
        security_cfg = self.config.get("security", {})
        servicer = FederatedLearningServicer(
            round_config=round_config,
            model_name=training_cfg.get("model", "simple_cnn"),
            persistence=persistence,
            aggregator=aggregator,
            secure_aggregation=bool(
                security_cfg.get("secure_aggregation", False)),
            distributed_dp=bool(security_cfg.get("distributed_dp", False)),
            ddp_bits=int(security_cfg.get("ddp_bits", 14)),
            device=self.device,
        )
        self.grpc_server = CoordinatorGRPCServer(
            servicer,
            host=server_cfg.get("host", "0.0.0.0"),
            port=int(server_cfg.get("grpc_port", 50051)),
            tls_cert_path=server_cfg.get("tls_cert"),
            tls_key_path=server_cfg.get("tls_key"),
            tls_client_ca_path=server_cfg.get("tls_client_ca"),
        )
        self.grpc_server.start()

        self.rest_api = CoordinatorAPI(
            round_manager=self.round_manager,
            metrics=self.metrics_tracker.collector,
            failure_handler=self.failure_handler,
            host=server_cfg.get("host", "0.0.0.0"),
            port=int(server_cfg.get("http_port", 8080)),
            grpc_servicer=servicer,
        )
        self.rest_api.start_server()
        logger.info("coordinator up: gRPC :%d, REST :%d",
                    self.grpc_server.port, self.rest_api.port)

    def wait(self) -> None:
        """Idle until stopped (ref: main.py:143-144)."""
        self._stop.wait()

    def stop(self) -> None:
        """Reverse-order shutdown (ref: main.py:152-172)."""
        logger.info("coordinator shutting down")
        if self.rest_api is not None:
            self.rest_api.stop_server()
        if self.grpc_server is not None:
            self.grpc_server.stop()
        if self.metrics_tracker is not None:
            self.metrics_tracker.stop()
        if self.round_manager is not None:
            self.round_manager.stop()
        if self.database is not None:
            self.database.close()
        self._stop.set()


def main(argv: Optional[list] = None) -> int:
    """ref: main, coordinator/main.py:174-210."""
    from fl_tpu_torch.services.config import (
        DEFAULT_COORDINATOR_CONFIG,
        apply_env_overrides,
        load_config,
    )

    parser = argparse.ArgumentParser(prog="fl-coordinator",
                                     description="federated learning "
                                                 "coordinator")
    parser.add_argument("--config", default=None, help="YAML config path")
    parser.add_argument("--log-level", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device to aggregate on (default: the "
                             "card)")
    args = parser.parse_args(argv)

    config = load_config(args.config, DEFAULT_COORDINATOR_CONFIG)
    config = apply_env_overrides(config, "coordinator")
    level = args.log_level or config.get("logging", {}).get("level", "INFO")

    from fl_tpu_torch.utils.logging_config import setup_logging

    setup_logging(level=level,
                  log_file=config.get("logging", {}).get("file"),
                  service_name="coordinator")

    service = CoordinatorService(config, device=args.device)

    def _signal(signum, frame):
        del signum, frame
        service.stop()

    signal.signal(signal.SIGINT, _signal)
    signal.signal(signal.SIGTERM, _signal)

    service.start()
    try:
        service.wait()
    except KeyboardInterrupt:
        service.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
