"""``fl-client`` command line (port of ``fl_tpu.services.client_main``).

Parity target: src/client/main.py: CLI (--config, --client-id), env
overrides CLIENT_ID / COORDINATOR_HOST / COORDINATOR_PORT (ref :69-99),
trainer construction via the factory, blocking run with status polling
(ref: ClientService, main.py:59-155; main :157-199). ``--device`` picks
where the client trains (the card by default):

    python -m fl_tpu_torch.services.client_main --config client.yaml
"""

from __future__ import annotations

import argparse
import logging
import signal
import uuid
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


class ClientService:
    """ref: ClientService, client/main.py:59-155."""

    def __init__(self, config: Dict[str, Any], device=None):
        """``device``: where the trainer trains and releases; None is the
        card."""
        self.config = config
        self.device = device
        self.trainer = None

    def start(self) -> None:
        from fl_tpu_torch.core.types import PrivacyConfig
        from fl_tpu_torch.services.federated_trainer import (
            create_federated_trainer,
        )

        cfg = self.config
        client_cfg = cfg.get("client", {})
        model_cfg = cfg.get("model", {})
        privacy_cfg = cfg.get("privacy", {})
        data_cfg = cfg.get("data", {})

        client_id = client_cfg.get("id") or f"client_{uuid.uuid4().hex[:8]}"
        privacy = None
        if privacy_cfg.get("enabled", True) and privacy_cfg.get("epsilon"):
            privacy = PrivacyConfig(
                epsilon=float(privacy_cfg.get("epsilon", 1.0)),
                delta=float(privacy_cfg.get("delta", 1e-5)),
                max_grad_norm=float(privacy_cfg.get("max_grad_norm", 1.0)),
                noise_multiplier=float(
                    privacy_cfg.get("noise_multiplier", 1.0)),
            )

        self.trainer = create_federated_trainer(
            client_id=client_id,
            coordinator_host=client_cfg.get("coordinator_host", "localhost"),
            coordinator_port=int(client_cfg.get("coordinator_port", 50051)),
            dataset=model_cfg.get("dataset", "mnist"),
            model_name=model_cfg.get("name"),
            privacy=privacy,
            epsilon_per_round=privacy_cfg.get("epsilon_per_round"),
            compression_algorithm=cfg.get("compression", {}).get(
                "algorithm", "zlib"),
            num_clients=int(data_cfg.get("num_clients", 100)),
            partition_strategy=data_cfg.get("partition_strategy", "non_iid"),
            tls_root_cert_path=client_cfg.get("tls_root_cert"),
            tls_cert_path=client_cfg.get("tls_cert"),
            tls_key_path=client_cfg.get("tls_key"),
            secure_aggregation=bool(
                cfg.get("security", {}).get("secure_aggregation", False)),
            distributed_dp=bool(
                cfg.get("security", {}).get("distributed_dp", False)),
            ddp_bits=int(cfg.get("security", {}).get("ddp_bits", 14)),
            # client-held secret file keying the DP noise streams; default
            # under the checkpoint dir so a restarted client reproduces its
            # own noise (nobody else can: the file is 0600 local state)
            dp_secret_path=privacy_cfg.get(
                "dp_secret_path",
                cfg.get("checkpointing", {}).get("dp_secret_path")),
            device=self.device,
        )
        logger.info("client %s starting against %s:%s", client_id,
                    client_cfg.get("coordinator_host", "localhost"),
                    client_cfg.get("coordinator_port", 50051))
        self.trainer.initialize()
        self.trainer.run_forever()

    def stop(self) -> None:
        if self.trainer is not None:
            self.trainer.stop_training()


def main(argv: Optional[list] = None) -> int:
    """ref: main, client/main.py:157-199."""
    from fl_tpu_torch.services.config import (
        DEFAULT_CLIENT_CONFIG,
        apply_env_overrides,
        load_config,
    )

    parser = argparse.ArgumentParser(prog="fl-client",
                                     description="federated learning "
                                                 "client")
    parser.add_argument("--config", default=None, help="YAML config path")
    parser.add_argument("--client-id", default=None)
    parser.add_argument("--log-level", default="INFO")
    parser.add_argument("--device", default=None,
                        help="torch device to train on (default: the card)")
    args = parser.parse_args(argv)

    config = load_config(args.config, DEFAULT_CLIENT_CONFIG)
    config = apply_env_overrides(config, "client")
    if args.client_id:
        config.setdefault("client", {})["id"] = args.client_id

    from fl_tpu_torch.utils.logging_config import setup_logging

    setup_logging(level=args.log_level, service_name="client")

    service = ClientService(config, device=args.device)

    def _signal(signum, frame):
        del signum, frame
        service.stop()

    signal.signal(signal.SIGINT, _signal)
    signal.signal(signal.SIGTERM, _signal)

    service.start()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
