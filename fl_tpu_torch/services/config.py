"""YAML configuration with environment overrides (port of
``fl_tpu.services.config``).

Parity target: the reference's config surface — config/coordinator.yaml and
config/client.yaml (same schema honored here), ``load_config``
(src/coordinator/main.py:33-44, src/client/main.py:28-41) and the env-var
overrides CLIENT_ID / COORDINATOR_HOST / COORDINATOR_PORT / DATABASE_URL
(src/client/main.py:69-99, src/coordinator/main.py:107).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

from fl_tpu_torch.core.types import PrivacyConfig, RoundConfig
from fl_tpu_torch.fl.local_training import FederatedTrainingConfig

logger = logging.getLogger(__name__)

DEFAULT_COORDINATOR_CONFIG: Dict[str, Any] = {
    "server": {"grpc_port": 50051, "http_port": 8080, "metrics_port": 9090,
               "host": "0.0.0.0"},
    "training": {"min_clients": 2, "max_clients": 50, "round_timeout": 300,
                 "local_epochs": 5, "batch_size": 32, "learning_rate": 0.001,
                 "optimizer": "adam", "model": "simple_cnn",
                 "dataset": "mnist", "auto_start": False},
    "privacy": {"enabled": True, "epsilon": 1.0, "delta": 1.0e-5,
                "max_grad_norm": 1.0, "noise_multiplier": 1.0},
    # secure_aggregation: Bonawitz masked uploads (secagg_wire);
    # distributed_dp additionally makes clients ship Skellam-noised
    # INTEGER deltas, so only the modular sum is ever decodable — both
    # sides must agree on these knobs AND the privacy section
    "security": {"secure_aggregation": False, "distributed_dp": False,
                 "ddp_bits": 14},
    "storage": {"checkpoint_dir": "checkpoints", "database_url": None},
    "logging": {"level": "INFO", "file": None},
}

DEFAULT_CLIENT_CONFIG: Dict[str, Any] = {
    "client": {"id": None, "coordinator_host": "localhost",
               "coordinator_port": 50051},
    "model": {"name": "simple_cnn", "dataset": "mnist"},
    "training": {"local_epochs": 5, "batch_size": 32,
                 "learning_rate": 0.001, "optimizer": "adam",
                 "validation_split": 0.1},
    "privacy": {"enabled": True, "epsilon": 1.0, "delta": 1.0e-5,
                "max_grad_norm": 1.0, "noise_multiplier": 1.0},
    "security": {"secure_aggregation": False, "distributed_dp": False,
                 "ddp_bits": 14},
    "compression": {"algorithm": "zlib"},
    "data": {"partition_strategy": "non_iid", "num_clients": 100,
             "alpha": 0.5},
    "checkpoints": {"enabled": True, "every_rounds": 5,
                    "dir": "client_checkpoints"},
}


def _deep_merge(base: Dict[str, Any], override: Dict[str, Any]
                ) -> Dict[str, Any]:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: Optional[str] = None,
                defaults: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Load a YAML config merged over defaults (ref: load_config,
    coordinator/main.py:33-44)."""
    cfg = dict(defaults or {})
    if path:
        import yaml

        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        cfg = _deep_merge(cfg, loaded)
    return cfg


def apply_env_overrides(cfg: Dict[str, Any], role: str) -> Dict[str, Any]:
    """Deployment env overrides (ref: client/main.py:69-99,
    coordinator/main.py:107)."""
    cfg = dict(cfg)
    if role == "client":
        client = dict(cfg.get("client", {}))
        if os.environ.get("CLIENT_ID"):
            client["id"] = os.environ["CLIENT_ID"]
        if os.environ.get("COORDINATOR_HOST"):
            client["coordinator_host"] = os.environ["COORDINATOR_HOST"]
        if os.environ.get("COORDINATOR_PORT"):
            client["coordinator_port"] = int(os.environ["COORDINATOR_PORT"])
        cfg["client"] = client
    else:
        storage = dict(cfg.get("storage", {}))
        if os.environ.get("DATABASE_URL"):
            storage["database_url"] = os.environ["DATABASE_URL"]
        cfg["storage"] = storage
    return cfg


def round_config_from(cfg: Dict[str, Any]) -> RoundConfig:
    t = cfg.get("training", {})
    p = cfg.get("privacy", {})
    privacy = None
    if p.get("enabled", True) and p.get("epsilon"):
        privacy = PrivacyConfig(
            epsilon=float(p.get("epsilon", 1.0)),
            delta=float(p.get("delta", 1e-5)),
            max_grad_norm=float(p.get("max_grad_norm", 1.0)),
            noise_multiplier=float(p.get("noise_multiplier", 1.0)),
        )
    return RoundConfig(
        min_clients=int(t.get("min_clients", 2)),
        max_clients=int(t.get("max_clients", 50)),
        local_epochs=int(t.get("local_epochs", 5)),
        batch_size=int(t.get("batch_size", 32)),
        learning_rate=float(t.get("learning_rate", 0.001)),
        timeout_seconds=int(t.get("round_timeout", 300)),
        optimizer_type=t.get("optimizer", "adam"),
        privacy_config=privacy,
    )


def training_config_from(cfg: Dict[str, Any]) -> FederatedTrainingConfig:
    t = cfg.get("training", {})
    return FederatedTrainingConfig(
        local_epochs=int(t.get("local_epochs", 5)),
        batch_size=int(t.get("batch_size", 32)),
        learning_rate=float(t.get("learning_rate", 0.001)),
        optimizer_type=t.get("optimizer", "adam"),
        validation_split=float(t.get("validation_split", 0.1)),
    )
