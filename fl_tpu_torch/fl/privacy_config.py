"""Privacy configuration management: presets, optimization, analysis.

A copy of ``fl_tpu.fl.privacy_config`` on the port's
:class:`fl_tpu_torch.core.types.PrivacyConfig`.

Parity target: src/shared/privacy_config.py — PrivacyLevel presets
HIGH(ε=0.5, δ=1e-6, C=0.5, z=2.0) / MEDIUM(1.0, 1e-5, 1.0, 1.0) /
LOW(3.0, 1e-4, 2.0, 0.5) (ref :44-63), ``optimize_for_accuracy`` scaling ε
by dataset size / model complexity / 1/√rounds (ref :126-205),
ε-sweep privacy-utility analysis (ref :207-281), validation (ref :283-353),
and YAML/JSON save/load (ref :355-417), plus the module-level helpers
(ref :503-599).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import logging
import math
from pathlib import Path
from typing import Any, Dict, List, Optional

from fl_tpu_torch.core.types import PrivacyConfig

logger = logging.getLogger(__name__)


class PrivacyLevel(enum.Enum):
    """ref: PrivacyLevel, privacy_config.py:21-26."""

    HIGH = "high"
    MEDIUM = "medium"
    LOW = "low"
    CUSTOM = "custom"


# ref: PRIVACY_PRESETS, privacy_config.py:44-63
PRIVACY_PRESETS: Dict[PrivacyLevel, Dict[str, float]] = {
    PrivacyLevel.HIGH: {
        "epsilon": 0.5, "delta": 1e-6,
        "max_grad_norm": 0.5, "noise_multiplier": 2.0,
    },
    PrivacyLevel.MEDIUM: {
        "epsilon": 1.0, "delta": 1e-5,
        "max_grad_norm": 1.0, "noise_multiplier": 1.0,
    },
    PrivacyLevel.LOW: {
        "epsilon": 3.0, "delta": 1e-4,
        "max_grad_norm": 2.0, "noise_multiplier": 0.5,
    },
}


class PrivacyConfigManager:
    """ref: PrivacyConfigManager, privacy_config.py:40-501."""

    PRIVACY_PRESETS = PRIVACY_PRESETS

    def __init__(self, config_file: Optional[str] = None):
        self.config_file = config_file
        self.current_config: Optional[PrivacyConfig] = None
        self.config_history: List[Dict[str, Any]] = []
        if config_file and Path(config_file).exists():
            self.current_config = self.load_config(config_file)

    # -- creation (ref: create_config :79-124) -------------------------------
    def create_config(self, level: PrivacyLevel = PrivacyLevel.MEDIUM,
                      **overrides: float) -> PrivacyConfig:
        if level == PrivacyLevel.CUSTOM:
            params = dict(overrides)
        else:
            params = dict(PRIVACY_PRESETS[level])
            params.update(overrides)
        cfg = PrivacyConfig(**params)
        self.current_config = cfg
        self.config_history.append({
            "level": level.value, **dataclasses.asdict(cfg)
        })
        return cfg

    # -- accuracy-targeted optimization (ref: optimize_for_accuracy :126-205) --
    def optimize_for_accuracy(
        self,
        target_accuracy: float,
        dataset_size: int,
        model_complexity: str = "medium",  # "simple" | "medium" | "complex"
        num_rounds: int = 10,
    ) -> PrivacyConfig:
        """Scale ε with dataset size and model complexity, divide by √rounds
        for composition headroom — the reference's heuristic."""
        if target_accuracy >= 0.95:
            base_eps = 3.0
        elif target_accuracy >= 0.90:
            base_eps = 1.5
        elif target_accuracy >= 0.85:
            base_eps = 1.0
        else:
            base_eps = 0.5

        if dataset_size > 50_000:
            base_eps *= 0.7  # big data tolerates more noise
        elif dataset_size < 5_000:
            base_eps *= 1.5

        complexity_scale = {"simple": 0.8, "medium": 1.0, "complex": 1.4}
        base_eps *= complexity_scale.get(model_complexity, 1.0)

        epsilon = max(0.1, base_eps / math.sqrt(max(num_rounds, 1)))
        delta = min(1e-4, 1.0 / max(dataset_size, 10))
        cfg = PrivacyConfig(
            epsilon=epsilon, delta=delta,
            max_grad_norm=1.0 if target_accuracy >= 0.9 else 2.0,
            noise_multiplier=1.0,
        )
        self.current_config = cfg
        return cfg

    # -- privacy/utility tradeoff sweep (ref :207-281) ---------------------------
    def analyze_privacy_utility_tradeoff(
        self,
        epsilons: Optional[List[float]] = None,
        delta: float = 1e-5,
        sensitivity: float = 1.0,
    ) -> List[Dict[str, float]]:
        """For each ε: the Gaussian-mechanism σ and a monotone utility
        estimate (1/(1+σ), the reference's shape)."""
        epsilons = epsilons or [0.1, 0.5, 1.0, 2.0, 5.0, 10.0]
        out = []
        for eps in epsilons:
            sigma = sensitivity * math.sqrt(2 * math.log(1.25 / delta)) / eps
            out.append({
                "epsilon": eps,
                "delta": delta,
                "noise_sigma": sigma,
                "estimated_utility": 1.0 / (1.0 + sigma),
                "privacy_strength": ("strong" if eps < 1 else
                                     "moderate" if eps < 5 else "weak"),
            })
        return out

    # -- validation (ref: validate_config :283-353) -------------------------------
    def validate_config(self, cfg: PrivacyConfig) -> Dict[str, Any]:
        issues: List[str] = []
        warnings: List[str] = []
        if cfg.epsilon <= 0:
            issues.append("epsilon must be positive")
        elif cfg.epsilon > 10:
            warnings.append("epsilon > 10 provides weak privacy")
        if not (0 < cfg.delta < 1):
            issues.append("delta must be in (0, 1)")
        elif cfg.delta > 1e-3:
            warnings.append("delta > 1e-3 provides weak privacy")
        if cfg.max_grad_norm <= 0:
            issues.append("max_grad_norm must be positive")
        elif cfg.max_grad_norm > 10:
            warnings.append("large clipping norm weakens the guarantee")
        if cfg.noise_multiplier < 0.5:
            warnings.append("noise_multiplier < 0.5 may be insufficient "
                            "for DP-SGD")
        return {"valid": not issues, "issues": issues, "warnings": warnings}

    # -- persistence (ref: save_config/load_config :355-417) ----------------------
    def save_config(self, cfg: PrivacyConfig, filepath: str) -> None:
        path = Path(filepath)
        payload = dataclasses.asdict(cfg)
        if path.suffix in (".yaml", ".yml"):
            import yaml

            path.write_text(yaml.safe_dump({"privacy": payload}))
        else:
            path.write_text(json.dumps({"privacy": payload}, indent=2))

    def load_config(self, filepath: str) -> PrivacyConfig:
        path = Path(filepath)
        text = path.read_text()
        if path.suffix in (".yaml", ".yml"):
            import yaml

            data = yaml.safe_load(text)
        else:
            data = json.loads(text)
        payload = data.get("privacy", data)
        cfg = PrivacyConfig(**{
            k: payload[k]
            for k in ("epsilon", "delta", "max_grad_norm", "noise_multiplier")
            if k in payload
        })
        self.current_config = cfg
        return cfg


def create_privacy_config_for_dataset(dataset: str,
                                      num_clients: int = 10) -> PrivacyConfig:
    """Dataset-keyed defaults (ref: create_privacy_config_for_dataset,
    privacy_config.py:503-546)."""
    dataset = dataset.lower()
    mgr = PrivacyConfigManager()
    if dataset == "mnist":
        cfg = mgr.create_config(PrivacyLevel.MEDIUM)
    elif dataset == "cifar10":
        # harder task: reference ships CIFAR sims at ε=1.5
        cfg = mgr.create_config(PrivacyLevel.MEDIUM, epsilon=1.5)
    else:
        cfg = mgr.create_config(PrivacyLevel.HIGH)
    if num_clients >= 100:
        # large populations amortize noise; tighten ε
        cfg = dataclasses.replace(cfg, epsilon=cfg.epsilon * 0.8)
    return cfg


def compare_privacy_configs(configs: Dict[str, PrivacyConfig]
                            ) -> Dict[str, Any]:
    """Side-by-side σ/strength table (ref: compare_privacy_configs,
    privacy_config.py:548-599)."""
    rows = {}
    for name, cfg in configs.items():
        sigma = (cfg.max_grad_norm
                 * math.sqrt(2 * math.log(1.25 / cfg.delta)) / cfg.epsilon)
        rows[name] = {
            "epsilon": cfg.epsilon,
            "delta": cfg.delta,
            "max_grad_norm": cfg.max_grad_norm,
            "noise_sigma": sigma,
            "strength": ("strong" if cfg.epsilon < 1 else
                         "moderate" if cfg.epsilon < 5 else "weak"),
        }
    strongest = min(rows, key=lambda n: rows[n]["epsilon"])
    return {"configs": rows, "strongest": strongest}
