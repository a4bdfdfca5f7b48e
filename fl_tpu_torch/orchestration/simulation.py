"""End-to-end federated simulation harness (port of
``fl_tpu.orchestration.simulation``): the README's quick start,

    python -m fl_tpu_torch.orchestration.simulation --clients 5 --rounds 10

Parity target: src/simulation/federated_simulation.py: SimulationConfig
(:29-83: 5 clients, 10 rounds, target accuracy 0.91, ε=1.0),
FederatedLearningSimulation (:194-528) and the run_mnist_simulation /
run_cifar10_simulation entries (:530-599).

The ``onchip`` backend runs every simulated client at once over the
stacked client axis through the port's
:class:`~fl_tpu_torch.orchestration.round_engine.FederatedRoundEngine` on
one device (the card unless the caller asks for the CPU): the reference's
heterogeneity (LOW/MEDIUM/HIGH power, 5-50 Mbps, ref :247-249) maps to
per-client epoch budgets, stragglers and failures to participation-mask
dropout. Under the default ``dp_mode="delta"`` each round's release is the
clip+noise kernel (K3 on a card). The ``grpc`` backend is the reference's
deployment topology (ref :309-318): an in-process coordinator (the gRPC
servicer) and N ``FederatedTrainer`` client threads over localhost, each
client training and releasing on the same device; it needs the
``grpcio`` and ``protobuf`` packages and raises naming them where they are
missing. ``secure_aggregation=True`` masks the uploads over the wire
(``services.secagg_wire``; ``cryptography`` needed), ``distributed_dp=True``
ships Skellam-noised integers through the masked pipeline instead of the
per-client Gaussian release.

Exit criteria match the reference (:362-428): target accuracy reached |
round budget exhausted | wall-clock timeout. ``rounds_per_sec`` in the
results is the reference's formula, rounds over the sum of the rounds'
``round_time_s`` (each round's dispatch to its metrics on the host);
``wall_time_s`` is the whole run's clock, set-up and evaluation included.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np

from fl_tpu_torch.core.types import ComputePowerLevel, PrivacyConfig
from fl_tpu_torch.fl.local_training import (
    FederatedTrainingConfig,
    create_adaptive_config,
)
from fl_tpu_torch.models import get_model_for_dataset
from fl_tpu_torch.orchestration.metrics import MetricsCollector
from fl_tpu_torch.orchestration.round_engine import (
    FederatedRoundEngine,
    RoundEngineConfig,
)

logger = logging.getLogger(__name__)

# capability profiles cycled over clients (ref: setup_clients,
# federated_simulation.py:243-274 — LOW/MED/HIGH power, 5-50 Mbps,
# 500-2000 samples)
CAPABILITY_CYCLE = (
    {"compute_power": ComputePowerLevel.LOW, "network_bandwidth": 5},
    {"compute_power": ComputePowerLevel.MEDIUM, "network_bandwidth": 10},
    {"compute_power": ComputePowerLevel.HIGH, "network_bandwidth": 25},
    {"compute_power": ComputePowerLevel.MEDIUM, "network_bandwidth": 50},
)

GRPC_MISSING = (
    "backend='grpc' runs the coordinator and clients over gRPC and needs "
    "the grpcio and protobuf packages ({missing}); install them or use "
    "backend='onchip'")


def require_grpc() -> None:
    """Raise an ImportError naming grpcio (and protobuf) unless both
    import."""
    missing = []
    for module, package in (("grpc", "grpcio"),
                            ("google.protobuf", "protobuf")):
        try:
            __import__(module)
        except ImportError:
            missing.append(f"{package} is not installed")
    if missing:
        raise ImportError(GRPC_MISSING.format(missing="; ".join(missing)))


@dataclasses.dataclass
class SimulationConfig:
    """ref: SimulationConfig, federated_simulation.py:29-83 (the fields of
    ``fl_tpu.orchestration.simulation.SimulationConfig``)."""

    dataset: str = "mnist"
    num_clients: int = 5
    num_rounds: int = 10
    target_accuracy: float = 0.91
    timeout_s: float = 3600.0
    partition_strategy: str = "non_iid"
    alpha: float = 0.5
    local_epochs: int = 5
    batch_size: int = 32
    learning_rate: float = 0.001
    proximal_mu: float = 0.0  # FedProx (0.0 = plain FedAvg local training)
    privacy_epsilon: Optional[float] = 1.0
    privacy_delta: float = 1e-5
    max_grad_norm: float = 1.0
    dp_mode: str = "delta"  # "none" | "delta" | "dp_sgd" | "client_dp" | "dp_ftrl"
    participation_rate: float = 1.0
    straggler_dropout_rate: float = 0.0
    heterogeneous_clients: bool = True
    seed: int = 0
    backend: str = "onchip"  # "onchip" | "grpc"
    secure_aggregation: bool = False
    distributed_dp: bool = False
    ddp_bits: int = 14
    adaptive_clipping: bool = False
    clip_target_quantile: float = 0.5
    clip_learning_rate: float = 0.2
    clip_count_stddev: float = 0.5
    dp_noise_seed: Optional[int] = None
    n_train_synth: int = 20_000
    n_test_synth: int = 4_000
    samples_per_client: Optional[int] = None
    noise_multiplier: float = 1.0  # z for dp_sgd / client_dp / dp_ftrl
    # passthroughs for engine capabilities beyond the reference surface,
    # merged into RoundEngineConfig / FederatedTrainingConfig
    engine_overrides: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    training_overrides: Dict[str, Any] = dataclasses.field(
        default_factory=dict)


class FederatedLearningSimulation:
    """ref: FederatedLearningSimulation, federated_simulation.py:194-528.
    ``device``: where the engine (onchip) or the coordinator and clients
    (grpc) run; None is the card."""

    def __init__(self, config: Optional[SimulationConfig] = None,
                 device=None):
        self.config = config or SimulationConfig()
        self.device = device
        self.metrics = MetricsCollector()
        self.results: Dict[str, Any] = {}
        self.engine: Optional[FederatedRoundEngine] = None

    def run_simulation(self) -> Dict[str, Any]:
        """ref: run_simulation, federated_simulation.py:362-428."""
        cfg = self.config
        if cfg.backend not in ("onchip", "grpc"):
            raise ValueError(f"backend must be 'onchip' or 'grpc', got "
                             f"{cfg.backend!r}")
        logger.info("simulation: %d clients, %s, backend=%s",
                    cfg.num_clients, cfg.dataset, cfg.backend)
        t0 = time.time()
        results = (self._run_grpc() if cfg.backend == "grpc"
                   else self._run_onchip())
        results["wall_time_s"] = time.time() - t0
        results["config"] = dataclasses.asdict(self.config)
        self.results = results
        return results

    # -- onchip backend ------------------------------------------------------
    def _build_engine(self) -> FederatedRoundEngine:
        from fl_tpu_torch.data import load_dataset, make_federated_arrays

        cfg = self.config
        splits = load_dataset(cfg.dataset, n_train_synth=cfg.n_train_synth,
                              n_test_synth=cfg.n_test_synth, seed=cfg.seed)
        arrays = make_federated_arrays(
            splits, num_clients=cfg.num_clients,
            strategy=cfg.partition_strategy, alpha=cfg.alpha,
            samples_per_client=cfg.samples_per_client, seed=cfg.seed,
        )
        model = get_model_for_dataset(cfg.dataset)
        privacy = None
        if cfg.privacy_epsilon and cfg.dp_mode != "none":
            privacy = PrivacyConfig(
                epsilon=cfg.privacy_epsilon, delta=cfg.privacy_delta,
                max_grad_norm=cfg.max_grad_norm,
                noise_multiplier=cfg.noise_multiplier,
            )
        engine_cfg = RoundEngineConfig(
            training=FederatedTrainingConfig(
                local_epochs=cfg.local_epochs, batch_size=cfg.batch_size,
                learning_rate=cfg.learning_rate,
                proximal_mu=cfg.proximal_mu,
                **cfg.training_overrides,
            ),
            dp_mode=cfg.dp_mode if privacy else "none",
            privacy=privacy,
            epsilon_per_round=(cfg.privacy_epsilon / max(cfg.num_rounds, 1)
                               if privacy else None),
            delta_per_round=(cfg.privacy_delta / max(cfg.num_rounds, 1)
                             if privacy else None),
            participation_rate=cfg.participation_rate,
            straggler_dropout_rate=cfg.straggler_dropout_rate,
            max_clients=cfg.num_clients,
            seed=cfg.seed,
            secure_aggregation=cfg.secure_aggregation,
            **cfg.engine_overrides,
        )
        augment = None
        if cfg.dataset == "cifar10":
            from fl_tpu_torch.ops.preprocess import make_cifar_augment

            augment = make_cifar_augment()
        x, y = splits.normalized(splits.test_images), splits.test_labels
        engine = FederatedRoundEngine(
            model, arrays, engine_cfg, device=self.device,
            test_images=x, test_labels=y, augment_fn=augment,
        )
        if cfg.heterogeneous_clients:
            engine.epochs_per_client = capability_budgets(
                arrays.num_samples, cfg.local_epochs)
        return engine

    def _run_onchip(self) -> Dict[str, Any]:
        cfg = self.config
        engine = self.engine = self._build_engine()
        deadline = time.time() + cfg.timeout_s
        reason = "round_budget_exhausted"
        for _ in range(cfg.num_rounds):
            if time.time() > deadline:
                reason = "timeout"
                break
            self.metrics.start_round(engine.round_number)
            result = engine.run_round()
            self.metrics.complete_round(
                result.round_number, result.train_loss,
                result.test_accuracy or result.train_accuracy,
                result.convergence_score,
                aggregation_time_s=result.round_time_s,
            )
            logger.info("round %d: acc=%.4f loss=%.4f (%.2fs)",
                        result.round_number,
                        result.test_accuracy or -1, result.train_loss,
                        result.round_time_s)
            if (result.test_accuracy is not None
                    and result.test_accuracy >= cfg.target_accuracy):
                reason = "target_accuracy_reached"
                break
        return self._collect_results(engine, reason)

    def _collect_results(self, engine: FederatedRoundEngine,
                         reason: str) -> Dict[str, Any]:
        """ref: _collect_results, federated_simulation.py:430-528."""
        hist = engine.history
        accs = [r.test_accuracy for r in hist if r.test_accuracy is not None]
        return {
            "backend": "onchip",
            "stop_reason": reason,
            "rounds_completed": len(hist),
            "final_accuracy": accs[-1] if accs else None,
            "best_accuracy": max(accs) if accs else None,
            "final_loss": hist[-1].train_loss if hist else None,
            "avg_round_time_s": float(np.mean([r.round_time_s
                                               for r in hist])) if hist else 0,
            "rounds_per_sec": (len(hist) / sum(r.round_time_s for r in hist)
                               if hist else 0.0),
            "total_epsilon_spent": sum(r.epsilon_spent for r in hist),
            "privacy_budget": (engine.budget_tracker.get_budget_status()
                               if engine.budget_tracker else None),
            "convergence": engine.detector.get_convergence_summary(),
            "round_history": [dataclasses.asdict(r) for r in hist],
            "training_progress": self.metrics.get_training_progress(),
        }

    # -- grpc backend (the reference's deployment topology) -------------------
    def _run_grpc(self) -> Dict[str, Any]:
        """ref: _run_grpc, fl_tpu/orchestration/simulation.py:262-360."""
        require_grpc()
        from fl_tpu_torch.core.types import RoundConfig
        from fl_tpu_torch.services.federated_trainer import FederatedTrainer
        from fl_tpu_torch.services.grpc_server import (
            CoordinatorGRPCServer,
            FederatedLearningServicer,
        )

        cfg = self.config
        privacy = (PrivacyConfig(cfg.privacy_epsilon, cfg.privacy_delta,
                                 cfg.max_grad_norm,
                                 noise_multiplier=cfg.noise_multiplier)
                   if cfg.privacy_epsilon
                   and (cfg.dp_mode != "none" or cfg.distributed_dp)
                   else None)
        servicer = FederatedLearningServicer(
            round_config=RoundConfig(
                min_clients=(cfg.num_clients if cfg.secure_aggregation
                             else min(2, cfg.num_clients)),
                max_clients=cfg.num_clients,
                local_epochs=cfg.local_epochs, batch_size=cfg.batch_size,
                learning_rate=cfg.learning_rate, privacy_config=privacy,
            ),
            secure_aggregation=cfg.secure_aggregation,
            distributed_dp=cfg.distributed_dp,
            ddp_bits=cfg.ddp_bits,
            adaptive_clipping=cfg.adaptive_clipping,
            clip_target_quantile=cfg.clip_target_quantile,
            clip_learning_rate=cfg.clip_learning_rate,
            clip_count_stddev=cfg.clip_count_stddev,
            # cooperative local clients: give stragglers half the round
            # timeout before declaring dropouts
            secagg_grace_s=max(30.0, cfg.timeout_s / 2),
            device=self.device,
        )
        server = CoordinatorGRPCServer(servicer, host="127.0.0.1", port=0)
        port = server.start()
        clients: List[FederatedTrainer] = []
        try:
            for i in range(cfg.num_clients):
                t = FederatedTrainer(
                    client_id=f"sim_{i}", coordinator_host="127.0.0.1",
                    coordinator_port=port, dataset=cfg.dataset,
                    privacy=privacy,
                    epsilon_per_round=(cfg.privacy_epsilon
                                       / max(cfg.num_rounds, 1)
                                       if privacy else None),
                    delta_per_round=(cfg.privacy_delta
                                     / max(cfg.num_rounds, 1)
                                     if privacy else None),
                    client_index=i, num_clients=cfg.num_clients,
                    partition_strategy=cfg.partition_strategy,
                    poll_interval_s=0.5, max_rounds=cfg.num_rounds,
                    data_seed=cfg.seed,
                    n_train_synth=cfg.n_train_synth,
                    n_test_synth=cfg.n_test_synth,
                    secure_aggregation=cfg.secure_aggregation,
                    distributed_dp=cfg.distributed_dp,
                    ddp_bits=cfg.ddp_bits,
                    adaptive_clipping=cfg.adaptive_clipping,
                    clip_count_stddev=cfg.clip_count_stddev,
                    dp_noise_secret=(
                        hashlib.sha256(
                            f"{cfg.dp_noise_seed}:{i}".encode()).digest()
                        if cfg.dp_noise_seed is not None else None),
                    device=self.device,
                )
                t.initialize()
                t.start_training()
                clients.append(t)
            deadline = time.time() + cfg.timeout_s
            reason = "round_budget_exhausted"
            while time.time() < deadline:
                if all(c.rounds_completed >= cfg.num_rounds for c in clients):
                    break
                if servicer.global_model is not None:
                    gm = servicer.global_model
                    acc = gm.get_accuracy()
                    if acc is None:
                        acc = gm.get_accuracy("train")
                    if acc is not None and acc >= cfg.target_accuracy:
                        reason = "target_accuracy_reached"
                        break
                time.sleep(0.5)
            else:
                reason = "timeout"
            # clients count a round done at upload; the servicer's
            # aggregation thread may still be averaging the final round:
            # drain it so current_round / global_model reflect every
            # submitted update
            while (servicer.current_round < cfg.num_rounds
                   and (servicer._aggregating
                        or any(servicer.pending_updates.values()))
                   and time.time() < deadline):
                time.sleep(0.5)
            gm = servicer.global_model
            return {
                "backend": "grpc",
                "stop_reason": reason,
                "rounds_completed": servicer.current_round,
                "final_accuracy": (
                    gm.get_accuracy() if gm is not None
                    and gm.get_accuracy() is not None
                    else gm.get_accuracy("train") if gm is not None
                    else None),
                "client_results": {c.client_id: c.get_status()
                                   for c in clients},
                # wire adaptive clipping: the coordinator's clip-norm
                # trajectory (one entry per aggregation that saw
                # indicators)
                "clip_norm_history": [
                    v for _, v in
                    servicer.metrics_history.get("clip_norm", [])],
            }
        finally:
            for c in clients:
                c.stop_training()
            server.stop()

    def export_results(self, filepath: str) -> None:
        """ref: export at federated_simulation.py:518-528."""
        with open(filepath, "w") as f:
            json.dump(self.results, f, indent=2, default=str)


def capability_budgets(num_samples, local_epochs: int) -> np.ndarray:
    """Client i's epoch budget: the adaptive config of capability profile
    i mod 4 (:data:`CAPABILITY_CYCLE`) at its sample count, capped at
    ``local_epochs`` (the stacked-axis analog of the reference's adaptive
    configs)."""
    budgets = []
    for i, n in enumerate(np.asarray(num_samples)):
        profile = CAPABILITY_CYCLE[i % len(CAPABILITY_CYCLE)]
        adaptive = create_adaptive_config({
            "compute_power": profile["compute_power"].value,
            "network_bandwidth": profile["network_bandwidth"],
            "available_samples": int(n),
        })
        budgets.append(min(adaptive.local_epochs, local_epochs))
    return np.asarray(budgets, np.int32)


def run_mnist_simulation(num_clients: int = 5, num_rounds: int = 10,
                         target_accuracy: float = 0.91, device=None,
                         **kwargs: Any) -> Dict[str, Any]:
    """ref: run_mnist_simulation, federated_simulation.py:530-556."""
    cfg = SimulationConfig(dataset="mnist", num_clients=num_clients,
                           num_rounds=num_rounds,
                           target_accuracy=target_accuracy, **kwargs)
    return FederatedLearningSimulation(cfg, device=device).run_simulation()


def run_cifar10_simulation(num_clients: int = 5, num_rounds: int = 15,
                           target_accuracy: float = 0.85, device=None,
                           **kwargs: Any) -> Dict[str, Any]:
    """ref: run_cifar10_simulation, federated_simulation.py:558-599
    (ε=1.5 default for CIFAR, ref :576-579)."""
    kwargs.setdefault("privacy_epsilon", 1.5)
    cfg = SimulationConfig(dataset="cifar10", num_clients=num_clients,
                           num_rounds=num_rounds,
                           target_accuracy=target_accuracy, **kwargs)
    return FederatedLearningSimulation(cfg, device=device).run_simulation()


def main(argv=None) -> Dict[str, Any]:
    """The command line: one simulation, its summary printed as JSON."""
    import argparse

    p = argparse.ArgumentParser(description="federated learning simulation")
    p.add_argument("--dataset", default="mnist", choices=["mnist", "cifar10"])
    p.add_argument("--clients", type=int, default=5)
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--target-accuracy", type=float, default=0.91)
    p.add_argument("--backend", default="onchip", choices=["onchip", "grpc"])
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the card)")
    p.add_argument("--export", default=None)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    sim = FederatedLearningSimulation(SimulationConfig(
        dataset=args.dataset, num_clients=args.clients,
        num_rounds=args.rounds, target_accuracy=args.target_accuracy,
        backend=args.backend,
    ), device=args.device)
    results = sim.run_simulation()
    if args.export:
        sim.export_results(args.export)
    print(json.dumps({k: v for k, v in results.items()
                      if k not in ("round_history", "client_results")},
                     indent=2, default=str))
    return results


if __name__ == "__main__":
    main()
