"""The federated round engine: one FedAvg round over stacked clients.

The port of ``fl_tpu.orchestration.round_engine`` for the slice. A round's
superstep runs on the engine's device:

    broadcast(θ_g) → local Adam over all C clients → delta clip + noise
    (dp_mode="delta") → sample-weighted FedAvg → metrics

and the Python round loop stays on the host: participation masks from the
same numpy generator as the reference (so masks are identical for a
seed), the (ε, δ) budget charged when a round is dispatched, one host copy
of the round's metrics when it is finalized, convergence bookkeeping.

``run_rounds_pipelined`` dispatches round r+1 before it reads round r's
metrics back: CUDA launches are asynchronous, so the host's bookkeeping
for round r overlaps the device's work on round r+1, with the semantics of
a ``run_round`` loop. Every dispatched round is finalized exactly once,
also when a dispatch or a finalize raises, and zero rounds return ``[]``.

Ported: ``dp_mode`` "none" and "delta". Every other feature of the
reference's ``RoundEngineConfig`` raises ``ValueError`` naming it.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from fl_tpu_torch.core import prng
from fl_tpu_torch.core.pytree import global_norm, tree_map
from fl_tpu_torch.core.types import PrivacyConfig
from fl_tpu_torch.data.federated import FederatedArrays
from fl_tpu_torch.fl import privacy as dp
from fl_tpu_torch.fl.convergence import ConvergenceDetector, RoundObservation
from fl_tpu_torch.fl.fedavg import fedavg_delta, normalized_client_weights
from fl_tpu_torch.fl.local_training import (
    FederatedTrainingConfig,
    evaluate_test_set,
    make_local_train_fn,
)

logger = logging.getLogger(__name__)

# features of fl_tpu's RoundEngineConfig that the port refuses, with the
# value that means "off"
_NOT_PORTED = {
    "server_optimizer": "none",
    "secure_aggregation": False,
    "uplink_compression": "none",
    "aggregation": "fedavg",
    "adaptive_clipping": False,
    "audit_injection": False,
    "downlink_compression": "none",
    "fednova": False,
    "scaffold": False,
    "trainable_patterns": None,
    "feddyn_alpha": 0.0,
    "qffl_q": None,
}


@dataclasses.dataclass(frozen=True)
class RoundEngineConfig:
    """Round-level knobs (ref defaults: config/coordinator.yaml:9-13)."""

    training: FederatedTrainingConfig = dataclasses.field(
        default_factory=FederatedTrainingConfig)
    min_clients: int = 2
    max_clients: int = 50
    dp_mode: str = "none"              # "none" | "delta"
    privacy: Optional[PrivacyConfig] = None
    epsilon_per_round: Optional[float] = None  # default: privacy.epsilon
    delta_per_round: Optional[float] = None
    participation_rate: float = 1.0
    straggler_dropout_rate: float = 0.0
    seed: int = 0
    server_optimizer: str = "none"
    secure_aggregation: bool = False
    uplink_compression: str = "none"
    aggregation: str = "fedavg"
    adaptive_clipping: bool = False
    audit_injection: bool = False
    downlink_compression: str = "none"
    fednova: bool = False
    scaffold: bool = False
    trainable_patterns: Optional[tuple] = None
    feddyn_alpha: float = 0.0
    qffl_q: Optional[float] = None

    def __post_init__(self) -> None:
        if self.dp_mode not in ("none", "delta"):
            raise ValueError(f"dp_mode={self.dp_mode!r} is not ported yet "
                             "(only 'none' and 'delta')")
        for name, off in _NOT_PORTED.items():
            if getattr(self, name) != off:
                raise ValueError(f"{name}={getattr(self, name)!r} is not "
                                 "ported yet")


@dataclasses.dataclass
class RoundResult:
    round_number: int
    train_loss: float
    train_accuracy: float
    test_loss: Optional[float]
    test_accuracy: Optional[float]
    convergence_score: float
    participating_clients: int
    round_time_s: float
    epsilon_spent: float = 0.0


@dataclasses.dataclass
class _PendingRound:
    """A dispatched round whose metrics are still on the device."""

    round_number: int
    mask: np.ndarray
    t0: float
    metrics: torch.Tensor
    variables: Dict[str, Any]
    eps_spent: float
    ledger: Optional[Callable[[Dict[str, float]], None]]


# layout of the packed per-round metrics vector (one device→host copy)
_SCALARS = ("train_loss", "train_accuracy", "weight_change_norm",
            "weight_norm", "dp_sigma_mean")


class FederatedRoundEngine:
    """Owns the device-resident data and global model, and the host round
    loop. Runs on the GPU unless the caller asks for ``device="cpu"``."""

    def __init__(
        self,
        model,
        data: FederatedArrays,
        config: RoundEngineConfig,
        device="cuda",
        test_images: Optional[np.ndarray] = None,
        test_labels: Optional[np.ndarray] = None,
    ):
        self.model = model
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"FederatedRoundEngine runs on device={str(device)!r} and no "
                "CUDA device is available; pass device=\"cpu\" to run on "
                "the CPU")
        self.num_clients = data.num_clients
        self._num_samples = np.asarray(data.num_samples)
        self.data = data.to_device(self.device)

        self._root = prng.root_seed(config.seed)
        self._np_rng = np.random.default_rng(config.seed + 1)

        self.privacy = config.privacy
        if config.dp_mode != "none" and self.privacy is None:
            raise ValueError(
                f"dp_mode={config.dp_mode!r} requires a PrivacyConfig")
        self.budget_tracker = (
            dp.PrivacyBudgetTracker(self.privacy.epsilon, self.privacy.delta)
            if self.privacy else None)
        self.accountant = dp.PrivacyAccountant()

        self._local_train = make_local_train_fn(
            model, config.training, self.data.samples_per_client,
            self.data.mean, self.data.std)
        if test_images is not None:
            self.test_images = torch.as_tensor(
                np.asarray(test_images, np.float32)).to(self.device)
            self.test_labels = torch.as_tensor(
                np.asarray(test_labels, np.int64)).to(self.device)
        else:
            self.test_images = self.test_labels = None

        self.round_number = 0
        init_gen = prng.generator(
            prng.stream_seed(self._root, prng.Stream.INIT), self.device)
        self.global_variables: Dict[str, Any] = {
            "params": model.init(init_gen, self.device)}
        self.history: List[RoundResult] = []
        self.detector = ConvergenceDetector()

    # ------------------------------------------------------------------
    # the superstep
    # ------------------------------------------------------------------
    def _superstep(self, global_params, round_idx: int,
                   mask: torch.Tensor):
        cfg = self.config
        C = self.num_clients
        rseed = prng.round_seed(self._root, round_idx)
        stacked = tree_map(lambda g: g[None].expand(C, *g.shape),
                           global_params)
        new_stacked, metrics = self._local_train(
            stacked, self.data.images, self.data.labels,
            self.data.num_samples, rseed)

        sigma_mean = torch.zeros((), device=self.device)
        if cfg.dp_mode == "delta":
            # reference semantics (federated_trainer.py:428-469): noise
            # the local-global delta and re-add it to the global model
            eps_r = cfg.epsilon_per_round or self.privacy.epsilon
            del_r = cfg.delta_per_round or self.privacy.delta
            deltas = tree_map(lambda c, g: c - g[None], new_stacked,
                              global_params)
            noisy, _, sigma = dp.dp_noise_client_deltas(
                deltas, rseed, eps_r, del_r, self.privacy.max_grad_norm)
            new_stacked = tree_map(lambda d, g: d + g[None], noisy,
                                   global_params)
            sigma_mean = sigma.sum() / C

        w = normalized_client_weights(self.data.num_samples, mask)
        new_global = fedavg_delta(global_params, new_stacked, w)
        scalars = torch.stack([
            (metrics["loss"] * w).sum(),
            (metrics["accuracy"] * w).sum(),
            global_norm(tree_map(torch.sub, new_global, global_params)),
            global_norm(new_global),
            sigma_mean,
        ])
        packed = torch.cat([scalars, metrics["loss"], metrics["accuracy"]])
        return new_global, packed

    # ------------------------------------------------------------------
    # host round loop
    # ------------------------------------------------------------------
    def sample_participation(
        self, exclude: Optional[List[int]] = None
    ) -> np.ndarray:
        """Per-round participation mask: Bernoulli participation ×
        straggler dropout × exclusions, min_clients enforced (largest
        shards first) and max_clients capped by sample count — the
        reference's rule and random stream."""
        cfg = self.config
        mask = (self._np_rng.random(self.num_clients)
                < cfg.participation_rate).astype(np.float32)
        if cfg.straggler_dropout_rate > 0:
            mask *= (self._np_rng.random(self.num_clients)
                     >= cfg.straggler_dropout_rate).astype(np.float32)
        if exclude:
            mask[np.asarray(exclude, int)] = 0.0
        active_count = int(mask.sum())
        if active_count < cfg.min_clients:
            excluded = set(int(e) for e in exclude) if exclude else ()
            for c in np.argsort(-self._num_samples):
                if active_count >= cfg.min_clients:
                    break
                if int(c) not in excluded and mask[c] == 0.0:
                    mask[c] = 1.0
                    active_count += 1
        if mask.sum() > cfg.max_clients:
            active = np.flatnonzero(mask)
            counts = self._num_samples[active]
            keep = active[np.argsort(-counts)[: cfg.max_clients]]
            mask[:] = 0.0
            mask[keep] = 1.0
        return mask

    def run_round(self, mask: Optional[np.ndarray] = None,
                  evaluate: bool = True) -> RoundResult:
        """Execute one FedAvg round (superstep + host bookkeeping)."""
        return self._finalize_round(self._dispatch_round(mask),
                                    evaluate=evaluate)

    def run_rounds_pipelined(self, num_rounds: int, evaluate: bool = False,
                             masks: Optional[np.ndarray] = None
                             ) -> List[RoundResult]:
        """``num_rounds`` rounds with depth-1 dispatch pipelining (see the
        module docstring)."""
        results: List[RoundResult] = []
        pending: Optional[_PendingRound] = None
        try:
            for r in range(num_rounds):
                nxt = self._dispatch_round(None if masks is None else masks[r])
                done, pending = pending, nxt
                if done is not None:
                    results.append(self._finalize_round(done, evaluate))
        finally:
            if pending is not None:
                results.append(self._finalize_round(pending, evaluate))
        return results

    def _dispatch_round(self, mask: Optional[np.ndarray] = None
                        ) -> _PendingRound:
        """Budget check and charge, then enqueue the superstep; does not
        wait for the device."""
        cfg = self.config
        t0 = time.perf_counter()
        if mask is None:
            mask = self.sample_participation()
        charge = self.budget_tracker is not None and cfg.dp_mode != "none"
        if charge:
            eps_r = cfg.epsilon_per_round or self.privacy.epsilon
            del_r = cfg.delta_per_round or self.privacy.delta
            if self.budget_tracker.is_budget_exhausted(eps_r, del_r):
                raise dp.PrivacyError(
                    "Privacy budget exhausted — cannot run another DP round")

        mask_t = torch.as_tensor(np.asarray(mask, np.float32)).to(self.device)
        new_global, metrics = self._superstep(
            self.global_variables["params"], self.round_number, mask_t)
        self.global_variables = {"params": new_global}

        eps_spent = 0.0
        ledger = None
        rn = self.round_number
        if charge:
            self.budget_tracker.consume_budget(eps_r, del_r, f"round_{rn}")
            eps_spent = eps_r

            def ledger(m, _eps=eps_r, _del=del_r):
                self.accountant.add_mechanism(
                    "gaussian", _eps, _del,
                    sensitivity=self.privacy.max_grad_norm,
                    noise_scale=m["dp_sigma_mean"],
                    metadata={"round": rn, "mode": cfg.dp_mode})

        self.round_number += 1
        return _PendingRound(round_number=rn, mask=np.asarray(mask), t0=t0,
                             metrics=metrics, variables=self.global_variables,
                             eps_spent=eps_spent, ledger=ledger)

    def _finalize_round(self, pending: _PendingRound,
                        evaluate: bool = True) -> RoundResult:
        """Blocking half of a round: one host copy of the packed metrics,
        then the bookkeeping that needs them."""
        packed = pending.metrics.cpu().numpy()
        C = self.num_clients
        metrics = {k: float(v) for k, v in zip(_SCALARS, packed)}
        if pending.ledger is not None:
            pending.ledger(metrics)

        test_loss = test_acc = None
        if evaluate and self.test_images is not None:
            ev = evaluate_test_set(self.model, pending.variables["params"],
                                   self.test_images, self.test_labels)
            test_loss, test_acc = ev["loss"], ev["accuracy"]

        conv = self.detector.update(RoundObservation(
            round_number=pending.round_number,
            accuracy=test_acc if test_acc is not None
            else metrics["train_accuracy"],
            loss=test_loss if test_loss is not None
            else metrics["train_loss"],
            weight_change_norm=metrics["weight_change_norm"],
            weight_norm=metrics["weight_norm"],
        ))
        result = RoundResult(
            round_number=pending.round_number,
            train_loss=metrics["train_loss"],
            train_accuracy=metrics["train_accuracy"],
            test_loss=test_loss,
            test_accuracy=test_acc,
            convergence_score=conv.convergence_score,
            participating_clients=int(pending.mask.sum()),
            round_time_s=time.perf_counter() - pending.t0,
            epsilon_spent=pending.eps_spent,
        )
        n = len(_SCALARS)
        self.last_client_losses = packed[n:n + C]
        self.last_client_accuracies = packed[n + C:n + 2 * C]
        self.history.append(result)
        return result

    def run(self, num_rounds: int, target_accuracy: Optional[float] = None,
            early_stopping: bool = False, evaluate_every: int = 1,
            verbose: bool = False) -> List[RoundResult]:
        """Drive ``num_rounds`` rounds with the reference's exit criteria
        (target accuracy / round budget / early stop)."""
        for r in range(num_rounds):
            evaluate = (r % evaluate_every == 0) or (r == num_rounds - 1)
            result = self.run_round(evaluate=evaluate)
            if verbose:
                logger.info("round %d: train_acc=%.4f test_acc=%s loss=%.4f "
                            "(%.3fs)", result.round_number,
                            result.train_accuracy, result.test_accuracy,
                            result.train_loss, result.round_time_s)
            if (target_accuracy is not None
                    and result.test_accuracy is not None
                    and result.test_accuracy >= target_accuracy):
                break
            if early_stopping and self.detector.should_stop_early()[0]:
                break
        return self.history

    def evaluate(self) -> Dict[str, float]:
        if self.test_images is None:
            raise ValueError("No test set configured")
        return evaluate_test_set(self.model, self.global_variables["params"],
                                 self.test_images, self.test_labels)
