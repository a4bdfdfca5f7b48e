"""The federated round engine: one FedAvg round over stacked clients.

The port of ``fl_tpu.orchestration.round_engine`` for the slice. A round's
superstep runs on the engine's device:

    downlink θ̂ = compress(θ_g) → broadcast θ̂ → local Adam over all C
    clients → delta clip + noise (dp_mode="delta") → uplink compression
    with error feedback → sample-weighted FedAvg of the deltas against θ̂,
    applied to the full-precision θ_g → metrics

or, under dp_mode="client_dp" (client-level DP-FedAvg, McMahan et al.
2018), after local training: Δ = θ_client − θ̂ (audit canaries' Δ replaced
here) → each Δ clipped to C → masked sum over the FIXED expected
participant count m̄ = max(1, q·N) → central N(0, σ²), σ = z·C/m̄ → θ_g +
noisy mean; with adaptive clipping (Andrew et al. 2021) also the noisy
clipped fraction and the next C. The other DP mechanisms:

- "dp_sgd" (example level): every local step's gradient is clipped per
  example and noised inside the trainer (``fl.privacy``'s microbatch fold
  or ghost norms, ``dp_sgd_impl``); FedAvg as without DP; RDP- or
  PLD-accounted at q = batch/shard, one invocation a local step;
- "dp_ftrl" (Kairouz et al. 2021, ``fl.dp_ftrl``): each participant's Δ
  clipped to C, their masked SUM pushed into the carried prefix sum, and
  the FTRL(M) server step against the tree-noised prefix; round-robin
  cohorts, the per-client participation budget k, ε certified once;
- "distributed" (``fl.distributed_dp``): each clipped Δ stochastically
  rounded to the γ grid, Skellam noise (one aggregate draw, or one share
  a client with ``dist_fuse_noise=False``), only the int32 modular sum
  decoded over m̄; Skellam-RDP-accounted at the realized count.

The Python round loop stays on the host: participation masks from the
same numpy generator as the reference (so masks are identical for a
seed; pure Poisson under client_dp, rotation under dp_ftrl), the budget
checked and charged when a round is dispatched (the (ε, δ) ledger under
"delta", the RDP accountant or the PLD step budget under "client_dp" and
"dp_sgd", the Skellam RDP under "distributed", the tree's one-off charge
and the participation ledger under "dp_ftrl"), one host copy of the
round's metrics when it is finalized, convergence bookkeeping.

``run_rounds_pipelined`` dispatches round r+1 before it reads round r's
metrics back: CUDA launches are asynchronous, so the host's bookkeeping
for round r overlaps the device's work on round r+1, with the semantics of
a ``run_round`` loop. Every dispatched round is finalized exactly once,
also when a dispatch or a finalize raises, and zero rounds return ``[]``.

Ported: every ``dp_mode`` ("none", "delta", "dp_sgd", "client_dp",
"dp_ftrl", "distributed"; ``accountant`` "rdp" or "pld",
``adaptive_clipping`` and ``audit_injection``);
``uplink_compression`` (int8, topk, powersgd, with the error-feedback state
``uplink_error`` carried across rounds on the device) and
``downlink_compression`` (bfloat16, int8); the local-training options of
``FederatedTrainingConfig`` and per-client epoch budgets
(``epochs_per_client``); the server side's ``aggregation`` (trimmed mean,
median, Krum), ``secure_aggregation``, ``server_optimizer`` (FedAvgM,
FedAdam, FedYogi, stepped at dispatch on the pseudo-gradient), ``fednova``,
``scaffold`` (the variates ``scaffold_c`` / ``scaffold_ci`` carried on the
device), ``feddyn_alpha`` (FedDyn's ``feddyn_h`` / ``feddyn_grads``
carried on the device), ``qffl_q`` (q-FFL, with F_k(θ̂) evaluated inside
the superstep before local training) and ``trainable_patterns`` (parameter
freezing through the trainer's gradient mask). The reference's feature
rules for these raise its messages verbatim in its order (the trimmed-mean
rule, which needs the client count, when the engine is built).

Models: any of ``models.AVAILABLE_MODELS`` (SimpleCNN, CIFAR10CNN,
FederatedResNet, LightweightMobileNet, FederatedViT with or without LoRA
adapters) or another object with the same duck-typed contract: ``init``,
optionally ``init_batch_stats`` and ``dropout_keep``, and ``forward(params,
x, train=, generator=, ...)``. A BatchNorm model's ``batch_stats``
(per-client running statistics, carried through local training) travel in
``global_variables`` with the params: deltas against θ̂, delta DP's clip
and K3 groups, client_dp's and distributed DP's release, the uplink's
flat layout (flax leaf order: ``batch_stats`` first) and robust / secure /
sample-weighted FedAvg (FedNova reweights the params only) cover them;
``aggregate_batch_stats=False`` keeps the broadcast ones; the server
optimizer steps the params only; dp_ftrl freezes them (with the
reference's warning); dp_sgd, FedDyn and q-FFL refuse such a model with
the reference's messages. ``augment_fn`` (``ops.preprocess``) augments
every local batch.

Other entry points: ``run_rounds_fused`` (R rounds dispatched back to back
with one device→host copy of the stacked per-round metrics at the end),
``profile_round`` (one round under ``torch.profiler``, a Chrome trace),
``evaluate_federated`` / ``evaluate_personalized`` (``fl.federated_eval``,
``fl.personalization``), ``get_model_weights`` / ``set_model_weights``; and
``orchestration.checkpoint``'s save and restore.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from fl_tpu_torch.core import prng
from fl_tpu_torch.core.pytree import (
    assert_same_structure,
    global_norm,
    tree_map,
    unflatten_dict,
)
from fl_tpu_torch.core.transfer import to_device
from fl_tpu_torch.core.types import PrivacyConfig
from fl_tpu_torch.data.federated import FederatedArrays
from fl_tpu_torch.fl import distributed_dp as ddp
from fl_tpu_torch.fl import dp_ftrl as ftrl
from fl_tpu_torch.fl import privacy as dp
from fl_tpu_torch.fl.accounting import RDPAccountant, rdp_subsampled_gaussian
from fl_tpu_torch.fl.convergence import ConvergenceDetector, RoundObservation
from fl_tpu_torch.fl.federated_eval import (
    evaluate_federated, make_federated_eval_fn)
from fl_tpu_torch.fl.feddyn import feddyn_server_update
from fl_tpu_torch.fl.fedavg import (
    fedavg_delta,
    fednova_effective_steps,
    normalized_client_weights,
)
from fl_tpu_torch.fl.local_training import (
    FederatedTrainingConfig,
    evaluate_test_set,
    make_local_train_fn,
)
from fl_tpu_torch.fl.peft import count_trainable, trainable_mask
from fl_tpu_torch.fl.personalization import evaluate_personalization
from fl_tpu_torch.fl.qffl import qffl_combine
from fl_tpu_torch.fl.robust_agg import (
    ROBUST_AGGREGATORS,
    robust_combine_deltas,
)
from fl_tpu_torch.fl.scaffold import scaffold_correction, scaffold_update
from fl_tpu_torch.fl.secure_agg import secure_fedavg_delta
from fl_tpu_torch.fl.server_optimizer import make_server_optimizer
from fl_tpu_torch.fl.powersgd import (
    apply_powersgd_with_error_feedback,
    init_uplink_state,
    make_powersgd_plan,
)
from fl_tpu_torch.fl.uplink import (
    UPLINK_KINDS,
    apply_uplink_with_error_feedback,
    make_uplink_fn,
)
from fl_tpu_torch.models.factory import get_model_weights
from fl_tpu_torch.ops.flatten import (
    flat_dim,
    padded_dim,
    stack_flatten,
    stack_unflatten,
    stacked_spec,
)
from fl_tpu_torch.ops.quantize import dequantize_affine, quantize_affine

logger = logging.getLogger(__name__)

_DP_MODES = ("none", "delta", "dp_sgd", "client_dp", "dp_ftrl",
             "distributed")
# the modes that own their aggregation (clipped sum + central noise)
_CENTRAL_DP = ("client_dp", "dp_ftrl", "distributed")
# the modes accounted as a subsampled Gaussian (RDP, or PLD's step budget)
_SUBSAMPLED_GAUSSIAN = ("dp_sgd", "client_dp")


@dataclasses.dataclass(frozen=True)
class RoundEngineConfig:
    """Round-level knobs (ref defaults: config/coordinator.yaml:9-13)."""

    training: FederatedTrainingConfig = dataclasses.field(
        default_factory=FederatedTrainingConfig)
    min_clients: int = 2
    max_clients: int = 50
    # "none" | "delta" (per-client clip + noise, the reference semantics)
    # | "dp_sgd" (per-example clipping inside every local step)
    # | "client_dp" (clip each client's delta to C, masked sum over the
    # fixed m̄ = q·N, central noise σ = z·C/m̄, RDP-accounted at q)
    # | "dp_ftrl" (tree-noised prefix sums, no sampling assumption)
    # | "distributed" (Skellam shares over the int32 modular sum)
    dp_mode: str = "none"
    privacy: Optional[PrivacyConfig] = None
    epsilon_per_round: Optional[float] = None  # default: privacy.epsilon
    delta_per_round: Optional[float] = None
    participation_rate: float = 1.0
    straggler_dropout_rate: float = 0.0
    seed: int = 0
    # average the BatchNorm statistics with the same FedAvg weights
    # (FedBN-avg); False keeps the broadcast statistics
    aggregate_batch_stats: bool = True
    # DP-SGD: examples a per-example chunk (peak memory ≈ clients ×
    # dp_microbatch × |params|), and the form: "auto" (ghost norms where
    # the model declares the taps), "ghost" or "microbatch"
    dp_microbatch: int = 16
    dp_sgd_impl: str = "auto"
    # ε accountant of dp_sgd / client_dp: "rdp" | "pld" (the gate then
    # enforces the PLD-certified step count; the RDP ledger keeps running)
    accountant: str = "rdp"
    pld_dt: Optional[float] = None  # PLD grid; None = fl.pld's auto size
    # server-side optimizer on the FedAvg pseudo-gradient (Reddi et al.
    # 2021): "none" | "fedavgm" | "fedadam" | "fedyogi"
    server_optimizer: str = "none"
    server_lr: float = 1.0
    server_momentum: float = 0.9
    server_b1: float = 0.9
    server_b2: float = 0.99
    server_eps: float = 1e-3
    # pairwise additive masking over a ring of secure_agg_neighbors
    # offsets (fl.secure_agg)
    secure_aggregation: bool = False
    secure_agg_neighbors: int = 8
    secure_agg_scale: float = 1.0
    # lossy uplink with error feedback (fl.uplink, fl.powersgd):
    # "none" | "int8" | "topk" | "powersgd"
    uplink_compression: str = "none"
    uplink_topk_ratio: float = 0.01  # fraction of coords kept per client
    uplink_powersgd_rank: int = 4
    # Byzantine-robust aggregation (fl.robust_agg): "fedavg" |
    # "trimmed_mean" | "median" | "krum", over participants, unweighted
    aggregation: str = "fedavg"
    trim_k: int = 1       # trimmed_mean: drop k highest + k lowest per coord
    krum_f: int = 1       # krum: tolerated Byzantine count
    krum_m: int = 1       # multi-krum: how many lowest-score updates to avg
    # client_dp only: track C to the clip_quantile-quantile of the client
    # delta norms (Andrew et al. 2021); privacy.max_grad_norm is the
    # initial C; σ_b defaults to m̄/20
    adaptive_clipping: bool = False
    clip_quantile: float = 0.5
    clip_lr: float = 0.2
    clip_count_stddev: Optional[float] = None
    # client_dp only: run_round's inject_flags / inject_deltas replace the
    # flagged clients' deltas ahead of the clip (validation.audit)
    audit_injection: bool = False
    # DP-FTRL (fl.dp_ftrl): privacy.noise_multiplier is the whole
    # transcript's z; T_max (required) fixes the tree height. The nonce
    # keys the node noise: None draws fresh OS entropy an engine; set it
    # only to reproduce one run, never to continue a finished tree
    ftrl_rounds: Optional[int] = None
    ftrl_tree_nonce: Optional[int] = None
    ftrl_max_participations: int = 1      # k: per-client round budget
    ftrl_momentum: float = 0.9            # β of DP-FTRLM (0 = plain)
    ftrl_cohort_size: Optional[int] = None  # m̄; default q·N rounded
    ftrl_server_lr: float = 1.0
    # distributed DP (fl.distributed_dp): grid γ = max_grad_norm /
    # 2^dist_bits; dist_fuse_noise draws the summed Skellam noise once on
    # the aggregate (the same distribution), False one share a client
    dist_bits: int = 14
    dist_fuse_noise: bool = True
    # the broadcast θ̂ the clients train from: "none" | "bfloat16" | "int8"
    # (per-leaf symmetric); deltas are measured against θ̂ and applied to
    # the full-precision master
    downlink_compression: str = "none"
    # FedNova normalized averaging (Wang et al. 2020): each delta divided
    # by its effective step count a_i, rescaled by Σ p_i a_i
    fednova: bool = False
    # SCAFFOLD control variates (Karimireddy et al. 2020, Option II)
    scaffold: bool = False
    # parameter freezing (fl.peft): regex patterns over the "/"-joined
    # param paths; only matching leaves train, the others get exactly-zero
    # updates. Drift correctors (scaffold/fednova/feddyn) are refused.
    trainable_patterns: Optional[Tuple[str, ...]] = None
    # FedDyn dynamic regularization (Acar et al. 2021, fl.feddyn): the
    # linear term −g_i rides the trainer's correction operand, the
    # quadratic term is FedProx's proximal_mu = α (keep proximal_mu 0);
    # state h (D_pad,) and g (C, D_pad) carried on the device. 0.0 = off
    feddyn_alpha: float = 0.0
    # q-FFL (Li et al. 2020, fl.qffl): each delta weighted by F_k(θ̂)^q,
    # the client's loss at the received model, and the step normalized by
    # Σ h_k; 0.0 is uniform FedAvg, [1, 5] the paper's fairness range.
    # None = off; dp_mode must be "none"
    qffl_q: Optional[float] = None

    def __post_init__(self) -> None:
        # the reference's rules for the ported features, in its order and
        # with its messages verbatim (fl_tpu/orchestration/features.py);
        # the trimmed-mean rule needs num_clients and runs in the engine
        for message in _rule_messages(self):
            if message:
                raise ValueError(message)


def _rule_messages(cfg: RoundEngineConfig):
    """The reference's refusal messages for ``cfg``, in its order, lazily:
    None where a rule does not refuse."""
    central = cfg.dp_mode in _CENTRAL_DP
    robust = cfg.aggregation != "fedavg"
    train = cfg.training
    yield (cfg.uplink_compression not in UPLINK_KINDS
           and f"uplink_compression={cfg.uplink_compression!r} not in "
               f"{UPLINK_KINDS}")
    yield (cfg.dp_mode not in _DP_MODES
           and f"dp_mode={cfg.dp_mode!r} not in ('none', 'delta', "
               "'dp_sgd', 'client_dp', 'dp_ftrl', 'distributed')")
    yield (cfg.uplink_compression != "none" and central
           and "uplink compression cannot compose with client_dp/dp_ftrl/"
               "distributed: the "
               "central clip runs after reconstruction, so clipped-off "
               "mass would never return to the error-feedback residual "
               "(breaking EF's nothing-lost-only-delayed guarantee)")
    yield (cfg.aggregation not in ROBUST_AGGREGATORS
           and f"aggregation={cfg.aggregation!r} not in "
               f"{ROBUST_AGGREGATORS}")
    yield (robust and cfg.secure_aggregation
           and "robust aggregation needs the server to see real "
               "updates; it cannot compose with secure_aggregation")
    yield (robust and central
           and "client_dp/dp_ftrl/distributed own their aggregation "
               "(clipped sum + calibrated noise); robust aggregation "
               "applies to the other dp modes")
    yield (cfg.downlink_compression not in ("none", "bfloat16", "int8")
           and f"downlink_compression={cfg.downlink_compression!r} "
               "not in ('none', 'bfloat16', 'int8')")
    yield (cfg.downlink_compression != "none"
           and (robust or cfg.secure_aggregation)
           and "downlink_compression composes only with plain FedAvg "
               "aggregation (robust/secure paths compute deltas "
               "against the uncompressed master)")
    yield (cfg.downlink_compression != "none"
           and (cfg.dp_mode == "dp_ftrl" or cfg.scaffold)
           and "downlink_compression cannot compose with dp_ftrl/"
               "scaffold: both carry server-side state defined "
               "against the exact broadcast")
    yield (cfg.fednova and robust
           and "fednova is a reweighting of the FedAvg reduction; "
               f"it cannot compose with aggregation="
               f"{cfg.aggregation!r}")
    yield (cfg.fednova and cfg.secure_aggregation
           and "fednova cannot compose with secure_aggregation: the "
               "pairwise masks cancel only under the FedAvg sample "
               "weights, and the server cannot reweight masked "
               "payloads per client")
    yield (cfg.fednova and cfg.dp_mode not in ("none", "delta")
           and "fednova composes only with dp_mode in ('none', "
               "'delta'): delta noise is a per-client local release "
               "(reweighting is post-processing), but dp_sgd/"
               "client_dp/dp_ftrl calibrate central noise to FIXED "
               "aggregation weights")
    yield (cfg.fednova and train.optimizer_type != "sgd"
           and "fednova's effective-step normalization a_i is an "
               "SGD(-momentum) trajectory identity; set "
               "training.optimizer_type='sgd' (Wang et al. 2020 §4)")
    yield (cfg.fednova and not 0.0 <= train.momentum < 1.0
           and "fednova needs momentum in [0, 1): a_i = "
               "[τ − ρ(1−ρ^τ)/(1−ρ)]/(1−ρ) diverges at ρ=1 "
               f"(got momentum={train.momentum})")
    yield (cfg.fednova and bool(train.proximal_mu)
           and "fednova with a FedProx proximal term needs the "
               "proximal a_i correction (Wang et al. 2020 Table 1), "
               "which is not wired; use one or the other")
    yield (cfg.fednova and cfg.scaffold
           and "fednova and scaffold both correct client drift; "
               "compose at most one")
    yield (cfg.accountant not in ("rdp", "pld")
           and f"accountant={cfg.accountant!r}: expected 'rdp' or 'pld'")
    yield (cfg.accountant == "pld"
           and cfg.dp_mode not in ("dp_sgd", "client_dp")
           and "accountant='pld' applies to the subsampled-Gaussian modes "
               "(dp_sgd, client_dp); distributed uses the Skellam RDP "
               "bound and dp_ftrl the exact analytic Gaussian curve")
    yield (cfg.dp_mode == "distributed" and cfg.secure_aggregation
           and "dp_mode='distributed' already aggregates over the "
               "integer ring mod 2^32 (where masking composes "
               "bit-exactly); the float pairwise-masking path "
               "(secure_aggregation=True) does not apply — see "
               "fl_tpu.fl.distributed_dp.masked_integer_payloads")
    yield (cfg.dp_mode == "distributed"
           and (cfg.dist_bits < 4 or cfg.dist_bits > 20)
           and f"dist_bits={cfg.dist_bits} outside [4, 20]: below, "
               "quantization error dominates; above, int32 headroom "
               "for the modular sum disappears")
    yield (cfg.dp_mode == "dp_ftrl"
           and (cfg.ftrl_rounds is None or cfg.ftrl_rounds < 1)
           and "dp_mode='dp_ftrl' requires ftrl_rounds (T_max): the "
               "tree height — and with it the calibrated node noise "
               "— is fixed before round 0")
    yield (cfg.dp_mode == "dp_ftrl" and cfg.server_optimizer != "none"
           and "dp_ftrl owns the server update (FTRL on noisy prefix "
               "sums); server_optimizer must be 'none'")
    yield (cfg.dp_mode == "dp_ftrl" and cfg.secure_aggregation
           and "dp_ftrl + on-chip secure aggregation is not wired "
               "yet; use dp_ftrl alone (the wire secagg path is "
               "independent)")
    yield (cfg.adaptive_clipping and cfg.dp_mode != "client_dp"
           and "adaptive_clipping tracks the client-level central clip "
               "norm and requires dp_mode='client_dp' (delta mode "
               "noises locally per client; dp_sgd clips per example)")
    yield (cfg.audit_injection and cfg.dp_mode != "client_dp"
           and "audit_injection replaces client deltas ahead of the "
               "central clip and requires dp_mode='client_dp'")
    yield (cfg.scaffold and (train.optimizer_type != "sgd"
                             or train.momentum != 0.0)
           and "scaffold requires plain SGD local steps "
               "(optimizer_type='sgd', momentum=0.0): Option II "
               "recovers c_i+ from the exact SGD trajectory identity "
               "(w_g - w_local)/(K*lr) = avg corrected gradient")
    yield (cfg.scaffold and cfg.dp_mode != "none"
           and "scaffold control variates are exact functions of raw "
               "local trajectories and are not privatized; composing "
               "SCAFFOLD with DP would require privatizing the c_i "
               "updates too (not implemented) — use dp_mode='none'")
    yield (cfg.scaffold and cfg.secure_aggregation
           and "scaffold forms per-client c_i from individual deltas, "
               "which secure aggregation is designed to hide from the "
               "server")
    yield (cfg.scaffold and train.param_storage_dtype is not None
           and "scaffold cannot compose with param_storage_dtype: "
               "the Option II recovery divides the trajectory by "
               "K*lr, amplifying the stochastic-rounding noise in "
               "the stored params by 1/(K*lr) into the control "
               "variates")
    feddyn = cfg.feddyn_alpha > 0
    yield cfg.feddyn_alpha < 0 and "feddyn_alpha must be >= 0"
    yield (feddyn and (cfg.scaffold or cfg.fednova)
           and "feddyn, scaffold, and fednova all correct client "
               "drift; compose at most one")
    yield (feddyn and cfg.dp_mode != "none"
           and "feddyn's g_i states are exact functions of raw local "
               "deltas and are not privatized; use dp_mode='none'")
    yield (feddyn and (cfg.secure_aggregation or robust)
           and "feddyn owns the server update (participant mean − "
               "h/α); it cannot compose with secure/robust "
               "aggregation")
    yield (feddyn and (cfg.uplink_compression != "none"
                       or cfg.downlink_compression != "none")
           and "feddyn's state updates g_i ← g_i − α(θ_i − θ_g) "
               "assume the exact broadcast and exact deltas; lossy "
               "uplink/downlink compression breaks the first-order "
               "identity")
    yield (feddyn and bool(train.proximal_mu)
           and "feddyn injects its own (α/2)-proximal term; leave "
               "training.proximal_mu at 0")
    yield (feddyn and train.param_storage_dtype is not None
           and "feddyn cannot compose with param_storage_dtype: the "
               "g_i state accumulates −αΔ from the stored params, "
               "folding stochastic-rounding noise into carried state")
    yield (feddyn and cfg.server_optimizer != "none"
           and "feddyn owns the server step (θ ← mean θ_i − h/α); "
               "server_optimizer must be 'none'")
    qffl = cfg.qffl_q is not None
    yield (qffl and cfg.qffl_q < 0
           and f"qffl_q={cfg.qffl_q} must be >= 0 (0 is uniform "
               "FedAvg; the paper's fairness range is q in [1, 5])")
    yield (qffl and cfg.dp_mode != "none"
           and "q-FFL's aggregation weights F_k(θ̂)^q are computed "
               "from raw local losses — an unprivatized data-dependent "
               "release; composing with DP would require privatizing "
               "F_k too. Use dp_mode='none'")
    yield (qffl and (robust or cfg.secure_aggregation)
           and "q-FFL is a reweighting of the FedAvg reduction; it "
               "cannot compose with robust or secure aggregation "
               "(the server must apply per-client loss weights)")
    yield (qffl and cfg.server_optimizer != "none"
           and "q-FFL owns the server step (Δ/h normalization, Li et "
               "al. 2020 Alg. 2); server_optimizer must be 'none'")
    yield (qffl and (cfg.fednova or cfg.scaffold or feddyn)
           and "q-FFL replaces the round objective; compose with at "
               "most one of fednova/scaffold/feddyn — none here")
    yield (qffl and cfg.uplink_compression != "none"
           and "q-FFL's h_k normalization is defined on the exact "
               "local deltas; lossy uplink compression would distort "
               "‖Δw_k‖² and the EF residual interplay is unstudied")
    yield (bool(cfg.trainable_patterns)
           and (cfg.scaffold or cfg.fednova or feddyn)
           and "trainable_patterns (parameter freezing) cannot "
               "compose with scaffold/fednova/feddyn: drift "
               "correctors assume full-dimension local trajectories")


def trimmed_mean_message(cfg: RoundEngineConfig, num_clients: int):
    """The reference's trimmed-mean rule, which needs the client count:
    its message, or None."""
    if (cfg.aggregation == "trimmed_mean"
            and math.floor(cfg.participation_rate * num_clients)
            - 2 * cfg.trim_k < 1):
        return (f"trimmed_mean with trim_k={cfg.trim_k} needs more "
                f"than {2 * cfg.trim_k} expected participants")
    return None


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
    clip_norm: Optional[float] = None  # adaptive clipping: C used this round
    # mean over clients of the error-feedback residual's norm (None when
    # the uplink is uncompressed); the reference computes it on the device
    # and reads it back with the round's metrics but does not keep it
    uplink_ef_norm: Optional[float] = None


@dataclasses.dataclass
class _PendingRound:
    """A dispatched round whose metrics are still on the device."""

    round_number: int
    mask: np.ndarray
    t0: float
    metrics: torch.Tensor
    variables: Dict[str, Any]
    eps_spent: float
    round_clip: Optional[float]
    ledger: Optional[Callable[[Dict[str, float]], None]]


# layout of the packed per-round metrics vector (one device→host copy)
_SCALARS = ("train_loss", "train_accuracy", "weight_change_norm",
            "weight_norm", "dp_sigma_mean", "uplink_ef_norm",
            "next_clip_norm", "clip_fraction")


def downlink_roundtrip(x: torch.Tensor, kind: str) -> torch.Tensor:
    """θ̂ of one leaf, what the clients receive: per-leaf symmetric int8
    quantize → dequantize, or a bfloat16 cast there and back."""
    if kind == "int8":
        q, s, zp = quantize_affine(x, bits=8, symmetric=True)
        return dequantize_affine(q, s, zp, symmetric=True).to(x.dtype)
    return x.to(torch.bfloat16).to(x.dtype)


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
        augment_fn: Optional[Callable] = None,
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
        message = trimmed_mean_message(config, self.num_clients)
        if message:
            raise ValueError(message)
        self._num_samples = np.asarray(data.num_samples)
        self.data = data.to_device(self.device)
        # per-client epoch budgets (capability adaptation; default flat)
        self._epochs_per_client = np.full(
            (self.num_clients,), config.training.local_epochs, np.int32)

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

        # the RDP accountant of dp_sgd, client_dp and distributed. Under
        # the subsampled-Gaussian modes q, z and the invocations a round
        # are fixed for the engine's life, so one round's RDP vector is
        # computed once, at first use, and accumulated (the same values as
        # stepping the accountant each round); distributed charges the
        # Skellam bound at each round's realized count.
        self.rdp_accountant = None
        self._round_rdp_vec = None
        if config.dp_mode in _SUBSAMPLED_GAUSSIAN + ("distributed",):
            self.rdp_accountant = RDPAccountant()
        # PLD budget gate state: max steps certified under ε, steps taken
        self._pld_max_steps: Optional[int] = None
        self._pld_steps_taken: int = 0
        # client_dp's fixed denominator m̄ = max(1, q·N)
        self._expected_count = max(
            1.0, config.participation_rate * self.num_clients)

        # DP-FTRL: certify the whole transcript's ε up front and freeze
        # the tree's geometry (the sensitivity depends on T_max and k)
        self._ftrl_eps_total = None
        if config.dp_mode == "dp_ftrl":
            z = self.privacy.noise_multiplier
            eps_total = ftrl.gaussian_epsilon(z, self.privacy.delta)
            if eps_total > self.privacy.epsilon + 1e-9:
                raise dp.PrivacyError(
                    f"dp_ftrl at z={z} certifies ε={eps_total:.3f} > "
                    f"budget ε={self.privacy.epsilon}; raise "
                    "noise_multiplier (fl_tpu.fl.dp_ftrl."
                    "calibrate_noise_multiplier gives the smallest "
                    "sufficient z)")
            self._ftrl_eps_total = eps_total
            self._ftrl_height = ftrl.tree_height(config.ftrl_rounds)
            k = config.ftrl_max_participations
            self._ftrl_sigma_node = (z * self.privacy.max_grad_norm
                                     * math.sqrt(k * self._ftrl_height))
            self._ftrl_cohort = (
                config.ftrl_cohort_size
                if config.ftrl_cohort_size is not None
                else max(1, round(config.participation_rate
                                  * self.num_clients)))
            nonce = config.ftrl_tree_nonce
            if nonce is None:
                nonce = int.from_bytes(os.urandom(8), "little")
            self._set_ftrl_nonce(int(nonce) & 0xFFFFFFFFFFFFFFFF)

        # adaptive clipping: σ_b, the feasibility check (2σ_b > z, else
        # PrivacyError) and the inflated aggregate multiplier z_Δ
        self.clip_norm: Optional[float] = None
        self._clip_count_stddev: Optional[float] = None
        self._z_delta: Optional[float] = None
        if config.adaptive_clipping:
            self._clip_count_stddev = (
                config.clip_count_stddev
                if config.clip_count_stddev is not None
                else self._expected_count / 20.0)
            self._z_delta = dp.adaptive_clip_delta_multiplier(
                self.privacy.noise_multiplier, self._clip_count_stddev)
            self.clip_norm = float(self.privacy.max_grad_norm)

        self.round_number = 0
        init_gen = prng.generator(
            prng.stream_seed(self._root, prng.Stream.INIT), self.device)
        self.global_variables: Dict[str, Any] = {
            "params": model.init(init_gen, self.device)}
        # a BatchNorm model's running statistics (CIFAR10CNN norm="batch")
        init_stats = getattr(model, "init_batch_stats", None)
        stats = init_stats(self.device) if init_stats is not None else None
        if stats is not None:
            self.global_variables["batch_stats"] = stats
        params = self.global_variables["params"]
        variables = self.global_variables
        # parameter freezing (fl.peft): the mask of the initial params
        self._grad_mask = None
        if config.trainable_patterns:
            self._grad_mask = trainable_mask(params,
                                             config.trainable_patterns)
            tr, tot = count_trainable(self._grad_mask)
            logger.info("parameter freezing: %d/%d params trainable "
                        "(%.1f%%)", tr, tot, 100.0 * tr / max(tot, 1))
        # the reference's refusals for a model with batch statistics
        if config.feddyn_alpha > 0 and "batch_stats" in self.global_variables:
            raise ValueError(
                "feddyn's server model θ ← mean θ_i − h/α is defined on "
                "params only (Acar et al. 2021 has no BN treatment); use "
                "a stats-free model, e.g. create_model('cifar10_cnn', "
                "norm='group').")
        if config.qffl_q is not None and "batch_stats" in self.global_variables:
            raise ValueError(
                "q-FFL's server step θ ← θ − ΣΔ_k/Σh_k is defined on "
                "params only (Li et al. 2020 has no BN treatment); use "
                "a stats-free model, e.g. create_model('cifar10_cnn', "
                "norm='group').")

        train_cfg = config.training
        if config.feddyn_alpha > 0:
            # FedDyn's (α/2)‖θ − θ_g‖² term IS the FedProx proximal hook
            train_cfg = dataclasses.replace(
                train_cfg, proximal_mu=config.feddyn_alpha)
        if config.dp_mode == "dp_sgd" and "batch_stats" in self.global_variables:
            raise ValueError(
                "dp_sgd with BatchNorm is unsound: batch statistics couple "
                "examples, so the per-example gradients DP-SGD clips are "
                "ill-defined. Use a per-example normalization, e.g. "
                "create_model('cifar10_cnn', norm='group').")
        self._local_train = make_local_train_fn(
            model, train_cfg, self.data.samples_per_client,
            self.data.mean, self.data.std, grad_mask=self._grad_mask,
            dp_sgd_fn=self._make_dp_sgd_fn(), augment_fn=augment_fn)
        # q-FFL's F_k(θ̂): the masked eval-mode loss over each client's
        # shard at the model it received, inside the superstep
        self._qffl_eval = (make_federated_eval_fn(
            model, self.data.samples_per_client, self.data.mean,
            self.data.std) if config.qffl_q is not None else None)
        # the server optimizer's state is built at its first step
        self._server_opt = make_server_optimizer(
            config.server_optimizer, learning_rate=config.server_lr,
            momentum=config.server_momentum, b1=config.server_b1,
            b2=config.server_b2, eps=config.server_eps)
        self.server_opt_state = None
        if test_images is not None:
            self.test_images = torch.as_tensor(
                np.asarray(test_images, np.float32)).to(self.device)
            self.test_labels = torch.as_tensor(
                np.asarray(test_labels, np.int64)).to(self.device)
        else:
            self.test_images = self.test_labels = None

        # uplink state: (C, D_pad) f32 error feedback over the whole
        # variables tree when compression is on, a (C, 1) zero dummy
        # otherwise; PowerSGD appends its warm-started Q factors after the
        # EF region (fl.powersgd)
        self._powersgd_plan = None
        if config.uplink_compression == "powersgd":
            self._powersgd_plan = make_powersgd_plan(
                variables, config.uplink_powersgd_rank)
            q_gen = prng.generator(
                prng.stream_seed(self._root, prng.Stream.UPLINK_Q),
                self.device)
            self.uplink_error = init_uplink_state(
                q_gen, self._powersgd_plan, self.num_clients)
        else:
            ef_d = (padded_dim(flat_dim(variables, batched=False))
                    if config.uplink_compression != "none" else 1)
            self.uplink_error = torch.zeros((self.num_clients, ef_d),
                                            dtype=torch.float32,
                                            device=self.device)
        # SCAFFOLD's variates: server c (D_pad,) and clients' c_i (C,
        # D_pad), zero at the start (so mean(c_i) == c holds from round 0);
        # FedDyn's server h (D_pad,) and clients' g_i (C, D_pad), zero at
        # the start (Alg. 1); both in the flat spec of the stacked params
        self.scaffold_c = self.scaffold_ci = None
        self.feddyn_h = self.feddyn_grads = None
        self._flat_spec = None
        if config.scaffold or config.feddyn_alpha > 0:
            d_pad = padded_dim(flat_dim(params, batched=False))
            server = torch.zeros((d_pad,), dtype=torch.float32,
                                 device=self.device)
            clients = torch.zeros((self.num_clients, d_pad),
                                  dtype=torch.float32, device=self.device)
            if config.scaffold:
                self.scaffold_c, self.scaffold_ci = server, clients
            else:
                self.feddyn_h, self.feddyn_grads = server, clients
            self._flat_spec = stacked_spec(params, self.num_clients)
        # distributed DP: the plan's sensitivity and noise from the model's
        # real flat dim, certified against int32 wraparound up front
        self._dist_plan = None
        if config.dp_mode == "distributed":
            self._dist_plan = ddp.DistributedDPPlan(
                clip_norm=float(self.privacy.max_grad_norm),
                bits=config.dist_bits,
                dim=flat_dim(variables, batched=False),
                expected_clients=max(1, round(config.participation_rate
                                              * self.num_clients)),
                noise_multiplier=float(self.privacy.noise_multiplier))
            ddp.check_no_wraparound(self._dist_plan, self.num_clients)
        # DP-FTRL's mechanism state: the true clipped-sum prefix, the last
        # released noisy prefix and the momentum, (D_pad,) on the device,
        # and the host's per-client participation ledger enforcing k
        if config.dp_mode == "dp_ftrl":
            d_pad = padded_dim(flat_dim(params, batched=False))
            self.ftrl_cumsum, self.ftrl_prev_noisy, self.ftrl_momentum_buf = (
                torch.zeros((d_pad,), dtype=torch.float32, device=self.device)
                for _ in range(3))
            self.ftrl_participations = np.zeros((self.num_clients,),
                                                np.int64)
            self._ftrl_spec = stacked_spec(params, 1)
            if "batch_stats" in variables:
                logger.warning(
                    "dp_ftrl freezes batch_stats at their init values "
                    "(only params flow through the DP release); prefer a "
                    "GroupNorm model, e.g. create_model('cifar10_cnn', "
                    "norm='group')")
        self.history: List[RoundResult] = []
        self.detector = ConvergenceDetector()

    @property
    def _round_rdp(self) -> np.ndarray:
        """One subsampled-Gaussian round's RDP vector (dp_sgd, client_dp),
        computed at first use."""
        if self._round_rdp_vec is None:
            q, steps = self._rdp_round_params()
            self._round_rdp_vec = steps * rdp_subsampled_gaussian(
                q, self.privacy.noise_multiplier,
                self.rdp_accountant.alphas)
        return self._round_rdp_vec

    def _make_dp_sgd_fn(self) -> Optional[Callable]:
        """DP-SGD's per-step gradient (``fl.privacy``) under dp_sgd, with
        the reference's choice of form and its messages; else None."""
        cfg, model = self.config, self.model
        if cfg.dp_mode != "dp_sgd":
            return None
        impl = cfg.dp_sgd_impl
        if impl not in ("auto", "ghost", "microbatch"):
            raise ValueError(f"dp_sgd_impl={impl!r} not in "
                             "('auto', 'ghost', 'microbatch')")
        if impl == "ghost" and not dp.model_supports_ghost_dp(model):
            name = getattr(model, "name", type(model).__name__)
            raise ValueError(
                f"dp_sgd_impl='ghost' but model {name!r} lacks the "
                "DP_LAYERS instrumentation contract")
        clip, z = self.privacy.max_grad_norm, self.privacy.noise_multiplier
        if impl == "ghost" or (impl == "auto"
                               and dp.model_supports_ghost_dp(model)):
            return dp.make_ghost_dp_sgd_grad_fn(model, clip, z)
        return dp.make_dp_sgd_grad_fn(model, clip, z,
                                      microbatch_size=cfg.dp_microbatch)

    def _set_ftrl_nonce(self, nonce: int) -> None:
        """The tree's nonce and its node-noise seed fold(fold(fold(root,
        DP_NOISE), low word), high word)."""
        self._ftrl_nonce = nonce
        self._ftrl_tree_seed = prng.fold(prng.fold(
            prng.stream_seed(self._root, prng.Stream.DP_NOISE),
            nonce & 0xFFFFFFFF), nonce >> 32)

    @property
    def epochs_per_client(self) -> np.ndarray:
        """Per-client epoch budgets (capability adaptation), read-only:
        assign a whole array. Budgets that differ take the masked path of
        local training; flat ones the path without masks."""
        view = self._epochs_per_client.view()
        view.flags.writeable = False
        return view

    @epochs_per_client.setter
    def epochs_per_client(self, value) -> None:
        value = np.asarray(value, np.int32)
        if value.shape != (self.num_clients,):
            raise ValueError(
                f"epochs_per_client must have shape ({self.num_clients},), "
                f"got {value.shape}")
        if np.any(value > self.config.training.local_epochs):
            raise ValueError(
                "per-client epoch budgets cannot exceed "
                f"training.local_epochs={self.config.training.local_epochs}")
        self._epochs_per_client = value

    def _is_homogeneous(self) -> bool:
        return bool(np.all(self._epochs_per_client
                           == self.config.training.local_epochs))

    # ------------------------------------------------------------------
    # the superstep
    # ------------------------------------------------------------------
    def _uplink(self, deltas, ef_state: torch.Tensor, mask: torch.Tensor):
        """Compress every client's f32 delta with error feedback: returns
        (transmitted deltas as a tree, new uplink state, EF norm)."""
        cfg = self.config
        mat, spec = stack_flatten(deltas)
        if cfg.uplink_compression == "powersgd":
            transmitted, ef_out = apply_powersgd_with_error_feedback(
                mat, ef_state, mask, self._powersgd_plan)
        else:
            uplink_fn = make_uplink_fn(
                cfg.uplink_compression, cfg.uplink_topk_ratio,
                d_valid=flat_dim(deltas))  # top-k budget on the real dim
            transmitted, ef_out = apply_uplink_with_error_feedback(
                mat, ef_state, mask, uplink_fn)
        # EF-residual norm over the EF region only (for powersgd the state
        # also carries the Q factors)
        ef_reg = ef_out[:, :mat.shape[1]]
        ef_norm = torch.sqrt(torch.sum(ef_reg * ef_reg, dim=1)).sum() \
            / self.num_clients
        return stack_unflatten(transmitted, spec), ef_out, ef_norm

    def _superstep(self, global_vars, round_idx: int,
                   mask: torch.Tensor, ef_state: torch.Tensor,
                   epochs: Optional[torch.Tensor] = None,
                   clip_norm: Optional[float] = None,
                   inject: Optional[Tuple[torch.Tensor, Any]] = None):
        """One round on the device: returns (new global variables, new
        uplink state, the new carried state (SCAFFOLD's (c, c_i), FedDyn's
        (h, g) or DP-FTRL's (prefix, noisy prefix, momentum)) or None,
        packed metrics). ``global_vars`` is ``{"params": ...}`` and, for a
        BatchNorm model, ``"batch_stats"``: the statistics travel with the
        parameters through the deltas, DP, the uplink and the aggregation,
        as in the reference. ``epochs`` is the (C,) epoch budget
        where SCAFFOLD or FedNova reads it or the budgets differ;
        ``clip_norm`` adaptive clipping's C for this round; ``inject`` the
        audit's (flags, stacked deltas)."""
        cfg = self.config
        C = self.num_clients
        feddyn = cfg.feddyn_alpha > 0
        rseed = prng.round_seed(self._root, round_idx)
        # θ̂: what clients actually receive; every delta below is measured
        # against it, and the aggregate is applied to the master
        ref_vars = (tree_map(lambda g: downlink_roundtrip(
                        g, cfg.downlink_compression), global_vars)
                    if cfg.downlink_compression != "none"
                    else global_vars)
        stacked = tree_map(lambda g: g[None].expand(C, *g.shape), ref_vars)
        pre_losses = None
        if self._qffl_eval is not None:
            # q-FFL's F_k(θ̂), before local training
            pre_losses = self._qffl_eval(
                stacked["params"], self.data.images, self.data.labels,
                self.data.num_samples)["loss"]
        corr = None
        if cfg.scaffold:
            corr = scaffold_correction(self.scaffold_c, self.scaffold_ci,
                                       self._flat_spec)
        elif feddyn:
            # FedDyn's −⟨g_i, θ⟩ term: the constant gradient addend −g_i
            # (the α-proximal term is the trainer's proximal_mu)
            corr = stack_unflatten(-self.feddyn_grads, self._flat_spec)
        extra = ({"batch_stats": stacked["batch_stats"]}
                 if "batch_stats" in stacked else None)
        out = self._local_train(
            stacked["params"], self.data.images, self.data.labels,
            self.data.num_samples, rseed,
            epochs=None if self._is_homogeneous() else epochs,
            correction=corr, extra=extra)
        new_stacked = {"params": out[0]}
        metrics = out[1]
        if extra is not None:
            new_stacked.update(out[2])
        del corr, out
        state_out = d_mat = None
        if cfg.scaffold or feddyn:
            # from the raw local trajectories
            d_mat, _ = stack_flatten(tree_map(
                lambda c, g: (c - g[None]).float(), new_stacked["params"],
                global_vars["params"]))
        if cfg.scaffold:
            # k = the steps each client took
            k_steps = epochs.float() * self._local_train.steps_per_epoch
            state_out = scaffold_update(
                self.scaffold_c, self.scaffold_ci, d_mat, mask, k_steps,
                cfg.training.learning_rate, C)
            d_mat = None

        sigma_mean = torch.zeros((), device=self.device)
        if cfg.dp_mode == "delta":
            # reference semantics (federated_trainer.py:428-469): noise
            # the local delta against θ̂ and re-add it to θ̂
            eps_r = cfg.epsilon_per_round or self.privacy.epsilon
            del_r = cfg.delta_per_round or self.privacy.delta
            deltas = tree_map(lambda c, g: c - g[None], new_stacked,
                              ref_vars)
            noisy, _, sigma = dp.dp_noise_client_deltas(
                deltas, rseed, eps_r, del_r, self.privacy.max_grad_norm)
            del deltas
            new_stacked = tree_map(lambda d, g: d + g[None], noisy,
                                   ref_vars)
            del noisy
            sigma_mean = sigma.sum() / C

        zero = torch.zeros((), device=self.device)
        next_cn = frac = zero
        ef_out = ef_state
        ef_norm = zero
        if cfg.dp_mode == "client_dp":
            new_global, sigma_mean, next_cn, frac = self._client_dp(
                global_vars, ref_vars, new_stacked, rseed, mask,
                clip_norm, inject)
            del new_stacked
        elif cfg.dp_mode == "distributed":
            new_global, sigma_mean = self._distributed(
                global_vars, ref_vars, new_stacked, rseed, mask)
            del new_stacked
        elif cfg.dp_mode == "dp_ftrl":
            new_global, state_out = self._dp_ftrl(
                global_vars, new_stacked, mask, round_idx)
            del new_stacked
            sigma_mean = torch.tensor(self._ftrl_sigma_node,
                                      dtype=torch.float32, device=self.device)
        if cfg.uplink_compression != "none":
            # the client's order: train → DP → compress → upload
            hat, ef_out, ef_norm = self._uplink(
                tree_map(lambda c, g: (c - g[None]).float(), new_stacked,
                         ref_vars), ef_state, mask)
            new_stacked = tree_map(lambda g, d: (g[None] + d).to(g.dtype),
                                   ref_vars, hat)
            del hat

        w = normalized_client_weights(self.data.num_samples, mask)
        if (cfg.dp_mode not in _CENTRAL_DP and not cfg.aggregate_batch_stats
                and "batch_stats" in new_stacked):
            # re-broadcast the REFERENCE statistics so that their delta is
            # exactly zero (the master's would leak the downlink's
            # quantization error into them)
            new_stacked = dict(new_stacked, batch_stats=tree_map(
                lambda g: g[None].expand(C, *g.shape),
                ref_vars["batch_stats"]))
        if cfg.dp_mode in _CENTRAL_DP:
            pass  # new_global is the central-DP release above
        elif feddyn:
            # FedDyn owns the server update: θ ← mean_P(θ_i) − h/α with
            # h ← h − (α/N)Σ_P Δ_i (Acar et al. 2021 Alg. 1); BatchNorm
            # models are refused when the engine is built
            pmat, pspec = stack_flatten(tree_map(lambda g: g[None].float(),
                                                 global_vars["params"]))
            new_pflat, h_out, g_out = feddyn_server_update(
                pmat[0], self.feddyn_h, self.feddyn_grads, d_mat, mask,
                cfg.feddyn_alpha, C)
            del pmat, d_mat
            state_out = (h_out, g_out)
            new_global = dict(global_vars, params=tree_map(
                lambda t, g: t[0].to(g.dtype),
                stack_unflatten(new_pflat[None], pspec),
                global_vars["params"]))
        elif cfg.qffl_q is not None:
            # loss-weighted, h-normalized step; deltas against θ̂, applied
            # to the full-precision master
            new_global = qffl_combine(
                global_vars, ref_vars, new_stacked, pre_losses, mask,
                cfg.qffl_q, cfg.training.learning_rate)
        elif cfg.aggregation != "fedavg":
            new_global = robust_combine_deltas(
                global_vars, new_stacked, mask, cfg.aggregation,
                trim_k=cfg.trim_k, krum_f=cfg.krum_f, krum_m=cfg.krum_m)
        elif cfg.secure_aggregation:
            new_global = secure_fedavg_delta(
                global_vars, new_stacked, self.data.num_samples, mask,
                rseed, neighbors=cfg.secure_agg_neighbors,
                scale=cfg.secure_agg_scale)
        else:
            w_params = w
            if cfg.fednova:
                # normalized averaging (Wang et al. 2020 eq. 6): θ + τ_eff
                # Σ p_i Δ_i / a_i; FedAvg itself when every a_i is equal.
                # a_i is a trajectory identity of the params only: the
                # statistics keep the plain sample weights
                a_i = fednova_effective_steps(
                    epochs.float() * self._local_train.steps_per_epoch,
                    cfg.training.momentum)
                tau_eff = (w * a_i).sum()
                w_params = tau_eff * w / torch.clamp(a_i, min=1e-12)
            new_global = {
                key: fedavg_delta(global_vars[key], new_stacked[key],
                                  w_params if key == "params" else w,
                                  ref_vars[key])
                for key in global_vars}
        scalars = torch.stack([
            (metrics["loss"] * w).sum(),
            (metrics["accuracy"] * w).sum(),
            global_norm(tree_map(torch.sub, new_global, global_vars)),
            global_norm(new_global),
            sigma_mean,
            ef_norm,
            next_cn,
            frac,
        ])
        per_client = [metrics["loss"], metrics["accuracy"]]
        if pre_losses is not None:
            per_client.append(pre_losses)
        packed = torch.cat([scalars] + per_client)
        return new_global, ef_out, state_out, packed

    def _client_dp(self, global_vars, ref_vars, new_stacked, rseed: int,
                   mask: torch.Tensor, clip_norm: Optional[float],
                   inject: Optional[Tuple[torch.Tensor, Any]]):
        """Client-level DP-FedAvg (``fl_tpu/orchestration/round_engine.py
        :1030-1096``): returns (new global params, σ, next C, noisy clipped
        fraction), the last two 0 unless clipping is adaptive.

        The mean divides by the FIXED expected participant count m̄ =
        max(1, q·N), never by the realized mask.sum(): with a
        data-dependent denominator the add/remove sensitivity would be
        ~2C/m and the certified ε understated ~2×; fixed, each client
        moves the mean by at most C/m̄, and σ = z·C/m̄ is noise multiplier z
        against that sensitivity, as the Poisson-subsampled RDP accounting
        at rate q assumes."""
        cfg = self.config
        C = self.num_clients
        deltas = tree_map(lambda c, g: c - g[None], new_stacked, ref_vars)
        if inject is not None:
            # audit canaries replace the flagged clients' deltas BEFORE the
            # clip: to the mechanism a canary is a client like any other
            flags, inj = inject
            deltas = tree_map(
                lambda d, i: torch.where(
                    flags.reshape((C,) + (1,) * (d.dim() - 1)) > 0,
                    i.to(d.dtype), d), deltas, inj)
        adaptive = cfg.adaptive_clipping
        cn = (torch.tensor(clip_norm, dtype=torch.float32, device=self.device)
              if adaptive else self.privacy.max_grad_norm)
        m = self._expected_count
        avg, pre_norms = dp.clipped_masked_mean(deltas, cn, mask, m)
        del deltas
        z_eff = self._z_delta if adaptive else self.privacy.noise_multiplier
        sigma = z_eff * cn / m
        nseed = prng.stream_seed(rseed, prng.Stream.DP_NOISE)
        next_cn = frac = torch.zeros((), device=self.device)
        if adaptive:
            # the noised clipped fraction drives the geometric update;
            # the aggregate and the count draw from distinct sub-streams
            b = (pre_norms <= cn).float()
            centered = (mask.float() * (b - 0.5)).sum()
            frac = dp.noisy_clipped_fraction(
                centered, m, self._clip_count_stddev, prng.fold(nseed, 1))
            next_cn = dp.geometric_clip_update(
                cn, frac, cfg.clip_quantile, cfg.clip_lr)
        noisy = dp.central_noise_tree(avg, prng.fold(nseed, 0), sigma)
        del avg
        new_global = tree_map(lambda g, d: (g + d.float()).to(g.dtype),
                              global_vars, noisy)
        sigma_t = torch.as_tensor(sigma, dtype=torch.float32,
                                  device=self.device)
        return new_global, sigma_t, next_cn, frac

    def _distributed(self, global_vars, ref_vars, new_stacked,
                     rseed: int, mask: torch.Tensor):
        """Distributed DP (``fl_tpu/orchestration/round_engine.py
        :1097-1153``): each Δ clipped to C (the scale folded into the flat
        rows), stochastically rounded to the γ grid, Skellam noise, the
        int32 modular sum, decoded over the FIXED m̄. Returns (new global
        params, σ of the decoded average). Random streams under
        fold(round, DISTRIBUTED_DP): 0 the rounding of every client's row,
        1 the per-client shares, 2 the aggregate draw."""
        plan = self._dist_plan
        deltas = tree_map(lambda c, g: c - g[None], new_stacked, ref_vars)
        norms = dp.client_norms(deltas)
        mat, spec = stack_flatten(deltas)
        del deltas
        mat.mul_(torch.clamp(plan.clip_norm / torch.clamp(norms, min=1e-12),
                             max=1.0)[:, None])
        dseed = prng.stream_seed(rseed, prng.Stream.DISTRIBUTED_DP)
        m_real = mask.sum()
        if self.config.dist_fuse_noise:
            ints = ddp.stochastic_round(mat, plan.gamma, prng.fold(dseed, 0))
            ints *= (mask > 0).to(torch.int32)[:, None]
            noise = ddp.aggregate_skellam_noise(
                prng.fold(dseed, 2), m_real.double() * (plan.mu_local / 2.0),
                mat.shape[1])
            total = ddp.wrap_int32(ints.sum(0, dtype=torch.int64) + noise)
        else:
            ints = ddp.client_integer_payloads(
                mat, mask, prng.fold(dseed, 0), prng.fold(dseed, 1),
                plan.gamma, plan.mu_local)
            total = ddp.modular_sum(ints)
        del mat, ints
        avg = ddp.decode_average(total, plan.gamma, plan.expected_clients)
        avg_tree = stack_unflatten(avg[None], spec)
        new_global = tree_map(lambda g, d: (g + d[0].float()).to(g.dtype),
                              global_vars, avg_tree)
        sigma = (plan.gamma * torch.sqrt(plan.mu_local * m_real.float())
                 / plan.expected_clients)
        return new_global, sigma

    def _dp_ftrl(self, global_vars, new_stacked, mask: torch.Tensor,
                 round_idx: int):
        """DP-FTRL (``fl_tpu/orchestration/round_engine.py:1155-1194``):
        each participant's params-Δ clipped to C, their masked SUM (no
        division: the sensitivity is per leaf), the FTRL(M) step against
        the tree-noised prefix. Only the params flow through the release:
        batch statistics stay as they were. Returns (new global variables,
        the carried (prefix, noisy prefix, momentum))."""
        global_params = global_vars["params"]
        deltas = tree_map(lambda c, g: (c - g[None]).float(),
                          new_stacked["params"], global_params)
        norms = dp.client_norms(deltas)
        cmat, _ = stack_flatten(deltas)
        del deltas
        scale = torch.clamp(self.privacy.max_grad_norm
                            / torch.clamp(norms, min=1e-12), max=1.0)
        round_sum = torch.tensordot(mask.float() * scale, cmat, dims=1)
        del cmat
        pmat, _ = stack_flatten(tree_map(lambda g: g[None].float(),
                                         global_params))
        cfg = self.config
        new_pflat, cumsum, noisy, mom = ftrl.ftrl_server_step(
            pmat[0], self.ftrl_cumsum, self.ftrl_prev_noisy,
            self.ftrl_momentum_buf, round_sum, self._ftrl_tree_seed,
            round_idx + 1, self._ftrl_sigma_node, self._ftrl_height,
            cfg.ftrl_server_lr, float(self._ftrl_cohort), cfg.ftrl_momentum)
        new_params = tree_map(lambda t, g: t[0].to(g.dtype),
                              stack_unflatten(new_pflat[None],
                                              self._ftrl_spec),
                              global_params)
        return dict(global_vars, params=new_params), (cumsum, noisy, mom)

    # ------------------------------------------------------------------
    # host round loop
    # ------------------------------------------------------------------
    def sample_participation(
        self, exclude: Optional[List[int]] = None
    ) -> np.ndarray:
        """Per-round participation mask: Bernoulli participation ×
        straggler dropout × exclusions, min_clients enforced (largest
        shards first) and max_clients capped by sample count — the
        reference's rule and random stream.

        Under client_dp the mask is PURE Poisson sampling at
        ``participation_rate`` (less dropout and exclusions, which only
        lower a client's inclusion probability): forcing and capping are
        data-dependent selections that would void the subsampling
        amplification the RDP accountant relies on, and the fixed
        denominator keeps an under-full round well defined.

        Under dp_ftrl the cohort is the deterministic round-robin
        ``fl.dp_ftrl.rotation_mask`` (DP-FTRL needs no sampling), less
        dropout and exclusions."""
        cfg = self.config
        if cfg.dp_mode == "dp_ftrl":
            mask = ftrl.rotation_mask(self.num_clients, self.round_number,
                                      self._ftrl_cohort)
            if cfg.straggler_dropout_rate > 0:
                mask *= (self._np_rng.random(self.num_clients)
                         >= cfg.straggler_dropout_rate).astype(np.float32)
            if exclude:
                mask[np.asarray(exclude, int)] = 0.0
            return mask
        mask = (self._np_rng.random(self.num_clients)
                < cfg.participation_rate).astype(np.float32)
        if cfg.straggler_dropout_rate > 0:
            mask *= (self._np_rng.random(self.num_clients)
                     >= cfg.straggler_dropout_rate).astype(np.float32)
        if exclude:
            mask[np.asarray(exclude, int)] = 0.0
        if cfg.dp_mode == "client_dp":
            return mask
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
                  evaluate: bool = True,
                  inject_flags: Optional[np.ndarray] = None,
                  inject_deltas=None) -> RoundResult:
        """Execute one FedAvg round (superstep + host bookkeeping). With
        ``audit_injection``, clients whose ``inject_flags`` (C,) entry is
        positive submit their entry of ``inject_deltas`` (a tree like
        ``global_variables`` whose leaves are stacked over C) in place of
        their trained delta."""
        return self._finalize_round(
            self._dispatch_round(mask, inject_flags, inject_deltas),
            evaluate=evaluate)

    def run_rounds_pipelined(self, num_rounds: int, evaluate: bool = False,
                             masks: Optional[np.ndarray] = None
                             ) -> List[RoundResult]:
        """``num_rounds`` rounds with depth-1 dispatch pipelining (see the
        module docstring). Adaptive clipping cannot pipeline: round r+1's
        clip norm comes from round r's metrics."""
        if self.config.adaptive_clipping:
            raise ValueError(
                "run_rounds_pipelined cannot pipeline adaptive_clipping "
                "(round r+1's clip norm comes from round r's metrics); "
                "use run_round / run")
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

    def _check_realized(self, mask: np.ndarray) -> None:
        """Robust aggregators need enough REALIZED participants (the
        config check covers the expected count only)."""
        cfg = self.config
        m = int(np.sum(np.asarray(mask) > 0))
        if cfg.aggregation == "trimmed_mean" and m - 2 * cfg.trim_k < 1:
            raise ValueError(
                f"trimmed_mean(trim_k={cfg.trim_k}) needs more than "
                f"{2 * cfg.trim_k} participants; this round realized {m}")
        if cfg.aggregation == "krum" and m < 2 * cfg.krum_f + 3:
            # Blanchard et al. 2017: resilience to f needs n ≥ 2f+3
            raise ValueError(
                f"krum(f={cfg.krum_f}) needs at least 2f+3="
                f"{2 * cfg.krum_f + 3} participants; this round "
                f"realized {m}")

    def _epochs_tensor(self) -> Optional[torch.Tensor]:
        """The (C,) epoch budgets on the device where the superstep reads
        them (SCAFFOLD, FedNova, budgets that differ), else None."""
        cfg = self.config
        if self._is_homogeneous() and not (cfg.scaffold or cfg.fednova):
            return None
        return to_device(self._epochs_per_client, self.device)

    def _carry_state(self, state_out) -> None:
        """Keep the superstep's carried state: SCAFFOLD's (c, c_i) or
        FedDyn's (h, g). The next round's superstep reads it on the
        device, so a pipelined round r+1 sees round r's."""
        if self.config.scaffold:
            self.scaffold_c, self.scaffold_ci = state_out
        elif self.config.feddyn_alpha > 0:
            self.feddyn_h, self.feddyn_grads = state_out
        elif self.config.dp_mode == "dp_ftrl":
            (self.ftrl_cumsum, self.ftrl_prev_noisy,
             self.ftrl_momentum_buf) = state_out

    def _dispatch_round(self, mask: Optional[np.ndarray] = None,
                        inject_flags: Optional[np.ndarray] = None,
                        inject_deltas=None) -> _PendingRound:
        """Budget check and charge, then enqueue the superstep; does not
        wait for the device."""
        cfg = self.config
        t0 = time.perf_counter()
        if mask is None:
            mask = self.sample_participation()
        self._check_realized(mask)
        rdp_mode = cfg.dp_mode in _SUBSAMPLED_GAUSSIAN
        charge = (self.budget_tracker is not None
                  and cfg.dp_mode == "delta")
        dist_rdp = None
        if cfg.dp_mode == "dp_ftrl":
            self._ftrl_gate(mask)
        if rdp_mode:
            self._client_dp_gate()
        elif cfg.dp_mode == "distributed":
            dist_rdp = self._distributed_gate(mask)
        elif charge:
            eps_r = cfg.epsilon_per_round or self.privacy.epsilon
            del_r = cfg.delta_per_round or self.privacy.delta
            if self.budget_tracker.is_budget_exhausted(eps_r, del_r):
                raise dp.PrivacyError(
                    "Privacy budget exhausted — cannot run another DP round")

        inject = None
        if cfg.audit_injection:
            # no flags: nothing is replaced (the reference passes an
            # all-zero (C, ...) tree instead, a no-op at 0.86 GB)
            if inject_flags is not None:
                if inject_deltas is None:
                    raise ValueError("inject_flags passed without "
                                     "inject_deltas")
                inject = (
                    torch.as_tensor(np.asarray(inject_flags, np.float32)
                                    ).to(self.device),
                    tree_map(lambda t: torch.as_tensor(t).to(self.device),
                             inject_deltas))
        elif inject_flags is not None:
            raise ValueError(
                "inject_flags passed but config.audit_injection is off")
        elif inject_deltas is not None:
            raise ValueError(
                "inject_deltas passed but config.audit_injection is off")

        round_clip = self.clip_norm  # the C this round uses (adaptive)
        mask_t = to_device(np.asarray(mask, np.float32), self.device)
        old_vars = self.global_variables
        new_global, self.uplink_error, state_out, metrics = self._superstep(
            old_vars, self.round_number, mask_t, self.uplink_error,
            self._epochs_tensor(), round_clip, inject)
        self._carry_state(state_out)
        if cfg.dp_mode == "dp_ftrl":
            self.ftrl_participations += (np.asarray(mask) > 0)
        if self._server_opt is not None:
            # a server step on the pseudo-gradient θ − θ_fedavg, params
            # only (batch statistics keep the FedAvg result)
            old_params = old_vars["params"]
            if self.server_opt_state is None:
                self.server_opt_state = self._server_opt.init(old_params)
            new_params, self.server_opt_state = self._server_opt.update(
                old_params, new_global["params"], self.server_opt_state)
            new_global = dict(new_global, params=new_params)
        self.global_variables = new_global

        eps_spent = 0.0
        ledger = None
        rn = self.round_number
        if rdp_mode:
            eps_spent, ledger = self._client_dp_charge(rn, round_clip)
        elif cfg.dp_mode == "distributed":
            eps_spent, ledger = self._distributed_charge(rn, dist_rdp, mask)
        elif cfg.dp_mode == "dp_ftrl":
            eps_spent = self._ftrl_charge(rn)
        elif charge:
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
                             eps_spent=eps_spent, round_clip=round_clip,
                             ledger=ledger)

    # ------------------------------------------------------------------
    # DP accounting (host)
    # ------------------------------------------------------------------
    def _rdp_round_params(self) -> Tuple[float, int]:
        """(sampling rate q, mechanism invocations) of one round's RDP
        step. dp_sgd: example level, q = batch/shard, one invocation a
        local step (padded slots are masked out of the DP gradient, so a
        real example's inclusion probability a step is exactly q; shuffle
        sampling accounted as Poisson, as opacus and tf-privacy do).
        client_dp: client level, q = the participation rate, ONE
        invocation a round (the central noised aggregate)."""
        cfg = self.config
        if cfg.dp_mode == "client_dp":
            return min(1.0, cfg.participation_rate), 1
        t = cfg.training
        steps_per_epoch = max(1, self.data.samples_per_client
                              // t.batch_size)
        q = t.batch_size / max(self.data.samples_per_client, 1)
        return q, t.local_epochs * steps_per_epoch

    def _pld_step_budget(self) -> int:
        """Max mechanism invocations the PLD curve certifies under
        (privacy.epsilon, privacy.delta) at this engine's (q, z): doubling
        + bisection on the pessimistic bound at the configured grid,
        computed at first use and cached."""
        if self._pld_max_steps is not None:
            return self._pld_max_steps
        from fl_tpu_torch.fl.pld import compute_epsilon_pld

        q, _ = self._rdp_round_params()
        z = self.privacy.noise_multiplier
        eps, delt, dt = (self.privacy.epsilon, self.privacy.delta,
                         self.config.pld_dt)
        if compute_epsilon_pld(1, q, z, delt, dt) > eps:
            self._pld_max_steps = 0
            return 0
        lo, hi = 1, 2
        while compute_epsilon_pld(hi, q, z, delt, dt) <= eps:
            lo, hi = hi, hi * 2
            if hi > 1 << 24:
                break
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if compute_epsilon_pld(mid, q, z, delt, dt) <= eps:
                lo = mid
            else:
                hi = mid
        self._pld_max_steps = lo
        return lo

    def certified_epsilon(self, delta: Optional[float] = None,
                          dt: Optional[float] = None) -> float:
        """ε certified for everything released so far, by the configured
        accountant: under 'pld' the tight PLD of the steps taken (on the
        gate's grid unless ``dt`` is given), under 'rdp' the moments
        accountant's value, else the additive ledger's total."""
        delta = self.privacy.delta if delta is None else delta
        if self.config.accountant == "pld":
            from fl_tpu_torch.fl.pld import compute_epsilon_pld

            dt = self.config.pld_dt if dt is None else dt
            q, _ = self._rdp_round_params()
            return compute_epsilon_pld(
                self._pld_steps_taken, q,
                self.privacy.noise_multiplier, delta, dt)
        if self.rdp_accountant is not None:
            return self.rdp_accountant.get_epsilon(delta)
        return self.accountant.get_total_privacy_cost()[0]

    def _client_dp_gate(self) -> None:
        """Refuse a client_dp or dp_sgd round that would overdraw ε: the
        PLD step budget under 'pld', else the RDP ε projected on a copy of
        the accountant."""
        cfg = self.config
        _, steps = self._rdp_round_params()
        if cfg.accountant == "pld":
            if self._pld_steps_taken + steps > self._pld_step_budget():
                raise dp.PrivacyError(
                    f"Privacy budget exhausted — the next {cfg.dp_mode} "
                    f"round would exceed ε={self.privacy.epsilon} "
                    "(PLD accounting: "
                    f"{self._pld_steps_taken}+{steps} steps > "
                    f"{self._pld_step_budget()} certified)")
            return
        projected = copy.deepcopy(self.rdp_accountant)
        projected.accumulate(self._round_rdp)
        if projected.get_epsilon(self.privacy.delta) > self.privacy.epsilon:
            raise dp.PrivacyError(
                f"Privacy budget exhausted — the next {cfg.dp_mode} "
                f"round would exceed ε={self.privacy.epsilon} "
                "(RDP accounting)")

    def _client_dp_charge(self, rn: int, round_clip: Optional[float]):
        """Charge one client_dp or dp_sgd round to the RDP accountant and
        the PLD step count; returns (ε spent, the deferred ledger entry,
        which records the round's σ: client_dp's measured one once its
        metrics are on the host, dp_sgd's z·C/B)."""
        cfg = self.config
        q, steps = self._rdp_round_params()
        self._pld_steps_taken += steps
        before = (self.rdp_accountant.get_epsilon(self.privacy.delta)
                  if rn > 0 else 0.0)
        self.rdp_accountant.accumulate(self._round_rdp)
        total_eps = self.rdp_accountant.get_epsilon(self.privacy.delta)
        eps_spent = total_eps - before

        def ledger(m, _eps=eps_spent, _tot=total_eps):
            self.accountant.add_mechanism(
                "subsampled_gaussian", _eps, 0.0,
                sensitivity=(round_clip if round_clip is not None
                             else self.privacy.max_grad_norm),
                noise_scale=(m["dp_sigma_mean"]
                             if cfg.dp_mode == "client_dp"
                             else (self.privacy.noise_multiplier
                                   * self.privacy.max_grad_norm
                                   / cfg.training.batch_size)),
                metadata={"round": rn, "mode": cfg.dp_mode,
                          "total_epsilon": _tot, "q": q, "steps": steps})

        return eps_spent, ledger

    def _distributed_gate(self, mask: np.ndarray) -> np.ndarray:
        """The Skellam RDP of this round at its REALIZED participant count
        (fewer participants, less summed noise, a bigger charge); refuses
        a round that would overdraw ε. Returns the round's RDP vector."""
        dist_rdp = self._dist_plan.round_rdp(
            int(np.sum(np.asarray(mask) > 0)))
        projected = copy.deepcopy(self.rdp_accountant)
        projected.accumulate(dist_rdp)
        if projected.get_epsilon(self.privacy.delta) > self.privacy.epsilon:
            raise dp.PrivacyError(
                "Privacy budget exhausted — the next distributed-DP "
                f"round would exceed ε={self.privacy.epsilon} "
                "(Skellam RDP accounting)")
        return dist_rdp

    def _distributed_charge(self, rn: int, dist_rdp: np.ndarray,
                            mask: np.ndarray):
        """Charge one distributed round's Skellam RDP; returns (ε spent,
        the deferred ledger entry)."""
        before = (self.rdp_accountant.get_epsilon(self.privacy.delta)
                  if rn > 0 else 0.0)
        self.rdp_accountant.accumulate(dist_rdp)
        total_eps = self.rdp_accountant.get_epsilon(self.privacy.delta)
        eps_spent = total_eps - before
        m_real = int(np.sum(np.asarray(mask) > 0))
        plan = self._dist_plan

        def ledger(m, _eps=eps_spent, _tot=total_eps, _m=m_real):
            self.accountant.add_mechanism(
                "skellam_distributed", _eps, 0.0,
                sensitivity=plan.clip_norm,
                noise_scale=plan.central_sigma_float(_m),
                metadata={"round": rn, "mode": self.config.dp_mode,
                          "total_epsilon": _tot, "realized_clients": _m,
                          "bits": plan.bits,
                          "mu_central": plan.mu_local * max(_m, 0)})

        return eps_spent, ledger

    def _ftrl_gate(self, mask: np.ndarray) -> None:
        """Refuse a dp_ftrl round past the tree (T_max fixed its height
        and sensitivity) or one that would take a client past its
        participation budget k."""
        cfg = self.config
        if self.round_number >= cfg.ftrl_rounds:
            raise dp.PrivacyError(
                f"dp_ftrl tree exhausted: ftrl_rounds={cfg.ftrl_rounds} "
                "fixed the tree height and sensitivity; running more "
                "rounds would exceed the certified ε. Start a new "
                "engine to continue (tree restart) — and let it draw "
                "a FRESH ftrl_tree_nonce (the default): reusing a "
                "nonce across trees reuses node noise, which "
                "differencing would cancel.")
        would = self.ftrl_participations + (np.asarray(mask) > 0)
        if int(would.max()) > cfg.ftrl_max_participations:
            over = np.flatnonzero(would > cfg.ftrl_max_participations)[:8]
            raise dp.PrivacyError(
                "dp_ftrl participation budget exceeded: clients "
                f"{over.tolist()} would pass max_participations="
                f"{cfg.ftrl_max_participations}, which the certified "
                "sensitivity C*sqrt(k*h) assumed. Use rotation masks "
                "(fl_tpu.fl.dp_ftrl.rotation_mask) or raise k (and "
                "re-derive the noise).")

    def _ftrl_charge(self, rn: int) -> float:
        """The whole tree is one Gaussian mechanism certified up front:
        charged once, at round 0. Returns the round's ε."""
        if rn != 0:
            return 0.0
        cfg = self.config
        eps = self._ftrl_eps_total
        if self.budget_tracker is not None:
            self.budget_tracker.consume_budget(eps, self.privacy.delta,
                                               "dp_ftrl_tree")
        self.accountant.add_mechanism(
            "tree_gaussian", eps, self.privacy.delta,
            sensitivity=ftrl.ftrl_sensitivity(
                self.privacy.max_grad_norm, cfg.ftrl_rounds,
                cfg.ftrl_max_participations),
            noise_scale=self._ftrl_sigma_node,
            metadata={"mode": "dp_ftrl", "t_max": cfg.ftrl_rounds,
                      "k": cfg.ftrl_max_participations,
                      "height": self._ftrl_height,
                      "z": self.privacy.noise_multiplier})
        return eps

    def _finalize_round(self, pending: _PendingRound,
                        evaluate: bool = True,
                        packed: Optional[np.ndarray] = None) -> RoundResult:
        """Blocking half of a round: one host copy of the packed metrics
        (unless ``packed`` holds them already), then the bookkeeping that
        needs them."""
        if packed is None:
            packed = pending.metrics.cpu().numpy()
        metrics = {k: float(v) for k, v in zip(_SCALARS, packed)}
        if self.config.adaptive_clipping:
            self.clip_norm = metrics["next_clip_norm"]
        if pending.ledger is not None:
            pending.ledger(metrics)

        test_loss = test_acc = None
        if evaluate and self.test_images is not None:
            ev = evaluate_test_set(
                self.model, pending.variables["params"], self.test_images,
                self.test_labels,
                batch_stats=pending.variables.get("batch_stats"))
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
            clip_norm=pending.round_clip,
            uplink_ef_norm=(metrics["uplink_ef_norm"]
                            if self.config.uplink_compression != "none"
                            else None),
        )
        self._keep_client_metrics(packed)
        self.history.append(result)
        return result

    def _keep_client_metrics(self, packed: np.ndarray) -> None:
        """The per-client series of one round's packed metrics: losses and
        accuracies (only participants' are meaningful) and, under q-FFL,
        F_k(θ̂) at the received model (valid for every client)."""
        n, C = len(_SCALARS), self.num_clients
        self.last_client_losses = packed[n:n + C]
        self.last_client_accuracies = packed[n + C:n + 2 * C]
        if self.config.qffl_q is not None:
            self.last_client_pre_losses = packed[n + 2 * C:n + 3 * C]

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

    # ------------------------------------------------------------------
    # fused multi-round execution
    # ------------------------------------------------------------------
    def run_rounds_fused(self, num_rounds: int,
                         masks: Optional[np.ndarray] = None,
                         evaluate: bool = True,
                         evaluate_every: Optional[int] = None
                         ) -> List[RoundResult]:
        """``num_rounds`` rounds dispatched back to back with ONE
        device→host copy, of the stacked per-round metrics, at the end: no
        host round trip between rounds.

        The (R, C) masks are sampled first (or given), the realized-
        participant checks run on each, and the budget for all R rounds is
        checked before anything is dispatched (the (ε, δ) ledger under
        "delta"; the RDP projection under "client_dp" and "dp_sgd", and
        the PLD step budget under accountant "pld"; the Skellam RDP at
        each mask's realized count under "distributed"). Then each round is dispatched and
        charged as ``run_round`` does, each round's ε the RDP marginal at
        its composition depth, and finalized from its row of the one copy;
        the test set is evaluated once, after the last round. With
        ``evaluate_every`` < R the rounds run in chunks of that many.
        Refuses the configurations whose round state the host carries
        between rounds."""
        cfg = self.config
        if cfg.scaffold:
            raise ValueError(
                "run_rounds_fused does not support scaffold (the control-"
                "variate state is carried on the host between rounds); "
                "use run_round / run")
        if cfg.feddyn_alpha > 0:
            raise ValueError(
                "run_rounds_fused does not support feddyn (the g_i/h "
                "state is carried on the host between rounds); use "
                "run_round / run")
        if cfg.dp_mode == "dp_ftrl":
            raise ValueError(
                "run_rounds_fused does not support dp_ftrl (mechanism "
                "state and the participation ledger are carried on the "
                "host between rounds); use run_round / run")
        if self._server_opt is not None:
            raise ValueError(
                "run_rounds_fused does not support a server optimizer "
                "(its state lives on the host between rounds); use "
                "run_round / run")
        if cfg.adaptive_clipping:
            raise ValueError(
                "run_rounds_fused does not support adaptive_clipping (the "
                "clip norm is host-carried round state); use run_round / "
                "run")
        if cfg.audit_injection:
            raise ValueError(
                "run_rounds_fused does not support audit_injection (canary "
                "deltas are per-round host inputs); use run_round / run")
        if masks is None:
            masks = np.stack([self.sample_participation()
                              for _ in range(num_rounds)])
        masks = np.asarray(masks, np.float32)
        if masks.shape != (num_rounds, self.num_clients):
            raise ValueError(
                f"masks must have shape ({num_rounds}, {self.num_clients}), "
                f"got {masks.shape}")
        if evaluate_every is not None and evaluate_every < 1:
            raise ValueError(
                f"evaluate_every must be >= 1, got {evaluate_every}")
        if evaluate_every is not None and evaluate_every < num_rounds:
            results: List[RoundResult] = []
            for start in range(0, num_rounds, evaluate_every):
                chunk = masks[start:start + evaluate_every]
                results.extend(self.run_rounds_fused(
                    len(chunk), masks=chunk, evaluate=evaluate))
            return results
        if num_rounds == 0:
            return []
        for mask in masks:
            self._check_realized(mask)

        # the budget for all R rounds, before anything is dispatched
        if cfg.dp_mode in _SUBSAMPLED_GAUSSIAN:
            _, steps = self._rdp_round_params()
            projected = copy.deepcopy(self.rdp_accountant)
            for _ in range(num_rounds):
                projected.accumulate(self._round_rdp)
            if projected.get_epsilon(self.privacy.delta) > self.privacy.epsilon:
                raise dp.PrivacyError(
                    f"{num_rounds} {cfg.dp_mode} rounds would exceed "
                    f"ε={self.privacy.epsilon} (RDP accounting)")
            if (cfg.accountant == "pld" and self._pld_steps_taken
                    + steps * num_rounds > self._pld_step_budget()):
                raise dp.PrivacyError(
                    f"{num_rounds} {cfg.dp_mode} rounds would exceed "
                    f"ε={self.privacy.epsilon} (PLD accounting: "
                    f"{self._pld_steps_taken}+{steps * num_rounds} steps > "
                    f"{self._pld_step_budget()} certified)")
        elif cfg.dp_mode == "distributed":
            # the Skellam RDP of each round at its realized count
            projected = copy.deepcopy(self.rdp_accountant)
            for mask in masks:
                projected.accumulate(self._dist_plan.round_rdp(
                    int(np.sum(mask > 0))))
            if projected.get_epsilon(self.privacy.delta) > self.privacy.epsilon:
                raise dp.PrivacyError(
                    f"{num_rounds} distributed-DP rounds would exceed "
                    f"ε={self.privacy.epsilon} (Skellam RDP accounting)")
        elif self.budget_tracker is not None and cfg.dp_mode == "delta":
            eps_r = cfg.epsilon_per_round or self.privacy.epsilon
            del_r = cfg.delta_per_round or self.privacy.delta
            if self.budget_tracker.is_budget_exhausted(eps_r * num_rounds,
                                                       del_r * num_rounds):
                raise dp.PrivacyError(
                    f"{num_rounds} DP rounds would exhaust the privacy "
                    "budget")

        pending = [self._dispatch_round(m) for m in masks]
        packed = torch.stack([p.metrics for p in pending]).cpu().numpy()
        results = [self._finalize_round(p, evaluate=False, packed=row)
                   for p, row in zip(pending, packed)]
        if evaluate and self.test_images is not None:
            ev = self.evaluate()
            results[-1].test_loss = ev["loss"]
            results[-1].test_accuracy = ev["accuracy"]
        return results

    # ------------------------------------------------------------------
    def profile_round(self, trace_dir: str,
                      mask: Optional[np.ndarray] = None) -> RoundResult:
        """Run one round under ``torch.profiler`` (host and, on a GPU, the
        device's activity) and write its Chrome trace into ``trace_dir``
        as ``round_<n>.trace.json`` (Perfetto or chrome://tracing read
        it); the path is kept in ``last_trace_path``."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            result = self.run_round(mask=mask, evaluate=False)
        path = os.path.join(trace_dir,
                            f"round_{result.round_number:08d}.trace.json")
        prof.export_chrome_trace(path)
        self.last_trace_path = path
        logger.info("profiler trace for round %d written to %s",
                    result.round_number, path)
        return result

    # ------------------------------------------------------------------
    def evaluate(self) -> Dict[str, float]:
        if self.test_images is None:
            raise ValueError("No test set configured")
        return evaluate_test_set(
            self.model, self.global_variables["params"], self.test_images,
            self.test_labels,
            batch_stats=self.global_variables.get("batch_stats"))

    def evaluate_federated(self) -> Dict[str, Any]:
        """Score the current global model on every client's own shard:
        per-client loss / accuracy, the sample-weighted aggregate and the
        fairness spread (see fl_tpu_torch.fl.federated_eval)."""
        return evaluate_federated(self)

    def evaluate_personalized(self, finetune_epochs: int = 1,
                              finetune_fraction: float = 0.8
                              ) -> Dict[str, Any]:
        """Per-client fine-tune gain on held-out shard tails, all clients
        at once (see fl_tpu_torch.fl.personalization)."""
        return evaluate_personalization(
            self, finetune_epochs=finetune_epochs,
            finetune_fraction=finetune_fraction)

    def get_model_weights(self) -> Dict[str, torch.Tensor]:
        """The global model as a flat ``{"params/conv1/kernel": tensor,
        "batch_stats/bn1/mean": ...}`` dict, the keys of the reference's
        ``FLModel.get_model_weights`` (copies: the engine's own tensors
        stay its own)."""
        return {k: v.detach().clone() for k, v in
                get_model_weights(self.global_variables).items()}

    def set_model_weights(self, weights: Dict[str, Any]) -> None:
        """Replace the global model from a flat weight dict of the same
        keys and shapes (numpy arrays or tensors); a mismatch raises."""
        current = get_model_weights(self.global_variables)
        assert_same_structure(current, weights)
        def leaf(v, like):
            t = v if isinstance(v, torch.Tensor) else torch.tensor(
                np.asarray(v))
            return t.to(device=self.device, dtype=like.dtype).clone()

        self.global_variables = unflatten_dict(
            {k: leaf(v, current[k]) for k, v in weights.items()})
