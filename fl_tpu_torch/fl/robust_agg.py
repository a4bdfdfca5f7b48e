"""Byzantine-robust aggregation: coordinate trimmed mean, median, Krum
(port of the device path of ``fl_tpu.fl.robust_agg``).

FedAvg's weighted mean has breakdown point zero: one client with an
enormous update moves the global model anywhere. These aggregators bound
that influence, over participants and UNWEIGHTED (sample counts are the
attacker's to forge):

- coordinate-wise trimmed mean (Yin et al. 2018): per coordinate, drop the
  k largest and k smallest participant values, average the rest;
- coordinate-wise median: the mean of the two middle values for an even
  count (``torch.median`` would return the lower one);
- (multi-)Krum (Blanchard et al. 2017): score each update by the sum of its
  squared distances to its n − f − 2 nearest participants, average the m
  lowest-scoring updates; ties in the score keep client order (a stable
  argsort, as ``jnp.argsort``).

Updates live as the (C, D) flat matrix of ``ops.flatten``. Trim and median
are one sort along the client axis with non-participants set to 3e38, so
they sort past every real value. Krum's distances are one Gram product,
‖a‖² + ‖b‖² − 2⟨a, b⟩, which cancels: it is computed in full f32, never
TF32, whatever ``torch.backends.cuda.matmul.allow_tf32`` says.

Plain PyTorch, as the reference's is XLA. :class:`RobustAggregator` is
the deployment coordinator's host class (ref: ``RobustAggregator``,
``fl_tpu/fl/robust_agg.py:103-230``): a drop-in for
``fl.fedavg.FedAvgAggregator`` that combines full client weight dicts with
these rules on its device.
"""

from __future__ import annotations

import contextlib
import time

import torch

from fl_tpu_torch.core.pytree import tree_map
from fl_tpu_torch.ops.flatten import stack_flatten, stack_unflatten

ROBUST_AGGREGATORS = ("fedavg", "trimmed_mean", "median", "krum")

_BIG = 3.0e38  # sorts past any real update coordinate


def _masked_sorted(mat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each column sorted over the client axis, non-participants last."""
    gone = (mask <= 0.0)[:, None]
    return torch.sort(torch.where(gone, _BIG, mat), dim=0).values


def trimmed_mean_matrix(mat: torch.Tensor, mask: torch.Tensor,
                        trim_k: int) -> torch.Tensor:
    """(C, D) -> (D,) coordinate-wise trimmed mean over participants,
    dropping the ``trim_k`` smallest and largest values of each column.
    Needs m − 2·trim_k ≥ 1 (the engine checks it)."""
    C = mat.shape[0]
    m = int((mask > 0.0).sum())
    s = _masked_sorted(mat, mask)  # participants occupy rows [0, m)
    idx = torch.arange(C, device=mat.device)[:, None]
    keep = (idx >= trim_k) & (idx < m - trim_k)
    kept = torch.where(keep, s, 0.0).sum(0)
    return kept / float(max(m - 2 * trim_k, 1))


def median_matrix(mat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(C, D) -> (D,) coordinate-wise median over participants."""
    m = int((mask > 0.0).sum())
    s = _masked_sorted(mat, mask)
    lo, hi = max((m - 1) // 2, 0), max(m // 2, 0)
    return 0.5 * (s[lo] + s[hi])


@contextlib.contextmanager
def full_f32_matmul():
    """TF32 off for CUDA products inside the block, as it was after."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def pairwise_sq_distances(mat: torch.Tensor) -> torch.Tensor:
    """(C, D) -> (C, C) squared distances ‖x_i‖² + ‖x_j‖² − 2⟨x_i, x_j⟩,
    the Gram product in full f32, clamped at 0."""
    sq = (mat * mat).sum(1)
    with full_f32_matmul():
        gram = mat @ mat.T
    return torch.clamp(sq[:, None] + sq[None, :] - 2.0 * gram, min=0.0)


def krum_select(mat: torch.Tensor, mask: torch.Tensor, f: int,
                m_select: int = 1) -> torch.Tensor:
    """The indices of the ``m_select`` participants of lowest Krum score
    (the sum of the squared distances to their n − f − 2 nearest
    participants), lowest first, ties in client order."""
    C = mat.shape[0]
    alive = mask > 0.0
    n = int(alive.sum())
    d2 = pairwise_sq_distances(mat)
    # distances touching a non-participant (or self) never count
    eye = torch.eye(C, dtype=torch.bool, device=mat.device)
    invalid = (~alive)[:, None] | (~alive)[None, :] | eye
    d2 = torch.where(invalid, _BIG, d2)
    d2_sorted = torch.sort(d2, dim=1).values
    k_near = max(n - f - 2, 1)
    scores = d2_sorted[:, :k_near].sum(1)
    scores = torch.where(alive, scores, _BIG)
    order = torch.argsort(scores, stable=True)
    return order[:min(m_select, n)]


def krum_matrix(mat: torch.Tensor, mask: torch.Tensor, f: int,
                m_select: int = 1) -> torch.Tensor:
    """(C, D) -> (D,): multi-Krum over participants, the mean of the
    :func:`krum_select` rows; ``m_select`` = 1 is classic Krum."""
    picked = mat[krum_select(mat, mask, f, m_select)]
    return picked.sum(0) / float(max(picked.shape[0], 1))


class RobustAggregator:
    """Host-tier robust aggregator for the deployment coordinator: a
    drop-in for :class:`fl_tpu_torch.fl.fedavg.FedAvgAggregator` (the gRPC
    servicer accepts any object with its ``aggregate_updates`` surface)
    that combines full client weight dicts with trimmed mean / median /
    Krum.

    Works on FULL weights, no reference model needed: all three rules are
    shift-equivariant (per-coordinate sort order is invariant to adding
    the common global θ_g, and Krum's pairwise distances satisfy
    ‖θ_i−θ_j‖ = ‖Δ_i−Δ_j‖), so combining full weights equals θ_g +
    combining deltas. Sample counts are IGNORED by design
    (attacker-controlled metadata). ``device``: where the rules run; None
    is the card.
    """

    def __init__(self, method: str = "median", trim_k: int = 1,
                 krum_f: int = 1, krum_m: int = 1, min_clients: int = 2,
                 validate_updates: bool = True, device=None):
        if method not in ("trimmed_mean", "median", "krum"):
            raise ValueError(
                f"method={method!r} not in "
                "('trimmed_mean', 'median', 'krum')")
        # fail at config time: aggregation triggers at exactly
        # min_clients, so the threshold itself must be feasible
        if method == "trimmed_mean" and min_clients - 2 * trim_k < 1:
            raise ValueError(
                f"trimmed_mean(trim_k={trim_k}) needs min_clients >= "
                f"{2 * trim_k + 1}, got {min_clients}")
        if method == "krum" and min_clients < 2 * krum_f + 3:
            raise ValueError(
                f"krum(f={krum_f}) needs min_clients >= 2f+3="
                f"{2 * krum_f + 3} (Blanchard et al. resilience "
                f"condition), got {min_clients}")
        from fl_tpu_torch.fl.fedavg import FedAvgAggregator

        self.method = method
        self.trim_k = trim_k
        self.krum_f = krum_f
        self.krum_m = krum_m
        # the host facade's validation, filter and history machinery
        self._base = FedAvgAggregator(
            min_clients=min_clients, validate_updates=validate_updates,
            device=device)
        self.device = self._base.device
        self.min_clients = min_clients

    @property
    def aggregation_history(self):
        # a property, not an alias: _record_stats REASSIGNS the base list
        # when it truncates the history
        return self._base.aggregation_history

    # -- FedAvgAggregator API surface ----------------------------------
    def validate_update(self, update):
        return self._base.validate_update(update)

    def calculate_convergence_metrics(self, old_model, new_model):
        return self._base.calculate_convergence_metrics(old_model,
                                                        new_model)

    def get_aggregation_stats(self):
        return self._base.get_aggregation_stats()

    def aggregate_updates(self, updates, weights=None):
        from fl_tpu_torch.core.types import GlobalModel
        from fl_tpu_torch.fl.fedavg import FedAvgError, weight_tensor

        del weights  # robust rules are unweighted by design
        t0 = time.perf_counter()
        if not updates:
            raise FedAvgError("No model updates provided")
        valid = self._base._filter_updates(updates)
        m = len(valid)
        if m < self.min_clients:
            raise FedAvgError(
                f"Insufficient valid updates: {m} < {self.min_clients}")
        if self.method == "trimmed_mean" and m - 2 * self.trim_k < 1:
            raise FedAvgError(
                f"trimmed_mean(trim_k={self.trim_k}) needs more than "
                f"{2 * self.trim_k} updates; got {m}")
        if self.method == "krum" and m < 2 * self.krum_f + 3:
            # Blanchard et al. 2017's resilience condition n >= 2f+3
            raise FedAvgError(
                f"krum(f={self.krum_f}) needs at least 2f+3="
                f"{2 * self.krum_f + 3} updates; got {m}")

        keys = list(valid[0].model_weights.keys())
        stacked = {
            k: torch.stack([weight_tensor(u.model_weights[k], self.device)
                            .float() for u in valid])
            for k in keys
        }
        mat, spec = stack_flatten(stacked)
        del stacked
        mask = torch.ones((m,), dtype=torch.float32, device=self.device)
        if self.method == "trimmed_mean":
            combined = trimmed_mean_matrix(mat, mask, self.trim_k)
        elif self.method == "median":
            combined = median_matrix(mat, mask)
        else:
            combined = krum_matrix(mat, mask, self.krum_f, self.krum_m)
        tree = stack_unflatten(combined[None], spec)
        averaged = {k: v[0] for k, v in tree.items()}

        acc_metrics = {}
        reported = [u.training_metrics.accuracy for u in valid
                    if u.training_metrics is not None]
        if reported:  # UNWEIGHTED mean: counts are attacker-controlled
            acc_metrics["train_accuracy"] = float(
                sum(reported) / len(reported))
        avg_loss = float(sum(u.training_loss for u in valid) / m)
        self._base._record_stats(
            valid, [1.0 / m] * m,
            int(sum(u.num_samples for u in valid)), avg_loss,
            time.perf_counter() - t0)
        return GlobalModel(
            round_number=valid[0].round_number,
            model_weights=averaged,
            accuracy_metrics=acc_metrics,
            participating_clients=[u.client_id for u in valid],
            convergence_score=0.0,
        )


def robust_combine_deltas(global_params, new_stacked, mask: torch.Tensor,
                          method: str, trim_k: int = 1, krum_f: int = 1,
                          krum_m: int = 1):
    """The robust aggregate of the stacked client models' deltas against
    the global model, added to it: the new global parameters."""
    deltas = tree_map(lambda c, g: (c - g[None]).float(), new_stacked,
                      global_params)
    mat, spec = stack_flatten(deltas)
    del deltas
    mask = mask.float()
    if method == "trimmed_mean":
        combined = trimmed_mean_matrix(mat, mask, trim_k)
    elif method == "median":
        combined = median_matrix(mat, mask)
    elif method == "krum":
        combined = krum_matrix(mat, mask, krum_f, krum_m)
    else:
        raise ValueError(f"unknown robust aggregator: {method!r}")
    delta = stack_unflatten(combined[None], spec)
    return tree_map(lambda g, d: (g + d[0].float()).to(g.dtype),
                    global_params, delta)
