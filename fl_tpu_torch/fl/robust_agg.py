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

Plain PyTorch, as the reference's is XLA. The host aggregator class of the
reference is not ported here.
"""

from __future__ import annotations

import contextlib

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
def _full_f32_matmul():
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
    with _full_f32_matmul():
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
