"""q-FedAvg: fair resource allocation as a reweighted FedAvg reduction
(port of ``fl_tpu.fl.qffl``).

Li et al. 2020, "Fair Resource Allocation in Federated Learning", Algorithm
2. The global objective Σ_k (p_k / (q+1)) · F_k(θ)^{q+1} weighs the
worst-served clients up; q = 0 is uniform FedAvg. A round of ordinary
local training becomes a step on it:

    Δw_k = L · (θ̂ − w̄_k)            L = 1/lr
    Δ_k  = F_k(θ̂)^q · Δw_k           F_k(θ̂): client k's loss at the model
                                      it received, before local training
    h_k  = q·F_k^{q−1}·‖Δw_k‖² + L·F_k^q
    θ⁺   = θ − Σ_participants Δ_k / Σ_participants h_k

The per-client deltas are one (C, D_pad) matrix (``ops.flatten``): the
numerator is one masked, loss-weighted product with it, the denominator a
masked sum.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from fl_tpu_torch.core.pytree import tree_map
from fl_tpu_torch.ops.flatten import stack_flatten, stack_unflatten

# floor for F_k before the q / (q−1) powers: a client with exactly zero
# loss would otherwise produce h_k = q·0^{q−1}·‖Δw‖² = inf for q < 1 and
# kill the whole round's denominator
_LOSS_FLOOR = 1e-12


def qffl_combine(global_params, ref_params, new_stacked,
                 pre_losses: torch.Tensor, mask: torch.Tensor, q: float,
                 lr: float, psum_: Optional[Callable] = None):
    """One q-FedAvg server step (Alg. 2 lines 7-9) on params trees:
    ``new_stacked`` the clients' trained (C, ...) params, ``ref_params``
    the model they received (θ̂; differs from ``global_params`` only under
    downlink compression), ``pre_losses`` (C,) F_k(θ̂), ``mask`` (C,). The
    step is applied to the full-precision ``global_params``. On a shard of
    the client axis the stacked rows, losses and mask are the shard's and
    ``psum_`` sums the numerator and the denominator over the shards."""
    psum_ = psum_ or (lambda x: x)
    L = 1.0 / float(lr)
    F = torch.clamp(pre_losses.float(), min=_LOSS_FLOOR)
    Fq = F ** q

    # Δw_k = L(θ̂ − w̄_k) as one (C, D_pad) matrix
    dmat, _ = stack_flatten(tree_map(
        lambda r, c: (r[None] - c).float() * L, ref_params, new_stacked))
    norms2 = torch.sum(dmat * dmat, dim=1)             # (C,) ‖Δw_k‖²

    h = q * F ** (q - 1.0) * norms2 + L * Fq           # (C,)
    denom = psum_(torch.sum(h * mask))
    numer = psum_(torch.tensordot(Fq * mask, dmat, dims=1))  # (D_pad,)
    del dmat
    step = numer / torch.clamp(denom, min=1e-30)

    pmat, pspec = stack_flatten(tree_map(lambda g: g[None].float(),
                                         global_params))
    new = stack_unflatten((pmat[0] - step)[None], pspec)
    return tree_map(lambda s, g: s[0].to(g.dtype), new, global_params)
