"""FedDyn: federated learning with dynamic regularization (port of
``fl_tpu.fl.feddyn``).

Acar et al. 2021, Algorithm 1. Client i minimizes

    L_i(θ) − ⟨g_i, θ⟩ + (α/2)·‖θ − θ_g‖²

where g_i is the client's carried first-order state. The engine runs the
linear term as the trainer's ``correction`` operand (−g_i on every step's
gradient) and the quadratic term as FedProx's ``proximal_mu`` = α. After
local training:

    g_i ← g_i − α·(θ_i − θ_g)                        (participants)
    h   ← h − (α/N)·Σ_{i∈P} (θ_i − θ_g)              (server state)
    θ_g ← mean_{i∈P}(θ_i) − h/α                      (server model)

The state lives in the (C, D_pad) layout of ``ops.flatten`` (the
reference's ``stack_flatten`` layout, column for column): h is (D_pad,),
g (C, D_pad), carried across rounds on the engine's device;
``models.load_feddyn_state`` loads the reference engine's.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def feddyn_server_update(
    params_flat: torch.Tensor,    # (D_pad,) current global params θ_g
    h_flat: torch.Tensor,         # (D_pad,) server state h
    grad_mat: torch.Tensor,       # (C, D_pad) client states g_i
    delta_mat: torch.Tensor,      # (C, D_pad) θ_i − θ_g
    mask: torch.Tensor,           # (C,) participation mask
    alpha: float,
    num_clients: int,
    psum_: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One FedDyn round's state and model update (Alg. 1's server lines):
    returns ``(new_params_flat, new_h, new_grads)``. Non-participants' g_i
    are untouched; h moves by the participants' delta sum over the client
    count N; the new model is the unweighted participant mean minus h/α.
    A round without participants leaves the model where it was. On a shard
    of the client axis the matrices and the mask are the shard's rows and
    ``psum_`` sums the delta and the participant count over the shards."""
    psum_ = psum_ or (lambda x: x)
    m = (mask > 0).float()[:, None]
    new_grads = torch.where(m > 0, grad_mat - alpha * delta_mat, grad_mat)
    sum_delta = psum_(torch.sum(m * delta_mat, dim=0))      # (D_pad,)
    new_h = h_flat - (alpha / float(num_clients)) * sum_delta
    p_real = psum_(mask.float().sum())
    mean_theta = params_flat + sum_delta / torch.clamp(p_real, min=1.0)
    # an EMPTY round must not move the model: without participants the
    # paper's server line has no mean to take, and applying −h/α alone
    # would drift θ by the carried state every skipped round
    new_params = torch.where(p_real > 0, mean_theta - new_h / alpha,
                             params_flat)
    return new_params, new_h, new_grads
