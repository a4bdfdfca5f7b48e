"""SCAFFOLD: stochastic controlled averaging (port of
``fl_tpu.fl.scaffold``).

Karimireddy et al. 2020, Algorithm 1, Option II. A server variate c
estimates the global average gradient and per-client variates c_i each
client's own; every local step is corrected by them:

    local step:   w ← w − lr·(grad + c − c_i)
    after K local SGD steps (Option II):
        c_i⁺ = c_i − c − (w_local − w_global) / (K·lr)
    server:       c ← c + (1/N)·Σ_{i∈S} (c_i⁺ − c_i)

Option II's identity needs the local update to be exactly lr times the
sum of the corrected gradients, so the engine requires plain SGD
(momentum 0). The variates live in the (C, D_pad) layout of
``ops.flatten`` (the reference's ``stack_flatten`` layout, column for
column): c is (D_pad,), c_i (C, D_pad), carried across rounds on the
device. :func:`state_from_reference` loads the reference engine's.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from fl_tpu_torch.ops.flatten import stack_unflatten


def scaffold_correction(c_flat: torch.Tensor, ci_mat: torch.Tensor, spec):
    """The per-client correction c − c_i as a stacked params tree
    (``spec``: a ``stack_flatten`` spec of the stacked f32 params)."""
    return stack_unflatten(c_flat[None, :] - ci_mat, spec)


def scaffold_update(c_flat: torch.Tensor, ci_mat: torch.Tensor,
                    delta_mat: torch.Tensor, mask: torch.Tensor,
                    k_steps: torch.Tensor, lr: float, num_clients: int,
                    psum_: Optional[Callable] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One round's control-variate update (Option II) from the (C, D_pad)
    deltas w_local − w_global and the (C,) local steps taken: returns
    (new c, new c_i). Non-participants keep their c_i, and so does a
    participant that took no step (it has no trajectory to estimate from);
    the server moves by the participants' sum over N. On a shard of the
    client axis the rows are the shard's and ``psum_`` sums the server's
    move over the shards (N the global count)."""
    k = torch.clamp(k_steps.float(), min=1.0)[:, None]
    ci_plus = ci_mat - c_flat[None, :] - delta_mat / (k * lr)
    m = ((mask > 0) & (k_steps > 0)).float()[:, None]
    new_ci = torch.where(m > 0, ci_plus, ci_mat)
    dc = (m * (ci_plus - ci_mat)).sum(0)
    if psum_ is not None:
        dc = psum_(dc)
    return c_flat + dc / float(num_clients), new_ci


def state_from_reference(scaffold_c, scaffold_ci, device="cpu"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference engine's ``scaffold_c`` / ``scaffold_ci`` (as numpy)
    as the port's (c, c_i) on ``device``."""
    return (torch.tensor(np.asarray(scaffold_c, np.float32), device=device),
            torch.tensor(np.asarray(scaffold_ci, np.float32), device=device))
