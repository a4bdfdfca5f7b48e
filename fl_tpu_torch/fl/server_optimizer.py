"""Server-side federated optimizers: FedAvgM, FedAdam, FedYogi (port of
``fl_tpu.fl.server_optimizer``).

Adaptive federated optimization (Reddi et al. 2021): instead of replacing
the global model with the FedAvg result, the server treats the round's
movement as a pseudo-gradient

    g_t = θ_t − θ_fedavg

and steps an optimizer on it: heavy-ball SGD (FedAvgM), Adam (FedAdam) or
Yogi (FedYogi). Each follows optax as the reference builds it:
``optax.sgd(lr, momentum)`` (trace = g + momentum·trace), ``optax.adam(lr,
b1, b2, eps)`` (eps outside the square root, bias-corrected moments from
zero) and ``optax.yogi(lr, b1, b2, eps)`` (both moments start at 1e-6,
ν ← ν − (1 − b2)·sign(ν − g²)·g², bias-corrected). The defaults are
Reddi et al.'s: b2 0.99 and eps (their τ) 1e-3.

The state is a dict of trees like the global parameters, ``{"count",
"mu", "nu"}`` or ``{"trace"}``; :func:`state_from_optax` reads the
reference's optax state into it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from fl_tpu_torch.core.pytree import tree_map

SERVER_OPTIMIZERS = ("none", "fedavgm", "fedadam", "fedyogi")


class ServerOptimizer:
    """One server-optimizer step a round on the global parameters."""

    def __init__(self, name: str, learning_rate: float = 1.0,
                 momentum: float = 0.9, b1: float = 0.9, b2: float = 0.99,
                 eps: float = 1e-3):
        if name not in SERVER_OPTIMIZERS[1:]:
            raise ValueError(f"Unknown server optimizer {name!r}; choose "
                             f"from {SERVER_OPTIMIZERS}")
        self.name = name
        self.lr, self.momentum = learning_rate, momentum
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> Dict[str, Any]:
        if self.name == "fedavgm":
            return {"trace": tree_map(torch.zeros_like, params)}
        fill = 1e-6 if self.name == "fedyogi" else 0.0
        return {"count": 0,
                "mu": tree_map(lambda p: torch.full_like(p, fill), params),
                "nu": tree_map(lambda p: torch.full_like(p, fill), params)}

    @torch.no_grad()
    def update(self, params, fedavg_params, state: Dict[str, Any]
               ) -> Tuple[Any, Dict[str, Any]]:
        """(new params, new state) after one step on θ − θ_fedavg."""
        g = tree_map(torch.sub, params, fedavg_params)
        if self.name == "fedavgm":
            trace = tree_map(lambda gi, t: gi + self.momentum * t, g,
                             state["trace"])
            return (tree_map(lambda p, t: p + t * (-self.lr), params, trace),
                    {"trace": trace})
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda gi, m: (1 - b1) * gi + b1 * m, g, state["mu"])
        if self.name == "fedadam":
            nu = tree_map(lambda gi, v: (1 - b2) * (gi * gi) + b2 * v, g,
                          state["nu"])
        else:
            nu = tree_map(lambda gi, v: v - (1 - b2) * torch.sign(
                v - gi * gi) * (gi * gi), g, state["nu"])
        count = state["count"] + 1
        f32 = np.float32
        c1 = float(f32(1) - f32(b1) ** f32(count))
        c2 = float(f32(1) - f32(b2) ** f32(count))
        new = tree_map(
            lambda p, m, v: p + ((m / c1) / (torch.sqrt(v / c2) + self.eps))
            * (-self.lr), params, mu, nu)
        return new, {"count": count, "mu": mu, "nu": nu}


def make_server_optimizer(name: str, **kwargs) -> Optional[ServerOptimizer]:
    """The server optimizer; None for plain FedAvg replacement."""
    if name in (None, "", "none"):
        return None
    return ServerOptimizer(name, **kwargs)


def state_from_optax(state, device="cpu") -> Dict[str, Any]:
    """The port's server-optimizer state from the reference's optax state
    (the chain's tuple, holding a ``ScaleByAdamState`` or a
    ``TraceState``), its leaves as numpy: trees like ``params_from_flax``
    gives."""
    def tree(t):
        return tree_map(lambda v: torch.tensor(np.asarray(v, np.float32),
                                               device=device), t)

    for part in state:
        if hasattr(part, "trace"):
            return {"trace": tree(part.trace)}
        if hasattr(part, "mu"):
            return {"count": int(np.asarray(part.count)),
                    "mu": tree(part.mu), "nu": tree(part.nu)}
    raise ValueError("no ScaleByAdamState or TraceState in the state")
