"""Secure aggregation: pairwise additive masking (port of
``fl_tpu.fl.secure_agg``).

Bonawitz et al. 2017: each pair of clients (i, j) agrees on a random mask;
client i ships x_i plus its pairs' masks with opposite signs at the two
endpoints, so every pair cancels in the server's SUM and the server learns
only Σ x_i. The pairing graph is a ring with offsets 1..k (SecAgg+, Bell et
al. 2020). Clients pre-scale their delta by n_i·mask_i, and the server
divides the masked sum by Σ n_i·mask_i: sample-weighted FedAvg.

Over the (C, D) flat matrix of ``ops.flatten``, offset o's masks are one
(C, D) normal draw: row i of it is pair (i, (i + o) mod C)'s mask, added at
row i and subtracted at row (i + o) mod C (a roll), and zeroed where an
endpoint does not participate, so cancellation is exact in structure under
partial participation. The draw for offset o comes from one generator
seeded fold(fold(round, SECURE_AGG), o): the stream structure round → tag
→ offset of the reference, whose bits differ by construction. One draw an
offset keeps it one launch on the device where a generator per pair would
be host-bound.

Plain PyTorch, as the reference's is XLA.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from fl_tpu_torch.core import prng
from fl_tpu_torch.ops.flatten import stack_flatten, stack_unflatten


def ring_pair_masks(seed: int, num_clients: int, dim: int,
                    neighbors: int = 8, scale: float = 1.0,
                    alive: torch.Tensor = None, device="cpu"
                    ) -> torch.Tensor:
    """(C, D) pairwise masks over a ring-``neighbors`` graph, summing to ~0
    over the client axis. ``seed`` is the round's SECURE_AGG stream seed;
    ``alive`` (C,) zeroes every pair with a non-participating endpoint."""
    C, D = num_clients, dim
    k = min(neighbors, max(C - 1, 0))
    if alive is None:
        alive = torch.ones((C,), device=device)
    alive = alive.float().to(device)
    masks = torch.zeros((C, D), dtype=torch.float32, device=device)
    for o in range(1, k + 1):
        g = prng.generator(prng.fold(seed, o), device)
        noise = torch.randn((C, D), generator=g, device=device) * scale
        # pair (i, (i + o) mod C) is live only when both endpoints are
        both = alive * torch.roll(alive, -o)
        noise *= both[:, None]
        masks += noise
        masks -= torch.roll(noise, o, dims=0)
        del noise
    return masks


def masked_payloads(stacked_updates, num_samples: torch.Tensor,
                    mask: torch.Tensor, rseed: int, neighbors: int = 8,
                    scale: float = 1.0) -> Tuple[torch.Tensor, Any]:
    """The per-client wire payloads n_i·m_i·x_i + pairmask_i of a round
    (``rseed`` the round's seed): returns (masked (C, D) matrix, flatten
    spec)."""
    mat, spec = stack_flatten(stacked_updates)
    C, D = mat.shape
    w = num_samples.float() * mask.float()
    mat *= w[:, None]
    mat += ring_pair_masks(prng.stream_seed(rseed, prng.Stream.SECURE_AGG),
                           C, D, neighbors, scale, alive=mask,
                           device=mat.device)
    return mat, spec


def secure_fedavg_delta(global_params, new_stacked, num_samples: torch.Tensor,
                        mask: torch.Tensor, rseed: int, neighbors: int = 8,
                        scale: float = 1.0):
    """Sample-weighted FedAvg of the deltas against the global model, from
    the pairwise-masked payloads: equal to ``fedavg_delta`` up to float
    cancellation (~C·eps·scale)."""
    deltas = {l: {k: (c - global_params[l][k][None]).float()
                  for k, c in leaves.items()}
              for l, leaves in new_stacked.items()}
    masked, spec = masked_payloads(deltas, num_samples, mask, rseed,
                                   neighbors, scale)
    del deltas
    w_sum = (num_samples.float() * mask.float()).sum()
    total = masked.sum(0) / torch.clamp(w_sum, min=1e-12)
    avg = stack_unflatten(total[None], spec)
    return {l: {k: (g + avg[l][k][0].float()).to(g.dtype)
                for k, g in leaves.items()}
            for l, leaves in global_params.items()}
