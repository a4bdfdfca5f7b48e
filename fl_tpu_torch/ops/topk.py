"""Top-k sparsification of model updates (port of ``fl_tpu.ops.topk``).

Keep the k entries of largest |value| of a flat vector, as values + flat
indices. The reference's is ``jax.lax.top_k`` (XLA's sort-based kernel,
no Pallas); the port's is ``torch.topk`` of |x| and a scatter back.
"""

from __future__ import annotations

from typing import Tuple

import torch


def topk_sparsify(x: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (values (k,), indices (k,) int32) of the largest-|x| entries."""
    (d,) = x.shape
    _, idx = torch.topk(x.abs(), min(k, d))
    return x[idx], idx.to(torch.int32)


def topk_densify(values: torch.Tensor, indices: torch.Tensor, d: int
                 ) -> torch.Tensor:
    """Scatter the sparse (values, indices) back to a dense (d,) vector."""
    return torch.zeros((d,), dtype=values.dtype, device=values.device
                       ).index_put_((indices.long(),), values)


def topk_sparsify_ratio(x: torch.Tensor, sparsity_ratio: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep round((1 − ratio)·d) entries, at least one (``sparsity_ratio``
    is the dropped fraction; Python's ``round``, half to even, as the
    reference)."""
    (d,) = x.shape
    k = max(1, int(round(d * (1.0 - sparsity_ratio))))
    return topk_sparsify(x, k)
