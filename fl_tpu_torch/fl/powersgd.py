"""PowerSGD low-rank uplink compression (Vogels et al., NeurIPS 2019; port
of ``fl_tpu.fl.powersgd``).

Each matrix-shaped leaf delta M (n×m) is approximated by one power
iteration against a warm-started right factor:

    P = M Q            (n×r)
    P ← orthonormalize(P)          (modified Gram–Schmidt)
    Q' = Mᵀ P          (m×r)       carried to the next round
    M̂ = P Q'ᵀ                      what the server reconstructs

The client transmits (P, Q') — (n+m)·r floats instead of n·m — and keeps
M − M̂ in the error-feedback accumulator. Vector-shaped leaves (biases) are
transmitted uncompressed.

All clients' leaf deltas are one batched product per step
(``torch.bmm`` over the client axis) on a strided view of the flat (C,
D_pad) matrix, never a copy of it. The products stay f32: the module
never turns on TF32.

State packing: the engine carries ONE flat (C, W) uplink state,

    state[:, :D_pad]  — error feedback (same layout as int8/topk)
    state[:, D_pad:]  — the Q matrices, one (m·r) block per compressed
                        leaf, lane-padded
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch

from fl_tpu_torch.core.pytree import tree_leaves
from fl_tpu_torch.ops.flatten import padded_dim


@dataclasses.dataclass(frozen=True)
class _MatrixEntry:
    offset: int    # column offset of this leaf in the flat (C, D) matrix
    n: int         # rows of the matrix view  (prod(shape[:-1]))
    m: int         # cols of the matrix view  (shape[-1])
    q_offset: int  # offset of this leaf's Q block in the Q region


@dataclasses.dataclass(frozen=True)
class PowerSGDPlan:
    """Host-side compression plan derived from the model's leaf shapes."""

    rank: int
    d: int          # unpadded flat parameter dimension
    d_pad: int      # lane-padded width of the delta matrix / EF region
    dq_pad: int     # lane-padded width of the Q region
    entries: Tuple[_MatrixEntry, ...]

    @property
    def state_width(self) -> int:
        """Total uplink-state width: EF region + Q region."""
        return self.d_pad + self.dq_pad

    def compressed_floats(self) -> int:
        """Floats transmitted per client per round under this plan."""
        matrix_coords = sum(e.n * e.m for e in self.entries)
        factor_coords = sum((e.n + e.m) * self.rank for e in self.entries)
        return self.d - matrix_coords + factor_coords

    def compression_ratio(self) -> float:
        """Uplink reduction factor vs. sending the raw delta."""
        return self.d / max(1, self.compressed_floats())


def make_powersgd_plan(template, rank: int) -> PowerSGDPlan:
    """Build a plan from an UNBATCHED ``{layer: {leaf}}`` tree (the global
    model).

    Leaf order and column extents match
    :func:`fl_tpu_torch.ops.flatten.stack_flatten`, so ``offset`` indexes
    the engine's flat delta matrix. A leaf is compressed iff it is a float
    tensor with ndim ≥ 2, viewed as (prod(shape[:-1]), shape[-1]), AND the
    factored form (n+m)·r is strictly smaller than n·m."""
    if rank < 1:
        raise ValueError(f"powersgd rank must be ≥ 1, got {rank}")
    entries: List[_MatrixEntry] = []
    offset = 0
    q_offset = 0
    for leaf in tree_leaves(template):
        if leaf.dtype.is_floating_point and leaf.dim() >= 2:
            n = math.prod(leaf.shape[:-1])
            m = int(leaf.shape[-1])
            if (n + m) * rank < n * m:
                entries.append(_MatrixEntry(offset, n, m, q_offset))
                q_offset += m * rank
        offset += leaf.numel()
    return PowerSGDPlan(rank=rank, d=offset, d_pad=padded_dim(offset),
                        dq_pad=padded_dim(max(q_offset, 1)),
                        entries=tuple(entries))


def init_uplink_state(generator: torch.Generator, plan: PowerSGDPlan,
                      num_clients: int, *,
                      rows: Optional[Tuple[int, int]] = None
                      ) -> torch.Tensor:
    """(C, d_pad + dq_pad) initial state on ``generator``'s device: zero EF,
    standard-normal Q drawn from ``generator`` (the engine's
    ``Stream.UPLINK_Q``). ``rows=(lo, hi)``: only those clients' rows (a
    shard of the client axis), their Q the rows of the whole (C, dq_pad)
    draw."""
    device = generator.device
    lo, hi = (0, num_clients) if rows is None else rows
    q = torch.randn((num_clients, plan.dq_pad), generator=generator,
                    device=device)
    state = torch.zeros((hi - lo, plan.state_width), dtype=torch.float32,
                        device=device)
    state[:, plan.d_pad:] = q[lo:hi]
    return state


def _orthonormalize(p: torch.Tensor) -> torch.Tensor:
    """Batched modified Gram–Schmidt over the last axis of (C, n, r).

    A degenerate column (one already spanned by its predecessors, e.g. when
    MQ has rank below r) is ZEROED, not normalized: its residual is
    roundoff, and a normalized roundoff vector overlaps the span by O(1)."""
    cols: List[torch.Tensor] = []
    for i in range(p.shape[-1]):
        v = p[:, :, i]
        orig = torch.sqrt(torch.sum(v * v, dim=1, keepdim=True))
        for u in cols:
            v = v - torch.sum(v * u, dim=1, keepdim=True) * u
        norm = torch.sqrt(torch.sum(v * v, dim=1, keepdim=True))
        degenerate = norm <= 1e-5 * orig + 1e-30
        cols.append(torch.where(degenerate, 0.0,
                                v / torch.clamp(norm, min=1e-30)))
    return torch.stack(cols, dim=2)


def powersgd_roundtrip(carried: torch.Tensor, q_flat: torch.Tensor,
                       plan: PowerSGDPlan
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One power-iteration compress → reconstruct pass over all clients.

    carried: (C, d_pad) f32 delta (+EF); q_flat: (C, dq_pad) f32. Returns
    (reconstructed (C, d_pad), new q (C, dq_pad)). Columns of ``carried``
    outside every matrix entry (vector leaves, lane padding) pass through
    unchanged: they are transmitted uncompressed."""
    c = carried.shape[0]
    r = plan.rank
    out = carried.clone()
    new_q = q_flat.clone()
    for e in plan.entries:
        cols = slice(e.offset, e.offset + e.n * e.m)
        mat = carried[:, cols].view(c, e.n, e.m)
        q = q_flat[:, e.q_offset:e.q_offset + e.m * r].reshape(c, e.m, r)
        p = _orthonormalize(torch.bmm(mat, q))
        qn = torch.bmm(mat.transpose(1, 2), p)
        out[:, cols].view(c, e.n, e.m).copy_(torch.bmm(p, qn.transpose(1, 2)))
        new_q[:, e.q_offset:e.q_offset + e.m * r] = qn.reshape(c, e.m * r)
    return out, new_q


def apply_powersgd_with_error_feedback(
        mat: torch.Tensor, state: torch.Tensor, mask: torch.Tensor,
        plan: PowerSGDPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """One EF-composed PowerSGD step over participant rows.

    transmitted = powersgd(delta + e_t); e_{t+1} = delta + e_t − transmitted.
    Non-participants transmit nothing and keep EF and Q unchanged.
    Returns (transmitted (C, d_pad), new state (C, d_pad + dq_pad))."""
    ef = state[:, :plan.d_pad]
    q = state[:, plan.d_pad:]
    alive = (mask > 0.0).to(mat.dtype)[:, None]
    carried = mat + ef
    tx, qn = powersgd_roundtrip(carried, q, plan)
    tx = tx * alive
    new_ef = torch.where(alive > 0, carried - tx, ef)
    new_q = torch.where(alive > 0, qn, q)
    return tx, torch.cat([new_ef, new_q], dim=1)
