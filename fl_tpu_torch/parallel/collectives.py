"""FedAvg and the round's cross-client reductions over the client mesh.

The port of ``fl_tpu.parallel.collectives``. The reference's
:func:`fedavg_psum_shard_map` is a ``shard_map`` body whose ``lax.psum``
combines each device's partial weighted sums; here each rank is the body:
it reduces its own block of clients, and one ``all_reduce`` over the
ranks combines the partial sums and the weight mass, packed into one flat
f32 buffer.

:class:`Communicator` is what the round engine's sharded superstep calls
for every cross-client quantity (the reference's ``psum_`` and
``gather_clients`` hooks): :meth:`~Communicator.psum` of a tensor,
:meth:`~Communicator.psum_tree` of a tree as one packed reduce, and
:meth:`~Communicator.gather_clients`, (CL, ...) → (C, ...) on every rank,
which robust and secure aggregation need. It records every call it makes
(kind, dtype, bytes): the port of ``fl_tpu.parallel.hlo_audit``'s
invariant, read from the calls instead of parsed from compiled HLO (the
port issues its collectives itself; XLA's HLO parsing has no
counterpart). The FedAvg round makes exactly two all-reduces, the packed
model delta and the packed metrics; ``evaluate_federated`` and
``evaluate_personalized`` gather their per-client results with one
all-reduce each (three and five packed (C,) rows), and ``profile_round``
makes its round's own.
"""

from __future__ import annotations

import functools
from typing import Any, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from fl_tpu_torch.core.mesh import ClientMesh
from fl_tpu_torch.core.pytree import (
    tree_from_leaves, tree_leaves, tree_map, tree_paths)


class Collective(NamedTuple):
    kind: str      # "all_reduce" | "all_gather" | "broadcast"
    dtype: str     # the payload's dtype
    nbytes: int    # one rank's payload bytes


def _pack(leaves: List[torch.Tensor], extra: List[torch.Tensor] = ()
          ) -> torch.Tensor:
    """Leaves (and 0-d extras) as one flat f32 buffer."""
    return torch.cat([t.reshape(-1).float() for t in leaves]
                     + [t.reshape(1).float() for t in extra])


def _unpack(flat: torch.Tensor, like: List[torch.Tensor]
            ) -> List[torch.Tensor]:
    sizes = [t.numel() for t in like]
    return [part.reshape(t.shape) for part, t in
            zip(torch.split(flat[:sum(sizes)], sizes), like)]


class Communicator:
    """Cross-client reductions over a :class:`ClientMesh`, and the
    inventory of the calls made since :meth:`begin_round`."""

    def __init__(self, mesh: ClientMesh):
        self.mesh = mesh
        self.calls: List[Collective] = []

    def begin_round(self) -> None:
        self.calls = []

    def _record(self, kind: str, t: torch.Tensor) -> None:
        self.calls.append(Collective(kind, str(t.dtype).replace("torch.", ""),
                                     t.numel() * t.element_size()))

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks of ``x`` (not modified), on every rank."""
        t = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=self.mesh.group)
        self._record("all_reduce", t)
        return t

    def psum_tree(self, tree):
        """Σ over the ranks of every leaf, as ONE all-reduce of the leaves
        packed into a flat f32 buffer; each leaf comes back in f32."""
        paths, leaves = tree_paths(tree), tree_leaves(tree)
        flat = self.psum(_pack(leaves))
        return tree_from_leaves(paths, _unpack(flat, leaves))

    def gather_clients(self, tree):
        """Every rank's (CL, ...) rows of each leaf, in rank order: (C, ...)
        on every rank."""
        def gather(x):
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(self.mesh.world_size)]
            dist.all_gather(parts, x, group=self.mesh.group)
            self._record("all_gather", x)
            return torch.cat(parts)

        return tree_map(gather, tree)


class ClientAxis:
    """This rank's rows [lo, hi) of a client-stacked axis of ``total``
    rows and the hooks across the ranks, the identity without a mesh (the
    clustered, Ditto and async engines' counterpart of the round engine's
    ``_psum`` / ``_per_client`` / ``_gather_clients``)."""

    def __init__(self, mesh: Optional[ClientMesh], total: int):
        self.total = total
        self.rows = (0, total) if mesh is None else mesh.client_rows(total)
        self.comm = None if mesh is None else Communicator(mesh)

    @property
    def local(self) -> int:
        return self.rows[1] - self.rows[0]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.comm is None else self.comm.psum(x)

    def psum_tree(self, tree):
        return tree if self.comm is None else self.comm.psum_tree(tree)

    def gather(self, tree):
        """(CL, ...) → (C, ...) on every rank."""
        return tree if self.comm is None else self.comm.gather_clients(tree)

    def per_client(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's (CL, ...) rows at their offset of a zeroed (C, ...)
        tensor, so that the sum over the ranks is the gather."""
        if self.comm is None:
            return v
        out = v.new_zeros((self.total,) + tuple(v.shape[1:]))
        out[self.rows[0]:self.rows[1]] = v
        return out

    @property
    def calls(self) -> List[Collective]:
        return [] if self.comm is None else list(self.comm.calls)

    def begin_round(self) -> None:
        if self.comm is not None:
            self.comm.begin_round()


def fedavg_psum_shard_map(mesh: ClientMesh, stacked_weights: Any,
                          num_samples: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> Any:
    """FedAvg as each rank's partial sums plus one all-reduce.

    ``stacked_weights`` leaves, ``num_samples`` and ``mask`` are this
    rank's (CL, ...) / (CL,) block of the client axis. Returns the weighted
    mean Σ nₖmₖθₖ / Σ nₖmₖ on every rank, in the input dtypes: the local
    weighted partial sums and the local mass go out packed in one f32
    buffer, and the sum over the ranks is divided by max(mass, 1e-12), as
    the reference's (ref: fl_tpu/parallel/collectives.py)."""
    n = torch.as_tensor(num_samples)
    if mask is None:
        mask = torch.ones_like(n, dtype=torch.float32)
    weights = n.float() * torch.as_tensor(mask).float()
    paths, leaves = tree_paths(stacked_weights), tree_leaves(stacked_weights)
    partial = [torch.tensordot(weights, x.float(), dims=1) for x in leaves]
    comm = Communicator(mesh)
    flat = comm.psum(_pack(partial, [weights.sum()]))
    total = flat[-1]
    out = [(s / torch.clamp(total, min=1e-12)).to(x.dtype)
           for s, x in zip(_unpack(flat, partial), leaves)]
    return tree_from_leaves(paths, out)


def make_sharded_fedavg(mesh: ClientMesh):
    """:func:`fedavg_psum_shard_map` bound to a mesh."""
    return functools.partial(fedavg_psum_shard_map, mesh)
