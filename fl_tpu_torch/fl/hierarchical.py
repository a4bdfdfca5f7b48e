"""Hierarchical federated learning, client → edge → cloud (HierFAVG; port
of ``fl_tpu.fl.hierarchical``).

Clients report to a nearby edge server every round; the edges
synchronize to the cloud only every τ rounds (Liu et al. 2020,
"Client-Edge-Cloud Hierarchical Federated Learning"). Between cloud syncs
each edge's model evolves on its own client group.

A round on the engine's device:

- the E edge models are one (E, ...) stacked tree; each client starts
  from its edge's model, gathered by its edge id (``index_select`` on the
  edge axis) into a (C, ...) stack, and ``make_local_train_fn`` trains the
  stack with the round's streams (seed, round);
- each edge's sample-weighted mean delta onehot(assign)ᵀ·(w ⊙ Δ) in f32,
  divided by the edge's mass clamped at 1e-12, is added to the edge model
  in the leaf's dtype;
- every τ-th round the cloud model is the edge-mass-weighted mean over
  the edge axis (weights w / Σw formed in float64 on the host, used in
  f32), broadcast back to every edge;
- the edge divergence √(Σ‖e − c‖² / E) is summed in float64 on the
  device.

With one edge, or a cloud sync every round, HierFAVG is FedAvg: the
engine shares the round engine's (round, client) streams, so both limits
track ``FederatedRoundEngine``.

Under a client mesh (``core.mesh``) the edge models are replicated and
each rank trains its own CL = C / world_size clients with their global
ids' streams; a round makes ONE all-reduce (``round_collectives``): the
per-edge numerators of every leaf packed with the edge masses and the
metric sums.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from fl_tpu_torch.core import prng
from fl_tpu_torch.core.mesh import replicate_tree, resolve_device
from fl_tpu_torch.core.pytree import tree_leaves, tree_map
from fl_tpu_torch.fl.local_training import (
    FederatedTrainingConfig,
    evaluate_u8_test_set,
    make_local_train_fn,
    train_variables,
)
from fl_tpu_torch.models.factory import init_model_variables
from fl_tpu_torch.parallel.collectives import ClientAxis


@dataclasses.dataclass(frozen=True)
class HierarchicalConfig:
    """HierFAVG knobs."""

    training: FederatedTrainingConfig = dataclasses.field(
        default_factory=FederatedTrainingConfig)
    # client -> edge id, length num_clients; None = balanced contiguous
    # blocks over num_edges groups
    edge_assignment: Optional[Sequence[int]] = None
    num_edges: int = 2
    # τ: edge rounds between cloud syncs (1 = every round, flat FedAvg)
    global_sync_every: int = 2
    seed: int = 0


@dataclasses.dataclass
class HierarchicalRoundResult:
    round_number: int
    train_loss: float
    train_accuracy: float
    cloud_synced: bool
    edge_divergence: float   # RMS L2 distance edge model ↔ cloud model
    round_time_s: float


def edge_assignment(config: HierarchicalConfig, num_clients: int
                    ) -> np.ndarray:
    """The (C,) int32 client → edge map: the configured one, checked, or
    balanced contiguous blocks (sizes differ by at most one, so no edge is
    empty)."""
    E, C = config.num_edges, num_clients
    if config.edge_assignment is None:
        return np.sort(np.arange(C) % E).astype(np.int32)
    assignment = np.asarray(list(config.edge_assignment), np.int32)
    if assignment.shape != (C,):
        raise ValueError(
            f"edge_assignment must have length {C}, got "
            f"{assignment.shape}")
    if assignment.min() < 0 or assignment.max() >= E:
        raise ValueError(
            f"edge ids must be in [0, {E}); got range "
            f"[{assignment.min()}, {assignment.max()}]")
    if len(np.unique(assignment)) < E:
        raise ValueError(
            "every edge needs at least one client (empty edges "
            "would freeze their model; drop them instead)")
    return assignment


class HierarchicalFederatedEngine:
    """The stacked edge models, the cloud model and the edge round. Runs
    on the GPU unless the caller asks for ``device="cpu"``; with ``mesh=``
    on the mesh's device."""

    def __init__(self, model, data, config: HierarchicalConfig, mesh=None,
                 device=None):
        E, C = config.num_edges, data.num_clients
        if E < 1:
            raise ValueError("num_edges must be >= 1")
        if E > C:
            raise ValueError(f"num_edges={E} exceeds the client "
                             f"population ({C})")
        if config.global_sync_every < 1:
            raise ValueError("global_sync_every must be >= 1")
        self.assignment = edge_assignment(config, C)
        self.model = model
        self.config = config
        self.mesh = mesh
        self.num_clients = C
        self.device = resolve_device("HierarchicalFederatedEngine", device,
                                     mesh)
        if mesh is not None and C % mesh.world_size:
            raise ValueError(
                f"num_clients={C} must divide evenly over the "
                f"{mesh.world_size}-device mesh")
        self._axis = ClientAxis(mesh, C)
        self.data = data.to_device(self.device, mesh=mesh)
        self.round_number = 0
        self._root = prng.root_seed(config.seed)
        self.cloud_variables: Dict[str, Any] = init_model_variables(
            model, prng.generator(prng.stream_seed(
                self._root, prng.Stream.INIT), self.device), self.device)
        if mesh is not None:
            self.cloud_variables = replicate_tree(self.cloud_variables, mesh)
        # every edge starts at the cloud model
        self.edge_variables: Dict[str, Any] = self._broadcast(
            self.cloud_variables)
        # the cloud sync's weights: each edge's share of the samples
        w = np.zeros(E, np.float64)
        np.add.at(w, self.assignment, np.asarray(data.num_samples,
                                                 np.float64))
        self._edge_weights = torch.as_tensor(
            (w / max(w.sum(), 1.0)).astype(np.float32), device=self.device)
        lo, hi = self._axis.rows
        self._assign = torch.as_tensor(self.assignment[lo:hi],
                                       dtype=torch.int64, device=self.device)
        self._local_train = make_local_train_fn(
            model, config.training, self.data.samples_per_client,
            self.data.mean, self.data.std)
        self.history: List[HierarchicalRoundResult] = []
        # the collectives of the last round (under a mesh)
        self.round_collectives = []

    def _broadcast(self, variables) -> Dict[str, Any]:
        """``variables`` copied into every edge's slot: (E, ...)."""
        E = self.config.num_edges
        return tree_map(lambda x: x[None].expand(E, *x.shape).clone(),
                        variables)

    # ------------------------------------------------------------------
    def _cloud_sync(self) -> None:
        """The edge-mass-weighted mean over the edge axis becomes the
        cloud model, rebroadcast to every edge."""
        w = self._edge_weights
        self.cloud_variables = tree_map(
            lambda v: torch.tensordot(w, v.float(), dims=1).to(v.dtype),
            self.edge_variables)
        self.edge_variables = self._broadcast(self.cloud_variables)

    @torch.no_grad()
    def _divergence(self) -> float:
        """√(Σ‖e − c‖² / E) over every leaf, in float64 on the device (one
        scalar to the host)."""
        div = sum(((e.double() - c.double()[None]) ** 2).sum()
                  for e, c in zip(tree_leaves(self.edge_variables),
                                  tree_leaves(self.cloud_variables)))
        return float(np.sqrt(float(div) / self.config.num_edges))

    def run_round(self) -> HierarchicalRoundResult:
        t0 = time.perf_counter()
        E = self.config.num_edges
        lo, _ = self._axis.rows
        self._axis.begin_round()
        rseed = prng.round_seed(self._root, self.round_number)
        start = tree_map(lambda l: l.index_select(0, self._assign),
                         self.edge_variables)
        trained, metrics = train_variables(
            self._local_train, start, self.data.images, self.data.labels,
            self.data.num_samples, rseed, rows=(lo, self.num_clients))
        w = self.data.num_samples.float()
        onehot = F.one_hot(self._assign, E).float() * w[:, None]  # (CL, E)
        # the per-edge weighted delta sums, the edge masses and the
        # metric sums: ONE reduce
        summed = self._axis.psum_tree({
            "num": tree_map(lambda t, s: torch.tensordot(
                onehot, (t - s).float(), dims=([0], [0])), trained, start),
            "den": onehot.sum(0),
            "metrics": torch.stack([(metrics["loss"] * w).sum(),
                                    (metrics["accuracy"] * w).sum(),
                                    w.sum()])})
        del trained, start
        safe = summed["den"].clamp(min=1e-12)
        self.edge_variables = tree_map(
            lambda v, s: v + (s / safe.reshape((E,) + (1,) * (v.dim() - 1))
                              ).to(v.dtype),
            self.edge_variables, summed["num"])
        synced = (self.round_number + 1) % self.config.global_sync_every == 0
        if synced:
            self._cloud_sync()
        self.round_collectives = self._axis.calls
        m = summed["metrics"].cpu().numpy()
        wsum = max(float(m[2]), 1.0)
        result = HierarchicalRoundResult(
            round_number=self.round_number,
            train_loss=float(m[0]) / wsum,
            train_accuracy=float(m[1]) / wsum,
            cloud_synced=bool(synced),
            edge_divergence=self._divergence(),
            round_time_s=time.perf_counter() - t0)
        self.round_number += 1
        self.history.append(result)
        return result

    def run(self, num_rounds: int) -> List[HierarchicalRoundResult]:
        return [self.run_round() for _ in range(num_rounds)]

    # ------------------------------------------------------------------
    def edge_model(self, edge: int) -> Dict[str, Any]:
        """Edge ``edge``'s variables (views of the stacked models)."""
        if not 0 <= edge < self.config.num_edges:
            raise IndexError(
                f"edge {edge} out of range [0, {self.config.num_edges})")
        return tree_map(lambda l: l[edge], self.edge_variables)

    def evaluate(self, images: np.ndarray, labels: np.ndarray,
                 edge: Optional[int] = None) -> Dict[str, float]:
        """The cloud model (or one edge's model) on a uint8 test set."""
        variables = (self.cloud_variables if edge is None
                     else self.edge_model(edge))
        return evaluate_u8_test_set(self.model, variables, images, labels,
                                    self.data.mean, self.data.std,
                                    self.device)
