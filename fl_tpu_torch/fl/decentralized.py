"""Decentralized federated learning (D-PSGD): no server at all (port of
``fl_tpu.fl.decentralized``).

Every client keeps its own model; each round it trains locally, then
replaces its parameters with a weighted average of its neighbours'
(Lian et al. 2017), gossip over a doubly-stochastic mixing matrix W:

    θ_i ← Σ_j W_ij · θ_j^{local}

With the complete graph and uniform weights (W = 11ᵀ/C) a round is
FedAvg; the engine shares the round engine's (round, client) streams, so
it then tracks ``FederatedRoundEngine``.

A round on the engine's device: the C client models are one (C, ...)
stacked tree that ``make_local_train_fn`` trains in place of a global
model; the gossip is one f32 product W @ Θ on the (C, D) matrix of the
flattened leaves with TF32 off, cast back to each leaf's dtype; the
consensus distance (the mean over clients of each client's L2 distance
to the mean model) is computed on the device, one scalar to the host.

Under a client mesh (``core.mesh``) each rank holds and trains its own
CL = C / world_size rows of the client models. Mixing needs every
neighbour's row: the trained models go out in one packed all-gather
(``Communicator.gather_clients`` of the flat (CL, D) matrix) and each rank
applies its own row block of W; the metrics and the consensus distance
then go through one all-reduce (``round_collectives``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from fl_tpu_torch.core import prng
from fl_tpu_torch.core.mesh import resolve_device
from fl_tpu_torch.core.pytree import (
    tree_from_leaves, tree_leaves, tree_map, tree_paths)
from fl_tpu_torch.fl.local_training import (
    FederatedTrainingConfig,
    evaluate_u8_test_set,
    make_local_train_fn,
)
from fl_tpu_torch.fl.robust_agg import full_f32_matmul
from fl_tpu_torch.models.factory import init_model_variables
from fl_tpu_torch.parallel.collectives import ClientAxis


def ring_mixing_matrix(C: int, self_weight: float = 1.0 / 3.0
                       ) -> np.ndarray:
    """Symmetric ring: each client averages itself and its two ring
    neighbours (doubly stochastic by construction)."""
    if not 0.0 < self_weight < 1.0:
        raise ValueError("self_weight must be in (0, 1)")
    side = (1.0 - self_weight) / 2.0
    W = np.zeros((C, C))
    for i in range(C):
        W[i, i] = self_weight
        W[i, (i - 1) % C] += side
        W[i, (i + 1) % C] += side
    return W


def metropolis_mixing_matrix(adjacency: np.ndarray) -> np.ndarray:
    """Metropolis–Hastings weights for an undirected graph: W_ij =
    1/(1+max(d_i, d_j)) on edges, W_ii = 1 − Σ_j W_ij, doubly stochastic
    for any connected symmetric adjacency (Xiao & Boyd 2004)."""
    A = np.asarray(adjacency, bool)
    if A.shape[0] != A.shape[1]:
        raise ValueError("adjacency must be square")
    if not (A == A.T).all():
        raise ValueError("adjacency must be symmetric (undirected graph)")
    C = A.shape[0]
    A = A & ~np.eye(C, dtype=bool)   # no self-edges in degree counts
    deg = A.sum(1)
    W = np.zeros((C, C))
    for i in range(C):
        for j in np.flatnonzero(A[i]):
            W[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        W[i, i] = 1.0 - W[i].sum()
    return W


def validate_mixing_matrix(W: np.ndarray, num_clients: int) -> np.ndarray:
    W = np.asarray(W, np.float64)
    if W.shape != (num_clients, num_clients):
        raise ValueError(
            f"mixing matrix must be ({num_clients}, {num_clients}), "
            f"got {W.shape}")
    if (W < -1e-9).any():
        raise ValueError("mixing weights must be non-negative")
    if not np.allclose(W.sum(1), 1.0, atol=1e-6):
        raise ValueError("mixing matrix rows must sum to 1 (stochastic)")
    if not np.allclose(W.sum(0), 1.0, atol=1e-6):
        raise ValueError(
            "mixing matrix columns must sum to 1 (double stochasticity "
            "preserves the parameter mean — required for convergence to "
            "a consensus optimum, Lian et al. 2017 Assumption 1)")
    return W


@dataclasses.dataclass(frozen=True)
class DecentralizedConfig:
    """D-PSGD knobs."""

    training: FederatedTrainingConfig = dataclasses.field(
        default_factory=FederatedTrainingConfig)
    # (C, C) doubly-stochastic mixing matrix; None = symmetric ring
    mixing_matrix: Optional[np.ndarray] = None
    seed: int = 0


@dataclasses.dataclass
class DecentralizedRoundResult:
    round_number: int
    train_loss: float
    train_accuracy: float
    consensus_distance: float  # mean L2 distance client model ↔ mean model
    round_time_s: float


class DecentralizedFederatedEngine:
    """The C per-client models and the train + gossip round. Runs on the
    GPU unless the caller asks for ``device="cpu"``; with ``mesh=`` on the
    mesh's device."""

    def __init__(self, model, data, config: DecentralizedConfig, mesh=None,
                 device=None):
        C = data.num_clients
        W = (ring_mixing_matrix(C) if config.mixing_matrix is None
             else config.mixing_matrix)
        W = validate_mixing_matrix(W, C)
        self.model = model
        self.config = config
        self.mesh = mesh
        self.num_clients = C
        self.device = resolve_device("DecentralizedFederatedEngine", device,
                                     mesh)
        if mesh is not None and C % mesh.world_size:
            raise ValueError(
                f"num_clients={C} must divide evenly over the "
                f"{mesh.world_size}-device mesh")
        self._axis = ClientAxis(mesh, C)
        lo, hi = self._axis.rows
        # this rank's row block of W, and the mean's weights 1ᵀW / C
        self._W = torch.as_tensor(W[lo:hi].astype(np.float32),
                                  device=self.device)
        self._mean_row = torch.as_tensor(
            (W.sum(0) / C).astype(np.float32), device=self.device)
        self.data = data.to_device(self.device, mesh=mesh)
        self.round_number = 0
        self._root = prng.root_seed(config.seed)
        init = init_model_variables(
            model, prng.generator(prng.stream_seed(
                self._root, prng.Stream.INIT), self.device), self.device)
        if "batch_stats" in init:
            raise ValueError(
                "decentralized gossip mixes params only; use a stats-free "
                "model (e.g. create_model('cifar10_cnn', norm='group'))")
        # every client starts from the SAME init (consensus is exact at
        # round 0); every rank draws the same init
        self.client_variables: Dict[str, Any] = tree_map(
            lambda x: x[None].expand(hi - lo, *x.shape).clone(), init)
        self._local_train = make_local_train_fn(
            model, config.training, self.data.samples_per_client,
            self.data.mean, self.data.std)
        self.history: List[DecentralizedRoundResult] = []
        # the collectives of the last round (under a mesh)
        self.round_collectives = []

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _gossip(self, trained: Dict[str, Any]):
        """θ ← W·θ in f32 over the (C, D) matrix of the flattened leaves,
        cast back to each leaf's dtype; under a mesh every rank's rows are
        gathered first, in one packed all-gather. Returns (the mixed
        tree, Σ over this rank's clients of each one's L2 distance to the
        mean mixed model). The mean is (1ᵀW / C)·Θ, the same product on
        every rank, so it takes no collective of its own."""
        paths, leaves = tree_paths(trained), tree_leaves(trained)
        CL = leaves[0].shape[0]
        full = self._axis.gather(torch.cat(
            [l.reshape(CL, -1).float() for l in leaves], 1))    # (C, D)
        with full_f32_matmul():
            mixed = self._W @ full                              # (CL, D)
            mean = self._mean_row @ full                        # (D,)
        del full
        dist = torch.sqrt(((mixed - mean[None]) ** 2).sum(1)).sum()
        out, col = [], 0
        for l in leaves:
            d = l[0].numel()
            out.append(mixed[:, col:col + d].reshape(l.shape).to(l.dtype))
            col += d
        return tree_from_leaves(paths, out), dist

    def run_round(self) -> DecentralizedRoundResult:
        t0 = time.perf_counter()
        lo, _ = self._axis.rows
        self._axis.begin_round()
        rseed = prng.round_seed(self._root, self.round_number)
        params, metrics = self._local_train(
            self.client_variables["params"], self.data.images,
            self.data.labels, self.data.num_samples, rseed,
            rows=(lo, self.num_clients))
        mixed, dist = self._gossip(params)
        del params
        self.client_variables = {"params": mixed}
        w = self.data.num_samples.float()
        # the metrics and the consensus distance: the round's one reduce
        m = self._axis.psum(torch.stack([
            (metrics["loss"] * w).sum(), (metrics["accuracy"] * w).sum(),
            w.sum(), dist])).cpu().numpy()
        self.round_collectives = self._axis.calls
        wsum = max(float(m[2]), 1.0)
        result = DecentralizedRoundResult(
            round_number=self.round_number,
            train_loss=float(m[0]) / wsum,
            train_accuracy=float(m[1]) / wsum,
            consensus_distance=float(m[3]) / self.num_clients,
            round_time_s=time.perf_counter() - t0)
        self.round_number += 1
        self.history.append(result)
        return result

    def run(self, num_rounds: int) -> List[DecentralizedRoundResult]:
        return [self.run_round() for _ in range(num_rounds)]

    # ------------------------------------------------------------------
    @torch.no_grad()
    def mean_model(self) -> Dict[str, Any]:
        """The consensus (mean) model in f32, the deployable artifact
        (under a mesh the sum over every rank's rows)."""
        C = float(self.num_clients)
        return self._axis.psum_tree(tree_map(
            lambda l: l.float().sum(0) / C, self.client_variables))

    def client_model(self, i: int) -> Dict[str, Any]:
        """Client i's variables; under a mesh only this rank's clients."""
        if not 0 <= i < self.num_clients:
            raise IndexError(f"client {i} out of range")
        lo, hi = self._axis.rows
        if not lo <= i < hi:
            raise IndexError(
                f"client {i} is held by another rank (this rank holds "
                f"[{lo}, {hi}))")
        return tree_map(lambda l: l[i - lo], self.client_variables)

    def evaluate(self, images: np.ndarray, labels: np.ndarray,
                 client: Optional[int] = None) -> Dict[str, float]:
        """The mean model (or one client's model) on a uint8 test set."""
        variables = (self.mean_model() if client is None
                     else self.client_model(client))
        return evaluate_u8_test_set(self.model, variables, images, labels,
                                    self.data.mean, self.data.std,
                                    self.device)
