"""Clustered federated learning (IFCA): k global models, one round at a
time (port of ``fl_tpu.fl.clustered``).

When the clients are a mixture of distinct data distributions, one FedAvg
model fits the mixture's average and serves every cohort poorly. The
Iterative Federated Clustering Algorithm (Ghosh et al. 2020) keeps k
global models; each round every client (1) scores all k models on its own
shard, (2) adopts the best-fitting one, (3) trains it locally, and (4) the
server averages the deltas per cluster.

A round on the engine's device:

- the assignment: k eval-mode forwards, cluster j's model broadcast over
  the stacked clients (so a fused model launches its conv kernel once a
  cluster), on at most ``assign_max_samples`` leading samples of each
  shard, normalized as in training; each client's loss masked to its
  valid samples, the argmin taken with ties to the first index;
- each client's selected model gathered into a (C, ...) stack and trained
  by ``make_local_train_fn`` with the round's streams (seed, round);
- the per-cluster weighted mean onehot(assign)ᵀ · (w ⊙ Δ) in f32 with w
  the shard sizes; a cluster nobody adopted passes the round bit for bit
  (a select on its weight mass, not a division by a clamped zero).

Under a client mesh (``core.mesh``) the k models are replicated (rank 0's
inits broadcast) and each rank trains its own CL = C / world_size clients
with their global ids' streams; a round makes two all-reduces
(``round_collectives``): the per-cluster numerators of every leaf packed
with the weight masses, then the packed metrics with each rank's
assignments at its offset of a zeroed (C,) vector.

The reference's symmetry breaking: k independent random inits, or, with
``warmstart_clients``, one round of local training on each named client's
shard from the shared first init. The random streams are the port's
(``core.prng``), so the inits differ from the reference's by
construction; the tests carry the reference's inits across.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fl_tpu_torch.core import prng
from fl_tpu_torch.core.mesh import replicate_tree, resolve_device
from fl_tpu_torch.core.pytree import tree_map
from fl_tpu_torch.fl.local_training import (
    FederatedTrainingConfig,
    evaluate_u8_test_set,
    make_local_train_fn,
    model_kwargs,
    per_example_losses,
    train_variables,
)
from fl_tpu_torch.models.factory import init_model_variables
from fl_tpu_torch.parallel.collectives import ClientAxis

# the warm-start rounds' stream tag (the reference's)
_WARMSTART = 0x1FCA


@dataclasses.dataclass(frozen=True)
class ClusteredConfig:
    """IFCA knobs."""

    training: FederatedTrainingConfig = dataclasses.field(
        default_factory=FederatedTrainingConfig)
    num_clusters: int = 2
    seed: int = 0
    # the assignment's loss over at most this many leading valid samples
    # of each shard (None: the whole shard, the paper's estimator)
    assign_max_samples: Optional[int] = None
    # cluster j starts from one round of local training on client
    # warmstart_clients[j]'s shard (IFCA's convergence needs inits near
    # the populations' optima, Ghosh et al. 2020 Thm 2-3); None = k
    # random inits
    warmstart_clients: Optional[tuple] = None


@dataclasses.dataclass
class ClusteredRoundResult:
    round_number: int
    cluster_sizes: List[int]
    train_loss: float
    train_accuracy: float
    assignment_loss: float   # mean over clients of the adopted model's loss
    round_time_s: float


class ClusteredFederatedEngine:
    """k stacked global models and the IFCA round. Runs on the GPU unless
    the caller asks for ``device="cpu"``; with ``mesh=`` on the mesh's
    device."""

    def __init__(self, model, data, config: ClusteredConfig, mesh=None,
                 device=None):
        k = config.num_clusters
        if k < 1:
            raise ValueError("num_clusters must be >= 1")
        if k > data.num_clients:
            raise ValueError(
                f"num_clusters={k} exceeds the client population "
                f"({data.num_clients})")
        self.model = model
        self.config = config
        self.mesh = mesh
        self.num_clients = data.num_clients
        self.device = resolve_device("ClusteredFederatedEngine", device, mesh)
        if mesh is not None and self.num_clients % mesh.world_size:
            raise ValueError(
                f"num_clients={self.num_clients} must divide evenly over "
                f"the {mesh.world_size}-device mesh")
        ws = config.warmstart_clients
        if ws is not None:
            ws = tuple(ws)
            if len(ws) != k:
                raise ValueError(
                    f"warmstart_clients must name exactly num_clusters="
                    f"{k} clients, got {len(ws)}")
            if any(not 0 <= c < data.num_clients for c in ws):
                raise ValueError(
                    f"warmstart_clients out of range [0, {data.num_clients})")
        self._axis = ClientAxis(mesh, self.num_clients)
        self.data = data.to_device(self.device, mesh=mesh)
        self.round_number = 0
        self._root = prng.root_seed(config.seed)
        N = self.data.samples_per_client
        self._local_train = make_local_train_fn(
            model, config.training, N, self.data.mean, self.data.std)
        self._n_assign = (N if config.assign_max_samples is None
                          else min(config.assign_max_samples, N))

        # k independent random inits: IFCA's symmetry breaking (§3.1)
        inits = [init_model_variables(
            model, prng.generator(prng.fold(self._root, j), self.device),
            self.device) for j in range(k)]
        if ws is not None:
            # one local round a cluster on its seed client's shard, all
            # from the SHARED first init
            base = tree_map(lambda l: l[None], inits[0])
            inits = []
            for j, c in enumerate(ws):
                warmed, _ = train_variables(
                    self._local_train, base,
                    torch.as_tensor(np.asarray(data.images[c:c + 1])).to(
                        self.device),
                    torch.as_tensor(np.asarray(data.labels[c:c + 1],
                                               np.int64)).to(self.device),
                    torch.as_tensor(np.asarray(data.num_samples[c:c + 1],
                                               np.int32)).to(self.device),
                    prng.fold(prng.fold(self._root, _WARMSTART), j))
                inits.append(tree_map(lambda l: l[0], warmed))
        self.cluster_variables: Dict[str, Any] = tree_map(
            lambda *leaves: torch.stack(leaves), *inits)
        if mesh is not None:
            self.cluster_variables = replicate_tree(self.cluster_variables,
                                                    mesh)
        self.assignments: Optional[np.ndarray] = None
        # the collectives of the last round (under a mesh)
        self.round_collectives = []

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _assignment_losses(self) -> torch.Tensor:
        """(CL, k): each client's masked mean loss of every cluster model
        on its shard's leading samples, in eval mode."""
        na, d = self._n_assign, self.data
        x = (d.images[:, :na].float() / 255.0 - d.mean) / d.std
        y = d.labels[:, :na]
        n = d.num_samples.clamp(min=1)
        msk = (torch.arange(na, device=self.device)[None, :]
               < n[:, None]).float()
        CL = x.shape[0]
        out = []
        for j in range(self.config.num_clusters):
            v = tree_map(lambda l: l[j][None].expand(CL, *l.shape[1:]),
                         self.cluster_variables)
            logits = self.model(v["params"], x, train=False,
                                **model_kwargs(v.get("batch_stats")))
            per = per_example_losses(logits, y)
            out.append((per * msk).sum(1) / msk.sum(1).clamp(min=1.0))
        return torch.stack(out, 1)

    def run_round(self) -> ClusteredRoundResult:
        t0 = time.perf_counter()
        k = self.config.num_clusters
        lo, _ = self._axis.rows
        self._axis.begin_round()
        rseed = prng.round_seed(self._root, self.round_number)
        losses = self._assignment_losses()
        assign = torch.argmin(losses, 1)  # the first index on ties
        a_loss = losses.gather(1, assign[:, None])[:, 0]
        del losses
        selected = tree_map(lambda l: l[assign], self.cluster_variables)
        trained, metrics = train_variables(
            self._local_train, selected, self.data.images, self.data.labels,
            self.data.num_samples, rseed, rows=(lo, self.num_clients))
        w = self.data.num_samples.float()
        onehot = F.one_hot(assign, k).float() * w[:, None]   # (CL, k)
        # the per-cluster weighted delta sums and weight masses: ONE reduce
        summed = self._axis.psum_tree({
            "num": tree_map(lambda t, s: torch.tensordot(
                onehot, (t.float() - s.float()), dims=([0], [0])),
                trained, selected),
            "den": onehot.sum(0)})
        del trained, selected
        den = summed["den"]
        safe = den.clamp(min=1e-12)

        def update(v, s):
            shape = (k,) + (1,) * (v.dim() - 1)
            return torch.where(den.reshape(shape) > 0,
                               (v.float() + s / safe.reshape(shape)
                                ).to(v.dtype), v)

        self.cluster_variables = tree_map(update, self.cluster_variables,
                                          summed["num"])
        # the metrics and every client's assignment: the second reduce
        packed = self._axis.psum(torch.cat([
            torch.stack([(metrics["loss"] * w).sum(),
                         (metrics["accuracy"] * w).sum(), w.sum(),
                         a_loss.sum(),
                         torch.tensor(float(w.shape[0]),
                                      device=self.device)]),
            self._axis.per_client(assign.float())])).cpu().numpy()
        self.round_collectives = self._axis.calls
        self.assignments = packed[5:].astype(np.int64)
        wsum = max(float(packed[2]), 1.0)
        result = ClusteredRoundResult(
            round_number=self.round_number,
            cluster_sizes=np.bincount(self.assignments, minlength=k)
            .astype(int).tolist(),
            train_loss=float(packed[0]) / wsum,
            train_accuracy=float(packed[1]) / wsum,
            assignment_loss=float(packed[3]) / float(packed[4]),
            round_time_s=time.perf_counter() - t0)
        self.round_number += 1
        return result

    def run(self, num_rounds: int) -> List[ClusteredRoundResult]:
        return [self.run_round() for _ in range(num_rounds)]

    # ------------------------------------------------------------------
    def cluster_model(self, j: int) -> Dict[str, Any]:
        """Cluster j's variables (views of the stacked models)."""
        if not 0 <= j < self.config.num_clusters:
            raise IndexError(f"cluster {j} out of range")
        return tree_map(lambda l: l[j], self.cluster_variables)

    def evaluate_clusters(self, images: np.ndarray, labels: np.ndarray
                          ) -> List[Dict[str, Any]]:
        """Every cluster model on a uint8 test set: a loss / accuracy
        dict a cluster."""
        return [{"cluster": j, **evaluate_u8_test_set(
                    self.model, self.cluster_model(j), images, labels,
                    self.data.mean, self.data.std, self.device)}
                for j in range(self.config.num_clusters)]
