"""Asynchronous federated learning with buffered aggregation, FedBuff
(port of ``fl_tpu.fl.async_fl``; Nguyen et al. 2022).

Each client trains from whatever global version it last downloaded,
finished updates land in a buffer, and every K arrivals the server folds
the buffer into the newest model with a staleness discount. A client's
trajectory depends only on (start model, shard, attempt), so its training
is deferred to its completion event and computed there, as a concurrent
run would have computed it. The engine keeps

- a ring of the last ``max_staleness + 1`` global versions on the device
  (one stacked tree; slot v % depth holds version v), and
- the reference's host event queue, copied: a heap of (completion time,
  client, start version, attempt), lognormal client speeds and durations
  from ``np.random.default_rng(seed)``, and a client whose start version
  left the ring cancelled and restarted from the current model (counted
  in ``cancelled_attempts``); the timeline equals the reference's;

and runs one server step per K completions: gather the K start versions
from the ring by slot and the K clients' shards by id (the data stays
whole on every rank), train them, weight each delta by (1 + s)^(−a) (times
its shard size when ``sample_weighted``), normalized over the buffer and
scaled by ``server_lr``, add the sum to the newest model in each leaf's
dtype and write the result into the ring.

Attempt a of client c draws what client c draws in round a of the
synchronous engine: the trainer's per-row streams (``rows=(ids, total)``
with each row's round seed, ``fl.local_training``). With a full buffer and
equal speeds every step is one synchronous FedAvg round.

Under a client mesh the K-row buffer is split over the ranks (K must
divide) and the weighted delta sums and the metrics each make one
all-reduce (``round_collectives``).
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Any, Dict, List

import numpy as np
import torch

from fl_tpu_torch.core import prng
from fl_tpu_torch.core.mesh import replicate_tree, resolve_device
from fl_tpu_torch.core.pytree import tree_map
from fl_tpu_torch.fl.local_training import (
    FederatedTrainingConfig,
    evaluate_u8_test_set,
    make_local_train_fn,
    train_variables,
)
from fl_tpu_torch.models.factory import init_model_variables
from fl_tpu_torch.parallel.collectives import ClientAxis


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """FedBuff knobs (defaults follow Nguyen et al. 2022 §5)."""

    training: FederatedTrainingConfig = dataclasses.field(
        default_factory=FederatedTrainingConfig)
    buffer_size: int = 8             # K: updates per server step
    max_staleness: int = 8           # ring keeps max_staleness+1 versions
    staleness_exponent: float = 0.5  # weight ∝ (1+s)^(-a); 0 = uniform
    sample_weighted: bool = False    # additionally weight by shard size
    server_lr: float = 1.0
    seed: int = 0
    # client c's attempt lasts speed_c · LogNormal(0, duration_sigma), its
    # speed lognormal over the population (heterogeneity_sigma); zero
    # sigmas give unit durations
    duration_sigma: float = 0.5
    heterogeneity_sigma: float = 1.0


@dataclasses.dataclass
class AsyncStepResult:
    server_step: int
    sim_time: float                  # simulated clock at aggregation
    client_ids: List[int]
    staleness: List[int]
    cancelled_attempts: int          # cumulative
    train_loss: float
    train_accuracy: float
    step_time_s: float


class AsyncFederatedEngine:
    """FedBuff over the synchronous engine's data layout. Runs on the GPU
    unless the caller asks for ``device="cpu"``; with ``mesh=`` on the
    mesh's device."""

    def __init__(self, model, data, config: AsyncConfig, mesh=None,
                 device=None):
        K = config.buffer_size
        if K < 1:
            raise ValueError("buffer_size must be >= 1")
        if K > data.num_clients:
            raise ValueError(
                f"buffer_size={K} exceeds the client population "
                f"({data.num_clients})")
        if config.max_staleness < 0:
            raise ValueError("max_staleness must be >= 0")
        self.model = model
        self.config = config
        self.mesh = mesh
        self.device = resolve_device("AsyncFederatedEngine", device, mesh)
        if mesh is not None and K % mesh.world_size:
            raise ValueError(
                f"buffer_size={K} must divide evenly over the "
                f"{mesh.world_size}-device mesh")
        self.num_clients = data.num_clients
        self._axis = ClientAxis(mesh, K)
        self._num_samples = np.asarray(data.num_samples)
        # gathered by client id: whole on every rank
        self.data = data.to_device(self.device)
        self._root = prng.root_seed(config.seed)
        self.global_variables: Dict[str, Any] = init_model_variables(
            model, prng.generator(prng.stream_seed(
                self._root, prng.Stream.INIT), self.device), self.device)
        if mesh is not None:
            self.global_variables = replicate_tree(self.global_variables,
                                                   mesh)
        self._local_train = make_local_train_fn(
            model, config.training, self.data.samples_per_client,
            self.data.mean, self.data.std)

        # the version ring: slot v % depth holds version v while it is
        # within max_staleness of the newest
        self._ring_depth = config.max_staleness + 1
        self.ring: Dict[str, Any] = self._fill_ring(self.global_variables)
        self.version = 0             # newest global version
        self.server_step_count = 0
        self.cancelled_attempts = 0
        self.sim_time = 0.0

        # the host event queue: (completion time, client, start version,
        # attempt); every client is always in flight
        host_rng = np.random.default_rng(config.seed)
        self._speed = np.exp(host_rng.normal(
            0.0, config.heterogeneity_sigma, self.num_clients))
        self._host_rng = host_rng
        self._attempts = np.zeros(self.num_clients, np.int64)
        self._queue: list = []
        for c in range(self.num_clients):
            heapq.heappush(self._queue, (self._draw_duration(c), c, 0, 0))
        self.history: List[AsyncStepResult] = []
        # the collectives of the last server step (under a mesh)
        self.round_collectives = []

    def _fill_ring(self, variables) -> Dict[str, Any]:
        """A ring whose every slot holds ``variables``."""
        return tree_map(lambda x: x[None].expand(
            self._ring_depth, *x.shape).clone(), variables)

    def set_global_variables(self, variables) -> None:
        """Replace the newest model, and every ring slot with it (the ring
        is built from the initial model)."""
        self.global_variables = tree_map(
            lambda v, like: torch.as_tensor(v).to(
                device=self.device, dtype=like.dtype).clone(),
            variables, self.global_variables)
        self.ring = self._fill_ring(self.global_variables)

    # ------------------------------------------------------------------
    def _draw_duration(self, client: int) -> float:
        jitter = (np.exp(self._host_rng.normal(
            0.0, self.config.duration_sigma))
            if self.config.duration_sigma > 0 else 1.0)
        return float(self._speed[client] * jitter)

    def _pop_completions(self):
        """Pop K valid completions; cancel and restart evicted ones."""
        K = self.config.buffer_size
        out = []
        while len(out) < K:
            t_done, c, start_v, attempt = heapq.heappop(self._queue)
            self.sim_time = max(self.sim_time, t_done)
            if self.version - start_v > self.config.max_staleness:
                # start version evicted from the ring: cancel, restart
                # from the current model (the deployment's timeout)
                self.cancelled_attempts += 1
                self._attempts[c] += 1
                heapq.heappush(self._queue, (
                    t_done + self._draw_duration(c), c, self.version,
                    int(self._attempts[c])))
                continue
            out.append((c, start_v, attempt))
        return out

    def _superstep(self, slots, clients, staleness, attempts):
        """Train this rank's rows of the buffer and fold the whole buffer
        into the newest model: returns (new global variables, (loss,
        accuracy))."""
        cfg = self.config
        dev = self.device
        lo, hi = self._axis.rows
        ids = torch.as_tensor(clients[lo:hi], device=dev)
        starts = tree_map(
            lambda l: l[torch.as_tensor(slots[lo:hi], device=dev)],
            self.ring)
        n_valid = self.data.num_samples[ids]
        trained, metrics = train_variables(
            self._local_train, starts, self.data.images[ids],
            self.data.labels[ids], n_valid,
            [prng.round_seed(self._root, int(a)) for a in attempts[lo:hi]],
            rows=(clients[lo:hi], self.num_clients))
        # the weights of the whole buffer from replicated values (no
        # reduce), and this rank's rows of them
        w = (1.0 + torch.as_tensor(staleness, dtype=torch.float32,
                                   device=dev)) ** (-cfg.staleness_exponent)
        if cfg.sample_weighted:
            w = w * torch.as_tensor(self._num_samples[clients],
                                    dtype=torch.float32, device=dev)
        w = (w / w.sum().clamp(min=1e-12))[lo:hi]
        summed = self._axis.psum_tree(tree_map(
            lambda t, s: torch.tensordot(w, t.float() - s.float(), dims=1),
            trained, starts))
        del trained, starts
        new_global = tree_map(
            lambda g, s: (g + cfg.server_lr * s).to(g.dtype),
            self.global_variables, summed)
        out = self._axis.psum(torch.stack([(metrics["loss"] * w).sum(),
                                           (metrics["accuracy"] * w).sum()]))
        return new_global, out

    def run_server_step(self) -> AsyncStepResult:
        t0 = time.perf_counter()
        completed = self._pop_completions()
        clients = np.asarray([c for c, _, _ in completed], np.int64)
        start_vs = np.asarray([v for _, v, _ in completed], np.int64)
        attempts = np.asarray([a for _, _, a in completed], np.int64)
        staleness = (self.version - start_vs).astype(np.int32)
        slots = (start_vs % self._ring_depth).astype(np.int64)

        self._axis.begin_round()
        new_global, metrics = self._superstep(slots, clients, staleness,
                                              attempts)
        self.round_collectives = self._axis.calls
        self.global_variables = new_global
        self.version += 1
        slot = self.version % self._ring_depth

        def write(r, g):
            r[slot] = g.to(r.dtype)
            return r

        self.ring = tree_map(write, self.ring, new_global)

        # the completed clients start a fresh attempt from the new model
        for c in clients:
            c = int(c)
            self._attempts[c] += 1
            heapq.heappush(self._queue, (
                self.sim_time + self._draw_duration(c), c, self.version,
                int(self._attempts[c])))
        loss, acc = metrics.cpu().numpy()
        result = AsyncStepResult(
            server_step=self.server_step_count,
            sim_time=float(self.sim_time),
            client_ids=clients.astype(int).tolist(),
            staleness=staleness.astype(int).tolist(),
            cancelled_attempts=int(self.cancelled_attempts),
            train_loss=float(loss),
            train_accuracy=float(acc),
            step_time_s=time.perf_counter() - t0)
        self.server_step_count += 1
        self.history.append(result)
        return result

    def run(self, num_server_steps: int) -> List[AsyncStepResult]:
        return [self.run_server_step() for _ in range(num_server_steps)]

    # ------------------------------------------------------------------
    def evaluate(self, images: np.ndarray, labels: np.ndarray
                 ) -> Dict[str, Any]:
        """The newest model on a uint8 test set."""
        return evaluate_u8_test_set(self.model, self.global_variables,
                                    images, labels, self.data.mean,
                                    self.data.std, self.device)
