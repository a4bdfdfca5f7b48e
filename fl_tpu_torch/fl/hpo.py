"""Federated hyperparameter search: the trial population as a tensor axis,
pruned by successive halving (port of ``fl_tpu.fl.hpo``).

G candidate configurations × C clients train as one stacked run: the G
global models are a (G, ...) stacked tree, and local training runs on
the G·C rows trial-major. Every row carries its trial's learning rate
(the trainer's per-row ``lr=``, bit for bit a static rate) and epoch
budget (its masked epochs), and draws trial g's streams: its round seed
is fold(round seed, g) and its clients keep their global ids, so each
trial shuffles and drops out as its own round would. Each trial's new
model is the sample-weighted mean of its clients' TRAINED variables,
formed as its model plus the mean delta (equal in exact arithmetic; a
trial that does not move, at lr 0 or without epochs, keeps its bits,
which a float sum of its identical rows need not), and is scored by its
argmax accuracy on the whole normalized validation set (the G models
stacked, one forward). Successive halving (Jamieson &
Talwalkar 2016; ASHA's synchronous rungs, Li et al. 2020) then keeps
⌈alive / η⌉ trials after each rung round, ranked by a stable sort on
−accuracy, kept in stacked order, and COMPACTS the stacked models to the
survivors, so a dead trial costs nothing afterwards.

Under a client mesh (``core.mesh``) the trials and the validation set are
replicated and the client axis is sharded: one packed all-reduce a round
carries the G trials' weighted sums and the weight mass
(``round_collectives``), and every rank makes the same rung decision from
the same replicated models.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from fl_tpu_torch.core import prng
from fl_tpu_torch.core.mesh import replicate_tree, resolve_device
from fl_tpu_torch.core.pytree import tree_map
from fl_tpu_torch.fl.local_training import (
    FederatedTrainingConfig,
    make_local_train_fn,
    model_kwargs,
    train_variables,
)
from fl_tpu_torch.models.factory import init_model_variables
from fl_tpu_torch.parallel.collectives import ClientAxis


@dataclasses.dataclass(frozen=True)
class HPOConfig:
    """Sweep knobs. ``learning_rates`` (and optional ``epoch_budgets``)
    define the trial grid; ``rung_rounds`` are the round indices AFTER
    which the population is halved."""

    training: FederatedTrainingConfig = dataclasses.field(
        default_factory=FederatedTrainingConfig)
    learning_rates: Sequence[float] = (0.001, 0.01, 0.1)
    epoch_budgets: Optional[Sequence[int]] = None  # default: training's
    rung_rounds: Sequence[int] = ()   # e.g. (4, 8): halve after rounds 4, 8
    eta: int = 2                      # keep ⌈alive/η⌉ a rung
    seed: int = 0


@dataclasses.dataclass
class Trial:
    """One hyperparameter candidate and its life story."""

    trial_id: int
    learning_rate: float
    epochs: int
    alive: bool = True
    killed_at_round: Optional[int] = None
    val_history: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class HPORoundResult:
    round_number: int
    alive_trials: int
    val_accuracies: Dict[int, float]   # trial_id -> validation accuracy
    best_trial_id: int
    best_val_accuracy: float
    halved: bool
    round_time_s: float


class FederatedHPOEngine:
    """The stacked per-trial global models and the (G, C) round. Runs on
    the GPU unless the caller asks for ``device="cpu"``; with ``mesh=`` on
    the mesh's device.

    ``val_images`` / ``val_labels`` are uint8 / integer host arrays (the
    engine normalizes them); rung decisions rank trials by validation
    accuracy."""

    def __init__(self, model, data, config: HPOConfig,
                 val_images: np.ndarray, val_labels: np.ndarray, mesh=None,
                 device=None):
        lrs = [float(x) for x in config.learning_rates]
        if not lrs:
            raise ValueError("learning_rates must be non-empty")
        if any(lr < 0 for lr in lrs):
            raise ValueError("learning rates must be >= 0")
        if config.epoch_budgets is None:
            eps = [config.training.local_epochs] * len(lrs)
        else:
            eps = [int(e) for e in config.epoch_budgets]
            if len(eps) != len(lrs):
                raise ValueError(
                    f"epoch_budgets ({len(eps)}) must match "
                    f"learning_rates ({len(lrs)})")
            if any(e < 0 for e in eps):
                raise ValueError("epoch budgets must be >= 0")
            if max(eps) > config.training.local_epochs:
                raise ValueError(
                    "epoch budgets exceed training.local_epochs (the "
                    "compiled max — raise it to cover the largest budget)")
        if config.eta < 2:
            raise ValueError("eta must be >= 2")
        if list(config.rung_rounds) != sorted(set(config.rung_rounds)):
            raise ValueError("rung_rounds must be strictly increasing")
        val_images = np.asarray(val_images)
        if val_images.dtype != np.uint8:
            raise ValueError("val_images must be uint8 (normalized "
                             "on-device like training shards)")
        self.model = model
        self.config = config
        self.mesh = mesh
        self.num_clients = data.num_clients
        self.device = resolve_device("FederatedHPOEngine", device, mesh)
        if mesh is not None and data.num_clients % mesh.world_size:
            raise ValueError(
                f"num_clients={data.num_clients} must divide evenly over "
                f"the {mesh.world_size}-device mesh")
        self._axis = ClientAxis(mesh, self.num_clients)
        self.data = data.to_device(self.device, mesh=mesh)
        self.trials: List[Trial] = [
            Trial(trial_id=i, learning_rate=lr, epochs=e)
            for i, (lr, e) in enumerate(zip(lrs, eps))]
        self._alive_ids = list(range(len(self.trials)))
        self.round_number = 0
        self._root = prng.root_seed(config.seed)
        init = init_model_variables(
            model, prng.generator(prng.stream_seed(
                self._root, prng.Stream.INIT), self.device), self.device)
        G = len(self.trials)
        # every trial starts from the SAME init (the sweep isolates the
        # hyperparameters, not the init seed)
        self.trial_variables: Dict[str, Any] = tree_map(
            lambda x: x[None].expand(G, *x.shape).clone(), init)
        if mesh is not None:
            self.trial_variables = replicate_tree(self.trial_variables,
                                                  mesh)
        mean = np.asarray(data.mean, np.float32)
        std = np.asarray(data.std, np.float32)
        self._val_x = torch.as_tensor(
            (val_images.astype(np.float32) / 255.0 - mean) / std,
            device=self.device)
        self._val_y = torch.as_tensor(np.asarray(val_labels, np.int64),
                                      device=self.device)
        self._local_train = make_local_train_fn(
            model, config.training, self.data.samples_per_client,
            self.data.mean, self.data.std)
        self.history: List[HPORoundResult] = []
        # the collectives of the last round (under a mesh)
        self.round_collectives = []

    # ------------------------------------------------------------------
    def _train_trials(self, rseed: int):
        """Every alive trial's clients trained from its model: the (G·CL,
        ...) trained variables, trial-major, and their starts."""
        lo, hi = self._axis.rows
        CL, G = hi - lo, len(self._alive_ids)
        alive = [self.trials[i] for i in self._alive_ids]
        seeds = np.repeat(np.asarray([prng.fold(rseed, g) for g in range(G)],
                                     np.uint64), CL)
        ids = np.tile(np.arange(lo, hi, dtype=np.int64), G)
        lr = torch.as_tensor([t.learning_rate for t in alive],
                             dtype=torch.float32, device=self.device)
        budgets = [t.epochs for t in alive]
        epochs = (None if all(e == self.config.training.local_epochs
                              for e in budgets)
                  else torch.as_tensor(budgets, device=self.device
                                       ).repeat_interleave(CL))
        start = tree_map(lambda l: l.repeat_interleave(CL, dim=0),
                         self.trial_variables)
        d = self.data
        trained, _ = train_variables(
            self._local_train, start, d.images.repeat(G, 1, 1, 1, 1),
            d.labels.repeat(G, 1), d.num_samples.repeat(G), seeds,
            epochs=epochs, lr=lr.repeat_interleave(CL),
            rows=(ids, self.num_clients))
        return trained, start

    @torch.no_grad()
    def _val_accuracies(self) -> torch.Tensor:
        """(G,) argmax accuracy of each trial model on the whole
        validation set, the G models as one stacked forward."""
        v = self.trial_variables
        G = len(self._alive_ids)
        logits = self.model(
            v["params"], self._val_x[None].expand(G, *self._val_x.shape),
            train=False, **model_kwargs(v.get("batch_stats")))
        return (logits.argmax(-1) == self._val_y[None]).float().mean(1)

    def run_round(self) -> HPORoundResult:
        t0 = time.perf_counter()
        self._axis.begin_round()
        G = len(self._alive_ids)
        rseed = prng.round_seed(self._root, self.round_number)
        trained, start = self._train_trials(rseed)
        w = self.data.num_samples.float()
        # each trial's weighted delta sums and the weight mass: ONE reduce
        summed = self._axis.psum_tree({
            "sum": tree_map(lambda t, s: torch.einsum(
                "c,gc...->g...", w, (t - s).float().reshape(
                    (G, -1) + tuple(t.shape[1:]))), trained, start),
            "wsum": w.sum()})
        del trained, start
        wsum = summed["wsum"].clamp(min=1e-12)
        self.trial_variables = tree_map(
            lambda v, s: (v.float() + s / wsum).to(v.dtype),
            self.trial_variables, summed["sum"])
        self.round_collectives = self._axis.calls
        accs = self._val_accuracies().cpu().numpy()
        val_by_id: Dict[int, float] = {}
        for pos, tid in enumerate(self._alive_ids):
            a = float(accs[pos])
            val_by_id[tid] = a
            self.trials[tid].val_history.append(a)
        halved = False
        if (self.round_number in self.config.rung_rounds
                and len(self._alive_ids) > 1):
            halved = True
            keep = max(1, -(-len(self._alive_ids) // self.config.eta))
            order = np.sort(np.argsort(-accs, kind="stable")[:keep])
            for pos, tid in enumerate(self._alive_ids):
                if pos not in order:
                    self.trials[tid].alive = False
                    self.trials[tid].killed_at_round = self.round_number
            self._alive_ids = [self._alive_ids[p] for p in order]
            take = torch.as_tensor(order, dtype=torch.int64,
                                   device=self.device)
            self.trial_variables = tree_map(
                lambda l: l.index_select(0, take), self.trial_variables)
        best_tid = max(val_by_id, key=val_by_id.get)
        result = HPORoundResult(
            round_number=self.round_number,
            alive_trials=len(self._alive_ids),
            val_accuracies=val_by_id,
            best_trial_id=best_tid,
            best_val_accuracy=val_by_id[best_tid],
            halved=halved,
            round_time_s=time.perf_counter() - t0)
        self.round_number += 1
        self.history.append(result)
        return result

    def run(self, num_rounds: int) -> List[HPORoundResult]:
        return [self.run_round() for _ in range(num_rounds)]

    # ------------------------------------------------------------------
    def best_trial(self) -> Trial:
        """The best ALIVE trial by its latest validation accuracy."""
        alive = [self.trials[i] for i in self._alive_ids]
        return max(alive, key=lambda t: (t.val_history or [-1.0])[-1])

    def best_variables(self) -> Dict[str, Any]:
        """The stacked-slot model of the current best alive trial."""
        pos = self._alive_ids.index(self.best_trial().trial_id)
        return tree_map(lambda l: l[pos], self.trial_variables)
