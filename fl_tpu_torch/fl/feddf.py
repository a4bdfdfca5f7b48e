"""FedDF: server-side ensemble distillation as the aggregation step (port
of ``fl_tpu.fl.feddf``).

FedDF (Lin et al. 2020, "Ensemble Distillation for Robust Model Fusion in
Federated Learning"): after local training the client models form a
logit ensemble over an UNLABELED proxy set, and the new global model is
a student that starts at the FedAvg average and is trained to match the
ensemble's soft labels.

A round on the engine's device:

- every client trains from the global model (``make_local_train_fn``,
  the round engine's (round, client) streams);
- the student starts at the sample-weighted mean of the trained
  variables (not global + mean delta), cast to each leaf's dtype;
- ``distill_steps`` steps, each on ``distill_batch`` proxy images drawn
  uniformly with replacement from one generator seeded fold(SERVER
  stream, round), normalized as in training. The teacher is softmax(Σ_c
  logits_c / C / τ), the logits of ALL clients' models in eval mode summed
  in f32, never materialized as an ensemble model: the C models run as
  one stacked forward on the batch broadcast over the client axis (the
  fused conv kernel needs its input dense, so the broadcast is copied
  once, in the compute dtype). The student loss is τ²·KL(teacher ‖
  student) with 1e-12 inside the teacher's log; the student is one
  model, a (1, ...) stack, trained in eval mode by Adam (optax's
  ``adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 outside the square root,
  bias-corrected, freshly initialized every round) or SGD (p − lr·g);
- τ²·KL before and after the loop on the fixed probe batch
  ``proxy[:distill_batch]``. With ``distill_steps == 0`` the student IS
  the FedAvg average and both are 0.

Under a client mesh (``core.mesh``) the proxy set and the global model
are replicated and each rank trains its own CL = C / world_size clients
with their global ids' streams: one all-reduce carries the FedAvg sums
with the metrics, and one all-reduce a distill step (and one for the
probe) the (B, K) logit sum of each rank's clients. Every rank then runs
the same student update (``round_collectives``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from fl_tpu_torch.core import prng
from fl_tpu_torch.core.mesh import replicate_tree, resolve_device
from fl_tpu_torch.core.pytree import (
    tree_from_leaves, tree_leaves, tree_map, tree_paths)
from fl_tpu_torch.fl.local_training import (
    FederatedTrainingConfig,
    LocalOptimizer,
    cross_entropy_loss,
    make_local_train_fn,
    model_kwargs,
    train_variables,
)
from fl_tpu_torch.models.factory import init_model_variables
from fl_tpu_torch.parallel.collectives import ClientAxis


def proxy_indices(seed: int, steps: int, batch: int, size: int, device
                  ) -> torch.Tensor:
    """(steps, batch) proxy indices drawn uniformly from [0, size) with
    replacement, from one generator seeded ``seed``: every distill step's
    batch of a round."""
    return torch.randint(0, size, (steps, batch),
                         generator=prng.generator(seed, device),
                         device=device)


@dataclasses.dataclass(frozen=True)
class FedDFConfig:
    """FedDF knobs (paper defaults: Adam distillation, temperature 1)."""

    training: FederatedTrainingConfig = dataclasses.field(
        default_factory=FederatedTrainingConfig)
    distill_steps: int = 64          # server steps a round (0 = FedAvg)
    distill_batch: int = 256         # proxy examples a distill step
    distill_lr: float = 1e-3         # student optimizer lr
    # "adam" (the paper's choice) | "sgd". Adam is scale-invariant: it
    # takes lr-sized steps even from tiny gradients, where SGD holds an
    # exact fixpoint
    distill_optimizer: str = "adam"
    temperature: float = 1.0         # softmax temperature τ (loss τ²·KL)
    seed: int = 0


@dataclasses.dataclass
class FedDFRoundResult:
    round_number: int
    train_loss: float
    train_accuracy: float
    # τ²·KL(ensemble ‖ student) on the FIXED probe batch (the first
    # distill_batch proxy images), at the FedAvg init and after the loop
    distill_kl_before: float
    distill_kl_after: float
    round_time_s: float


class FedDFEngine:
    """The global model, the device-resident proxy set and the train +
    distill round. Runs on the GPU unless the caller asks for
    ``device="cpu"``; with ``mesh=`` on the mesh's device."""

    def __init__(self, model, data, proxy_images: np.ndarray,
                 config: FedDFConfig, mesh=None, device=None):
        if config.distill_steps < 0:
            raise ValueError("distill_steps must be >= 0")
        if config.temperature <= 0:
            raise ValueError("temperature must be > 0")
        proxy_images = np.asarray(proxy_images)
        if proxy_images.dtype != np.uint8:
            raise ValueError(
                "proxy_images must be uint8 pixels (the engine applies the "
                "dataset's normalization on-device, matching local "
                "training)")
        if proxy_images.shape[1:] != tuple(data.images.shape[2:]):
            raise ValueError(
                f"proxy image shape {proxy_images.shape[1:]} does not "
                f"match client data {tuple(data.images.shape[2:])}")
        if (config.distill_steps > 0
                and proxy_images.shape[0] < config.distill_batch):
            raise ValueError(
                f"proxy set ({proxy_images.shape[0]}) smaller than "
                f"distill_batch ({config.distill_batch})")
        self.model = model
        self.config = config
        self.mesh = mesh
        self.num_clients = data.num_clients
        self.device = resolve_device("FedDFEngine", device, mesh)
        if mesh is not None and data.num_clients % mesh.world_size:
            raise ValueError(
                f"num_clients={data.num_clients} must divide evenly over "
                f"the {mesh.world_size}-device mesh")
        self._axis = ClientAxis(mesh, self.num_clients)
        self.data = data.to_device(self.device, mesh=mesh)
        self.round_number = 0
        self._root = prng.root_seed(config.seed)
        self.global_variables: Dict[str, Any] = init_model_variables(
            model, prng.generator(prng.stream_seed(
                self._root, prng.Stream.INIT), self.device), self.device)
        if config.distill_optimizer not in ("adam", "sgd"):
            raise ValueError(
                f"distill_optimizer={config.distill_optimizer!r}: "
                "expected 'adam' or 'sgd'")
        # optax's adam(lr) / sgd(lr): the trainer's optimizer at lr = 1
        # (SGD's trace with momentum 0 is the gradient itself)
        self._opt = LocalOptimizer(FederatedTrainingConfig(
            optimizer_type=config.distill_optimizer, momentum=0.0))
        if mesh is not None:
            self.global_variables = replicate_tree(self.global_variables,
                                                   mesh)
        # the same host array on every rank: replicated as it stands
        self._proxy = torch.as_tensor(proxy_images).to(self.device)
        self._local_train = make_local_train_fn(
            model, config.training, self.data.samples_per_client,
            self.data.mean, self.data.std)
        self.history: List[FedDFRoundResult] = []
        # the collectives of the last round (under a mesh)
        self.round_collectives = []

    # ------------------------------------------------------------------
    def _normalize(self, x_u8: torch.Tensor) -> torch.Tensor:
        return (x_u8.float() / 255.0 - self.data.mean) / self.data.std

    @torch.no_grad()
    def _teacher(self, trained, xb: torch.Tensor) -> torch.Tensor:
        """softmax(Σ_c logits_c(xb) / C / τ) over ALL clients: this rank's
        clients' logit sum, one all-reduce under a mesh."""
        CL = tree_leaves(trained)[0].shape[0]
        logits = self.model(trained["params"],
                            xb[None].expand(CL, *xb.shape), train=False,
                            **model_kwargs(trained.get("batch_stats")))
        t_sum = self._axis.psum(logits.float().sum(0))
        return F.softmax(t_sum / float(self.num_clients)
                         / self.config.temperature, dim=-1)

    def _kd_loss(self, params, batch_stats, xb, teacher) -> torch.Tensor:
        """τ²·KL(teacher ‖ student) of the one-model student; the
        teacher's entropy term is kept so the loss → 0 as the student
        matches the ensemble."""
        tau = self.config.temperature
        s_logits = self.model(
            tree_map(lambda l: l[None], params), xb[None], train=False,
            **model_kwargs(None if batch_stats is None else
                           tree_map(lambda l: l[None], batch_stats)))[0]
        logp = F.log_softmax(s_logits.float() / tau, dim=-1)
        kl = (teacher * (torch.log(teacher + 1e-12) - logp)).sum(-1).mean()
        return tau * tau * kl

    def _distill(self, student, batch_stats, trained, dseed: int):
        """The distillation loop from the FedAvg student: returns (the
        student, KL before, KL after) on the probe batch."""
        cfg = self.config
        B = cfg.distill_batch
        xb0 = self._normalize(self._proxy[:B])
        teacher0 = self._teacher(trained, xb0)
        with torch.no_grad():
            kl_before = self._kd_loss(student, batch_stats, xb0, teacher0)
        paths = tree_paths(student)
        leaves = [l.detach().clone() for l in tree_leaves(student)]
        state = self._opt.init(leaves)
        batches = proxy_indices(dseed, cfg.distill_steps, B,
                                self._proxy.shape[0], self.device)
        for idx in batches:
            xb = self._normalize(self._proxy[idx])
            teacher = self._teacher(trained, xb)
            p = [l.requires_grad_(True) for l in leaves]
            loss = self._kd_loss(tree_from_leaves(paths, p), batch_stats,
                                 xb, teacher)
            grads = torch.autograd.grad(loss, p)
            self._opt.begin_step(state)
            with torch.no_grad():
                leaves = [
                    l.detach() + self._opt.leaf_update(state, i, g, l)
                    * -cfg.distill_lr
                    for i, (l, g) in enumerate(zip(p, grads))]
            del p, grads, loss
        student = tree_from_leaves(paths, leaves)
        with torch.no_grad():
            kl_after = self._kd_loss(student, batch_stats, xb0, teacher0)
        return student, kl_before, kl_after

    def run_round(self) -> FedDFRoundResult:
        t0 = time.perf_counter()
        cfg = self.config
        lo, hi = self._axis.rows
        self._axis.begin_round()
        rseed = prng.round_seed(self._root, self.round_number)
        dseed = prng.fold(prng.stream_seed(self._root, prng.Stream.SERVER),
                          self.round_number)
        stacked = tree_map(lambda g: g[None].expand(hi - lo, *g.shape),
                           self.global_variables)
        trained, metrics = train_variables(
            self._local_train, stacked, self.data.images, self.data.labels,
            self.data.num_samples, rseed, rows=(lo, self.num_clients))
        w = self.data.num_samples.float()
        # the FedAvg sums of the trained variables and the metric sums:
        # one reduce
        summed = self._axis.psum_tree({
            "sum": tree_map(lambda l: torch.tensordot(w, l.float(), dims=1),
                            trained),
            "metrics": torch.stack([(metrics["loss"] * w).sum(),
                                    (metrics["accuracy"] * w).sum(),
                                    w.sum()])})
        wsum = summed["metrics"][2].clamp(min=1e-12)
        avg = tree_map(lambda s, g: (s / wsum).to(g.dtype), summed["sum"],
                       self.global_variables)
        if cfg.distill_steps > 0:
            student, kl_before, kl_after = self._distill(
                avg["params"], avg.get("batch_stats"), trained, dseed)
            kl = torch.stack([kl_before, kl_after]).cpu().numpy()
        else:
            student, kl = avg["params"], np.zeros(2, np.float32)
        del trained
        self.global_variables = {**avg, "params": student}
        self.round_collectives = self._axis.calls
        m = summed["metrics"].cpu().numpy()
        wsum = max(float(m[2]), 1e-12)
        result = FedDFRoundResult(
            round_number=self.round_number,
            train_loss=float(m[0]) / wsum,
            train_accuracy=float(m[1]) / wsum,
            distill_kl_before=float(kl[0]),
            distill_kl_after=float(kl[1]),
            round_time_s=time.perf_counter() - t0)
        self.round_number += 1
        self.history.append(result)
        return result

    def run(self, num_rounds: int) -> List[FedDFRoundResult]:
        return [self.run_round() for _ in range(num_rounds)]

    @torch.no_grad()
    def evaluate(self, images: np.ndarray, labels: np.ndarray
                 ) -> Dict[str, np.ndarray]:
        """The global model on NORMALIZED images (the round engine's eval
        contract): loss, accuracy and per-class accuracy, averaged over
        full batches of at most 512."""
        x = torch.as_tensor(np.asarray(images, np.float32),
                            device=self.device)
        y = torch.as_tensor(np.asarray(labels, np.int64), device=self.device)
        n = x.shape[0]
        bs = min(512, n)
        v = self.global_variables
        params = tree_map(lambda t: t[None], v["params"])
        kw = model_kwargs(None if "batch_stats" not in v else tree_map(
            lambda t: t[None], v["batch_stats"]))
        losses, accs, correct, total = [], [], 0.0, 0.0
        for i in range(max(1, n // bs)):
            xb, yb = x[None, i * bs:(i + 1) * bs], y[None, i * bs:(i + 1) * bs]
            logits = self.model(params, xb, train=False, **kw)
            hit = logits.argmax(-1) == yb
            losses.append(cross_entropy_loss(logits, yb))
            accs.append(hit.float().mean(1))
            onehot = F.one_hot(yb[0], logits.shape[-1]).float()
            correct = correct + (hit[0].float()[:, None] * onehot).sum(0)
            total = total + onehot.sum(0)
        return {"loss": np.asarray(float(torch.cat(losses).mean())),
                "accuracy": np.asarray(float(torch.cat(accs).mean())),
                "per_class_accuracy": (correct / total.clamp(min=1.0)
                                       ).cpu().numpy()}
