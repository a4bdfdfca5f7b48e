"""Ditto: per-client personal models trained beside the global model
(port of ``fl_tpu.fl.ditto``; Li et al. 2021).

Beside the shared global model θ_g every client keeps a PERSISTENT
personal model v_i, trained on its own shard with a pull toward the
global:

    v_i ← v_i − η·(∇L_i(v_i) + λ·(v_i − θ_g))

λ = 0 leaves the personal models uncoupled; λ → ∞ pins them to θ_g.

The reference's decomposition, with w starting at v_i^start:

    λ(w − θ_g) = λ(w − v_i^start) + λ(v_i^start − θ_g)

the first term is FedProx's proximal gradient anchored at the start
(``proximal_mu = λ``) and the second is constant over the local run, the
trainer's ``correction`` operand (SCAFFOLD's and FedDyn's hook), in f32
on the params. So one ``make_local_train_fn`` call trains all C personal
models over the stacked client axis. A BatchNorm model's personal
statistics travel through the trainer's ``extra=``: the reference trains
the whole v_i tree.

Each ``step`` draws the streams of fold(stream(round(steps_taken),
PERSONALIZE), 0xD1770), which ``evaluate_personalized``'s (round,
PERSONALIZE) stream never equals. Under the engine's client mesh each
rank holds only its own rows of the personal models and trains them with
their global ids' streams; the per-client results come back in global
order through one all-reduce.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from fl_tpu_torch.core import prng
from fl_tpu_torch.core.pytree import tree_map
from fl_tpu_torch.fl.federated_eval import (
    evaluate_federated, gather_scores, make_federated_eval_fn)
from fl_tpu_torch.fl.local_training import (
    make_local_train_fn,
    train_variables,
)

# the step's stream tag on top of PERSONALIZE (the reference's)
DITTO_TAG = 0xD1770


def step_seed(root: int, steps_taken: int) -> int:
    """The trainer's round seed of Ditto step ``steps_taken``."""
    return prng.fold(prng.stream_seed(prng.round_seed(root, steps_taken),
                                      prng.Stream.PERSONALIZE), DITTO_TAG)


class DittoPersonalizer:
    """Per-client personal models trained alongside a round engine.

    Usage::

        eng = FederatedRoundEngine(model, data, cfg)
        ditto = DittoPersonalizer(eng, lam=0.1)
        for _ in range(rounds):
            eng.run_round()
            ditto.step()          # one personal-update pass per round
        ditto.evaluate_personal()  # per-client accuracy of the v_i
    """

    def __init__(self, engine, lam: float,
                 personal_epochs: Optional[int] = None):
        if lam < 0:
            raise ValueError("lam must be >= 0")
        self.engine = engine
        self.lam = float(lam)
        # Ditto's own λ-pull replaces any global-objective proximal term
        tcfg = dataclasses.replace(engine.config.training,
                                   proximal_mu=self.lam)
        if personal_epochs is not None:
            tcfg = dataclasses.replace(tcfg, local_epochs=personal_epochs)
        self._local_train = make_local_train_fn(
            engine.model, tcfg, engine.data.samples_per_client,
            engine.data.mean, engine.data.std)
        # the personal models start at the global model: this rank's rows
        CL = engine.data.images.shape[0]
        self.personal_variables: Dict[str, Any] = tree_map(
            lambda x: x[None].expand(CL, *x.shape).clone(),
            engine.global_variables)
        self.steps_taken = 0

    # ------------------------------------------------------------------
    def step(self) -> Dict[str, float]:
        """One personal-update pass for every client against the CURRENT
        global model. Call after each engine round (Ditto Alg. 1
        interleaves the two)."""
        eng = self.engine
        g_params = eng.global_variables["params"]
        lam = self.lam
        corr = tree_map(lambda v, g: lam * (v.float() - g.float()[None]),
                        self.personal_variables["params"], g_params)
        self.personal_variables, metrics = train_variables(
            self._local_train, self.personal_variables, eng.data.images,
            eng.data.labels, eng.data.num_samples,
            step_seed(eng._root, self.steps_taken), correction=corr,
            rows=(eng._rows[0], eng.num_clients))
        del corr
        self.steps_taken += 1
        per = eng._axis.psum(torch.stack([
            eng._axis.per_client(metrics["loss"]),
            eng._axis.per_client(metrics["accuracy"])])).cpu().numpy()
        w = np.asarray(eng._num_samples, np.float64)
        w = w / max(w.sum(), 1.0)
        return {"personal_loss": float((per[0] * w).sum()),
                "personal_accuracy": float((per[1] * w).sum())}

    # ------------------------------------------------------------------
    def evaluate_personal(self) -> Dict[str, object]:
        """Each PERSONAL model scored on its own shard (the metric Ditto
        optimizes), plus the global model's numbers on the same shards
        for the personalization gain."""
        eng = self.engine
        fn = make_federated_eval_fn(
            eng.model, samples_per_client=eng.data.samples_per_client,
            mean=eng.data.mean, std=eng.data.std)
        pv = self.personal_variables
        out = gather_scores(eng, fn(pv["params"], eng.data.images,
                                    eng.data.labels, eng.data.num_samples,
                                    pv.get("batch_stats")))
        global_side = evaluate_federated(eng)
        w = out["n"].astype(np.float64)
        w = w / max(w.sum(), 1.0)
        personal_acc = float((out["accuracy"] * w).sum())
        return {
            "per_client": out,
            "personal_accuracy": personal_acc,
            "global_accuracy": global_side["accuracy"],
            "personalization_gain": personal_acc - global_side["accuracy"],
        }

    # ------------------------------------------------------------------
    def personal_model(self, i: int) -> Dict[str, Any]:
        """Client i's personal variables; under a mesh only this rank's
        clients are held here."""
        if not 0 <= i < self.engine.num_clients:
            raise IndexError(f"client {i} out of range")
        lo, hi = self.engine._rows
        if not lo <= i < hi:
            raise ValueError(
                f"client {i} is held by another rank of the mesh (this "
                f"rank holds clients [{lo}, {hi}))")
        return tree_map(lambda l: l[i - lo], self.personal_variables)
