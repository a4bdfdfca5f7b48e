"""Vertical (feature-partitioned) federated learning, SplitNN-style (port
of ``fl_tpu.fl.vertical``).

K parties hold different *features* of the SAME examples and party 0 holds
the labels (Yang et al. 2019 §2.2; Vepakomma et al. 2018). Raw features
never leave a party; the only exchanged tensors are the cut activations
(forward) and the cut gradients (backward).

Party k owns a bottom tower ``x_k → Dense(hidden) → relu →
Dense(cut_dim)``; the label party owns the top model ``concat(cuts) → relu
→ Dense(hidden) → relu → Dense(classes)``. Every party's forward and
backward run in this process on one device (a simulation of the message
flow, as the horizontal engines simulate theirs), with the cut tensors
surfaced so that the engine can account the exchanged bytes and, with
``cut_noise_std``, perturb the cut (a defense experiment knob, NOT a
certified DP mechanism).

The parameters are lists of ``{"w", "b"}`` tensors (the reference's
layout: (din, dout) kernels), trained by Adam written out as optax's
``adam`` computes it: bias-corrected moments, eps outside the square
root. An epoch draws its permutation from root → epoch → SHUFFLE and the
cut noise of step s for party k from fold(fold(root → epoch → DP_NOISE,
s), k); the features and labels stay on the device for the whole run.
:func:`params_from_reference` / :func:`params_to_reference` carry the
reference's ``bottom_params`` / ``top_params`` (numpy ``{"w", "b"}``
lists) across.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fl_tpu_torch.core import prng
from fl_tpu_torch.core.mesh import resolve_device
from fl_tpu_torch.core.transfer import to_device

Layers = List[Dict[str, torch.Tensor]]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class VerticalConfig:
    learning_rate: float = 1e-3
    batch_size: int = 64
    hidden: int = 128
    cut_dim: int = 32
    # Gaussian noise added to each party's cut activations during training
    # (forward); an experiment knob for cut-reconstruction defenses, NOT a
    # certified DP mechanism (no sensitivity bound on activations)
    cut_noise_std: float = 0.0
    seed: int = 0


def split_features(x: np.ndarray, parts: int) -> List[np.ndarray]:
    """Column-split a (N, D) feature matrix into ``parts`` contiguous
    blocks (the canonical vertical partition); images are flattened
    first."""
    x = np.asarray(x)
    n = x.shape[0]
    flat = x.reshape(n, -1)
    return [np.ascontiguousarray(b) for b in
            np.array_split(flat, parts, axis=1)]


def _init_layers(seed: int, sizes: Sequence[Tuple[int, int]],
                 device) -> Layers:
    """N(0, 1/din) kernels and zero biases; layer i draws from fold(seed,
    i)."""
    out = []
    for i, (din, dout) in enumerate(sizes):
        g = prng.generator(prng.fold(seed, i), device)
        out.append({
            "w": torch.randn((din, dout), generator=g, device=device)
            * math.sqrt(1.0 / din),
            "b": torch.zeros((dout,), dtype=torch.float32, device=device),
        })
    return out


def params_from_reference(layers, device) -> Layers:
    """A reference tower (a list of ``{"w", "b"}`` arrays) as the port's
    f32 tensors on ``device``."""
    return [{k: to_device(np.array(layer[k], np.float32), device)
             for k in ("w", "b")} for layer in layers]


def params_to_reference(layers: Layers) -> List[Dict[str, np.ndarray]]:
    """The port's tower as the reference's list of numpy ``{"w", "b"}``."""
    return [{k: layer[k].detach().cpu().numpy() for k in ("w", "b")}
            for layer in layers]


def _bottom(params: Layers, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ params[0]["w"] + params[0]["b"])
    return h @ params[1]["w"] + params[1]["b"]


def _top(params: Layers, cut: torch.Tensor) -> torch.Tensor:
    h = torch.relu(cut)
    h = torch.relu(h @ params[0]["w"] + params[0]["b"])
    return h @ params[1]["w"] + params[1]["b"]


def _loss_acc(logits: torch.Tensor, y: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    loss = F.cross_entropy(logits, y)
    acc = (logits.argmax(-1) == y).float().mean()
    return loss, acc


class VerticalFLEngine:
    """K-party SplitNN trainer over feature-partitioned data.

    ``feature_splits``: list of (N, d_k) float arrays, party k's columns,
    row-aligned across parties. ``labels``: (N,) int, held by the label
    party (party 0 by convention). ``device``: None is the card.
    """

    def __init__(self, feature_splits: Sequence[np.ndarray],
                 labels: np.ndarray, num_classes: int,
                 config: VerticalConfig = VerticalConfig(),
                 test_splits: Optional[Sequence[np.ndarray]] = None,
                 test_labels: Optional[np.ndarray] = None,
                 device=None):
        if len(feature_splits) < 2:
            raise ValueError("vertical FL needs >= 2 parties (one party "
                             "owning every column is centralized training)")
        n = feature_splits[0].shape[0]
        for i, s in enumerate(feature_splits):
            if s.ndim != 2 or s.shape[0] != n:
                raise ValueError(
                    f"party {i} features must be (N, d_k) row-aligned: "
                    f"got {s.shape}, N={n}")
        if len(labels) != n:
            raise ValueError("labels must align with the feature rows")
        self.device = resolve_device("VerticalFLEngine", device, None)
        self.cfg = config
        self.num_parties = len(feature_splits)
        self.num_classes = int(num_classes)
        self.features = [to_device(np.asarray(s, np.float32), self.device)
                         for s in feature_splits]
        self.labels = to_device(np.asarray(labels, np.int64), self.device)
        self.n = n
        self._test = None
        if test_splits is not None:
            self._test = (
                [to_device(np.asarray(s, np.float32), self.device)
                 for s in test_splits],
                to_device(np.asarray(test_labels, np.int64), self.device))

        self._root = prng.root_seed(config.seed)
        c = config
        self.bottom_params = [
            _init_layers(prng.fold(self._root, 100 + k),
                         [(self.features[k].shape[1], c.hidden),
                          (c.hidden, c.cut_dim)], self.device)
            for k in range(self.num_parties)
        ]
        self.top_params = _init_layers(
            prng.fold(self._root, 999),
            [(c.cut_dim * self.num_parties, c.hidden),
             (c.hidden, self.num_classes)], self.device)
        self._reset_optimizer()
        self.epoch = 0

    # -- parameters ---------------------------------------------------------
    def _leaves(self) -> List[torch.Tensor]:
        return [layer[k] for tower in self.bottom_params + [self.top_params]
                for layer in tower for k in ("w", "b")]

    def _reset_optimizer(self) -> None:
        self.opt_count = 0
        self.opt_mu = [torch.zeros_like(t) for t in self._leaves()]
        self.opt_nu = [torch.zeros_like(t) for t in self._leaves()]

    def load_reference_params(self, bottom_params, top_params) -> None:
        """Replace the towers by the reference's (lists of numpy ``{"w",
        "b"}``); Adam starts afresh, as at the reference's init."""
        self.bottom_params = [params_from_reference(t, self.device)
                              for t in bottom_params]
        self.top_params = params_from_reference(top_params, self.device)
        self._reset_optimizer()

    def reference_params(self):
        """(bottom_params, top_params) in the reference's numpy layout."""
        return ([params_to_reference(t) for t in self.bottom_params],
                params_to_reference(self.top_params))

    # -- one step -------------------------------------------------------------
    def _forward(self, xparts: Sequence[torch.Tensor],
                 noise_seed: Optional[int] = None) -> torch.Tensor:
        cuts = [_bottom(self.bottom_params[k], xparts[k])
                for k in range(self.num_parties)]
        if noise_seed is not None and self.cfg.cut_noise_std > 0:
            cuts = [cut + self.cfg.cut_noise_std * torch.randn(
                        cut.shape, device=cut.device,
                        generator=prng.generator(prng.fold(noise_seed, k),
                                                 cut.device))
                    for k, cut in enumerate(cuts)]
        return _top(self.top_params, torch.cat(cuts, 1))

    def _adam_step(self, params: List[torch.Tensor],
                   grads: Sequence[torch.Tensor]) -> None:
        """optax.adam: mu, nu updated, bias-corrected by the step count,
        −lr·m̂/(√v̂ + eps)."""
        self.opt_count += 1
        c1 = 1.0 - ADAM_B1 ** self.opt_count
        c2 = 1.0 - ADAM_B2 ** self.opt_count
        lr = self.cfg.learning_rate
        for p, g, m, v in zip(params, grads, self.opt_mu, self.opt_nu):
            m.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
            v.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
            p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS))

    def run_epoch(self) -> Dict[str, float]:
        c = self.cfg
        steps = max(1, self.n // c.batch_size)
        eseed = prng.round_seed(self._root, self.epoch)
        perm = torch.randperm(
            self.n, device=self.device,
            generator=prng.generator(
                prng.stream_seed(eseed, prng.Stream.SHUFFLE), self.device))
        noise_root = prng.stream_seed(eseed, prng.Stream.DP_NOISE)
        params = self._leaves()
        losses, accs = [], []
        for s in range(steps):
            idx = perm[s * c.batch_size:(s + 1) * c.batch_size]
            xb = [f.index_select(0, idx) for f in self.features]
            yb = self.labels.index_select(0, idx)
            for p in params:
                p.requires_grad_(True)
            logits = self._forward(xb, prng.fold(noise_root, s))
            loss, acc = _loss_acc(logits, yb)
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for p in params:
                    p.requires_grad_(False)
                self._adam_step(params, grads)
            losses.append(loss.detach())
            accs.append(acc)
        self.epoch += 1
        return {"epoch": self.epoch - 1,
                "train_loss": float(torch.stack(losses).mean()),
                "train_accuracy": float(torch.stack(accs).mean())}

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        if self._test is None:
            raise ValueError("no test split configured")
        xparts, y = self._test
        loss, acc = _loss_acc(self._forward(xparts), y)
        return {"loss": float(loss), "accuracy": float(acc)}

    # -- communication accounting --------------------------------------------
    def exchanged_bytes_per_step(self) -> int:
        """Wire bytes per SGD step in a deployment: each non-label party
        ships its (B, cut_dim) f32 activations and receives the same-shaped
        gradient; the label party's own cut never crosses the wire."""
        per_party = 2 * self.cfg.batch_size * self.cfg.cut_dim * 4
        return (self.num_parties - 1) * per_party

    def exchanged_bytes_per_epoch(self) -> int:
        return (self.n // self.cfg.batch_size) \
            * self.exchanged_bytes_per_step()

    def raw_feature_bytes(self) -> int:
        """What centralizing the non-label parties' raw columns would cost
        (the thing vertical FL avoids)."""
        return int(sum(int(np.prod(f.shape)) * 4
                       for f in self.features[1:]))
