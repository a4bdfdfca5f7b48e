"""Local client training over the stacked client axis.

The port of ``fl_tpu.fl.local_training`` for the slice: every client runs
``local_epochs`` epochs of ``samples_per_client // batch_size`` Adam steps
on its own device-resident shard, all clients in one batched step (the
client axis written out where the reference vmaps). Per step: gather each
client's batch through its epoch permutation, normalize on the device,
forward through the model, mean cross-entropy per client, one backward for
all clients (client c's loss depends only on client c's parameters, so the
gradient of the summed loss is every client's own gradient), Adam.

What is ported: Adam with both moments stored in ``optimizer_state_dtype``
and arithmetic in f32 (``_scale_by_adam_stored`` then ``scale(-lr)``; f32
moments when it is None, as ``optax.adam``); the per-epoch permutation with
padded slots remapped into the valid region; the homogeneous-epoch path;
metrics of the last epoch. Masked heterogeneous epochs, FedProx, SCAFFOLD,
``grad_mask``, a traced learning rate, bf16 parameter storage and DP-SGD are
not ported; the configuration refuses them.

Parameters are updated in place inside the step loop, which keeps one copy
of the (C, params) tree instead of one per step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fl_tpu_torch.core import prng
from fl_tpu_torch.core.pytree import tree_paths

_STATE_DTYPES = {None: torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class FederatedTrainingConfig:
    """Local-training hyperparameters (the fields of
    ``fl_tpu.fl.local_training.FederatedTrainingConfig`` that the slice
    uses, plus the refused ones so a reference config is not silently
    misread)."""

    local_epochs: int = 5
    batch_size: int = 32
    learning_rate: float = 0.001
    optimizer_type: str = "adam"
    proximal_mu: float = 0.0
    optimizer_state_dtype: Optional[str] = None
    param_storage_dtype: Optional[str] = None

    def __post_init__(self) -> None:
        if self.optimizer_type != "adam":
            raise ValueError(f"optimizer_type={self.optimizer_type!r} is not "
                             "ported yet (only 'adam')")
        if self.proximal_mu != 0.0:
            raise ValueError("proximal_mu (FedProx) is not ported yet")
        if self.param_storage_dtype is not None:
            raise ValueError("param_storage_dtype (bf16 parameter storage) "
                             "is not ported yet")
        if self.optimizer_state_dtype not in _STATE_DTYPES:
            raise ValueError("optimizer_state_dtype must be None or "
                             f"'bfloat16', got {self.optimizer_state_dtype!r}")
        if self.local_epochs < 1 or self.batch_size < 1:
            raise ValueError("local_epochs and batch_size must be positive")


class AdamState:
    """Adam moments for a list of stacked parameter tensors."""

    def __init__(self, leaves: List[torch.Tensor], state_dtype: torch.dtype):
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=state_dtype) for p in leaves]
        self.nu = [torch.zeros_like(p, dtype=state_dtype) for p in leaves]


@torch.no_grad()
def adam_update_(leaves: List[torch.Tensor], grads, state: AdamState,
                 lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> None:
    """One Adam step in place: moments in f32 arithmetic, stored back in
    their storage dtype; params += -lr · m̂ / (sqrt(v̂) + eps)."""
    state.count += 1
    f32 = np.float32
    c1 = float(f32(1) - f32(b1) ** f32(state.count))
    c2 = float(f32(1) - f32(b2) ** f32(state.count))
    for p, g, m, v in zip(leaves, grads, state.mu, state.nu):
        g = g.float()
        mu = b1 * m.float() + (1 - b1) * g
        nu = b2 * v.float() + (1 - b2) * (g * g)
        p.add_(-lr * ((mu / c1) / (torch.sqrt(nu / c2) + eps)))
        m.copy_(mu)
        v.copy_(nu)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """Per-client mean softmax cross-entropy: logits (C, B, K), labels
    (C, B) → (C,)."""
    C, B, K = logits.shape
    per = F.cross_entropy(logits.reshape(C * B, K), labels.reshape(C * B),
                          reduction="none")
    return per.reshape(C, B).mean(1)


def make_local_train_fn(model, cfg: FederatedTrainingConfig,
                        samples_per_client: int, mean: torch.Tensor,
                        std: torch.Tensor) -> Callable:
    """Build ``local_train(params, images_u8, labels, n_valid, rseed) ->
    (new_params, metrics)``.

    ``params`` is a tree of (C, ...) f32 tensors (not modified),
    ``images_u8`` (C, N, H, W, ch), ``labels`` (C, N) int64, ``n_valid``
    (C,) true shard sizes and ``rseed`` the round's seed
    (``prng.round_seed``). ``metrics`` holds (C,) tensors ``loss`` and
    ``accuracy`` of the last epoch.
    """
    batch = cfg.batch_size
    steps_per_epoch = max(1, samples_per_client // batch)
    state_dtype = _STATE_DTYPES[cfg.optimizer_state_dtype]

    def local_train(params, images_u8, labels, n_valid, rseed):
        device = images_u8.device
        C, N = images_u8.shape[:2]
        paths = tree_paths(params)
        leaves = [params[l][k].detach()
                  .clone(memory_format=torch.contiguous_format)
                  .requires_grad_(True) for l, k in paths]
        tree: Dict = {}
        for (l, k), t in zip(paths, leaves):
            tree.setdefault(l, {})[k] = t
        opt = AdamState(leaves, state_dtype)
        n = n_valid.clamp(min=1).long()[:, None]
        rows = torch.arange(C, device=device)[:, None]
        shuffle_seed = prng.stream_seed(rseed, prng.Stream.SHUFFLE)
        dropout_seed = prng.stream_seed(rseed, prng.Stream.DROPOUT)

        for epoch in range(cfg.local_epochs):
            g = prng.generator(prng.fold(shuffle_seed, epoch), device)
            perm_raw = torch.argsort(
                torch.rand((C, N), generator=g, device=device), dim=1)
            # remap padded slots into the valid region (keeps batches dense)
            perm = torch.where(perm_raw < n, perm_raw, perm_raw % n)
            ep_loss = torch.zeros(C, device=device)
            ep_acc = torch.zeros(C, device=device)
            for step in range(steps_per_epoch):
                idx = perm[:, step * batch:(step + 1) * batch]
                xb = (images_u8[rows, idx].float() / 255.0 - mean) / std
                yb = labels[rows, idx]
                dgen = prng.generator(
                    prng.fold(dropout_seed, epoch * steps_per_epoch + step),
                    device)
                logits = model(tree, xb, train=True, generator=dgen)
                loss = cross_entropy_loss(logits, yb)
                grads = torch.autograd.grad(loss.sum(), leaves)
                adam_update_(leaves, grads, opt, cfg.learning_rate)
                ep_loss += loss.detach()
                ep_acc += (logits.detach().argmax(-1) == yb).float().mean(1)
        new_params = {l: {k: t.detach() for k, t in d.items()}
                      for l, d in tree.items()}
        return new_params, {"loss": ep_loss / steps_per_epoch,
                            "accuracy": ep_acc / steps_per_epoch}

    return local_train


@torch.no_grad()
def evaluate_test_set(model, params, images: torch.Tensor,
                      labels: torch.Tensor, batch_size: int = 512
                      ) -> Dict[str, float]:
    """Loss and accuracy of one (unstacked) model on normalized images,
    averaged over full batches as ``fl_tpu``'s ``make_eval_fn`` does."""
    n = images.shape[0]
    bs = min(batch_size, n)
    stacked = {l: {k: v[None] for k, v in d.items()}
               for l, d in params.items()}
    losses, accs = [], []
    for i in range(max(1, n // bs)):
        xb = images[None, i * bs:(i + 1) * bs]
        yb = labels[None, i * bs:(i + 1) * bs]
        logits = model(stacked, xb)
        losses.append(cross_entropy_loss(logits, yb))
        accs.append((logits.argmax(-1) == yb).float().mean(1))
    return {"loss": float(torch.cat(losses).mean()),
            "accuracy": float(torch.cat(accs).mean())}
