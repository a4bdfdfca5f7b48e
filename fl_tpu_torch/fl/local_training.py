"""Local client training over the stacked client axis.

The port of ``fl_tpu.fl.local_training``: every client runs up to
``local_epochs`` epochs of ``samples_per_client // batch_size`` steps on
its own device-resident shard, all clients in one batched step (the client
axis written out where the reference vmaps). Per step: gather each
client's batch through its epoch permutation, normalize on the device,
forward through the model, mean cross-entropy per client, one backward for
all clients (client c's loss depends only on client c's parameters, so the
gradient of the summed loss is every client's own gradient), then

    gradient + correction (SCAFFOLD's c − c_i)
             + μ·(w − w_global)        (FedProx)
             × grad_mask               (frozen leaves; applied last)
    → the optimizer at learning rate 1 → × (−lr) → w + update
    → bf16 parameter storage: stochastic rounding (``ops.rounding``)

The optimizers follow optax as the reference's ``make_optimizer`` builds
them: "adam" (both moments stored in ``optimizer_state_dtype``, arithmetic
in f32), "adamw" (Adam, then ``add_decayed_weights`` on every leaf) and
"sgd" (heavy-ball ``trace = g + momentum·trace``, an f32 trace). Every
update is linear in the learning rate, so a per-client (C,) ``lr`` scales
the lr = 1 update and is bit for bit a static rate.

Heterogeneous epochs: with a (C,) ``epochs`` budget, a client whose budget
is spent keeps its parameters and optimizer state through masked selects;
without one the selects are not made. Adam's step count stays one number
for all clients: a budget only ever stops a client, so every client still
active has taken every step so far. The metrics are those of each
client's last active epoch.

DP-SGD: with ``dp_sgd_fn`` (``fl.privacy``'s microbatch or ghost
gradient) every step's gradient is the per-example-clipped, noised one;
the step's metrics come from a forward pass only (the plain backward is
not run). Padded shard slots are not remapped for it: ``wmask =
perm_raw < n`` gives them weight 0, so each real example sits in exactly
one slot an epoch and its inclusion probability a step is exactly
batch/shard, the q the accountant uses (the batch itself is gathered
through the remapped permutation, as in the reference, and the masked
slots' values never count). Its noise seed is fold(fold(round, DP_NOISE),
epoch·steps + step), its dropout seed the step's dropout seed.

Model collections besides the parameters (``extra``: CIFAR10CNN's
``batch_stats``, the per-client running statistics of its BatchNorms) are
carried through the steps: each training forward returns them updated,
they are no parameter (no gradient, no optimizer), and under
heterogeneous budgets the masked select keeps a spent client's as well.

Augmentation: ``augment_fn(xb, generator)`` (``ops.preprocess.
make_cifar_augment``) runs on each normalized batch, its draws from one
generator a step seeded fold(fold(round, AUGMENT), epoch·steps + step).

Sharded client axis (``core.mesh``): with ``rows=(first, total)`` the
trainer holds clients first, …, first + C − 1 of ``total`` and gives each
the streams it has in a single-process round: the shuffle, the dropout
masks and the augmentation draws are drawn for all ``total`` clients and
sliced to these rows (index- and activation-sized), the rounding seeds and
DP-SGD's noise are keyed by global client id.

Rows from several rounds (FedBuff's buffer, ``fl.async_fl``): with
``rows=(ids, total)`` and a (C,) sequence of round seeds, row i is global
client ids[i] of the round whose seed is the i-th, and gets that round's
streams: the shuffle and the dropout masks are drawn once for each
distinct round seed, for all ``total`` clients, and gathered at the rows'
ids; the rounding seeds are keyed by (round seed, id). One round seed and
consecutive ids take the sliced path above, so those rows draw bit for
bit what a round draws. DP-SGD and augmentation take one round's rows
only.

Parameters are updated in place inside the step loop where they are
stored in f32, which keeps one copy of the (C, params) tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fl_tpu_torch.core import prng
from fl_tpu_torch.core.pytree import (
    tree_from_leaves, tree_get, tree_map, tree_paths)
from fl_tpu_torch.core.transfer import to_device
from fl_tpu_torch.ops import rounding

_STATE_DTYPES = {None: torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class FederatedTrainingConfig:
    """Local-training hyperparameters (the fields of
    ``fl_tpu.fl.local_training.FederatedTrainingConfig``)."""

    local_epochs: int = 5
    batch_size: int = 32
    learning_rate: float = 0.001
    optimizer_type: str = "adam"  # adam | adamw | sgd
    validation_split: float = 0.1
    early_stopping_patience: Optional[int] = None
    save_checkpoints: bool = True
    momentum: float = 0.9
    weight_decay: float = 1e-4
    # FedProx (Li et al. 2020): μ·(w − w_global) added to every step's
    # gradient; 0.0 = plain local training
    proximal_mu: float = 0.0
    optimizer_state_dtype: Optional[str] = None
    # "bfloat16": the per-client parameters are carried in bf16 between
    # steps, written back by stochastic rounding; arithmetic stays f32 and
    # clients still return f32
    param_storage_dtype: Optional[str] = None

    def __post_init__(self) -> None:
        if self.optimizer_state_dtype not in _STATE_DTYPES:
            raise ValueError("optimizer_state_dtype must be None or "
                             f"'bfloat16', got {self.optimizer_state_dtype!r}")
        if self.local_epochs < 1 or self.batch_size < 1:
            raise ValueError("local_epochs and batch_size must be positive")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FederatedTrainingConfig":
        return cls(**{k: v for k, v in d.items()
                      if k in {f.name for f in dataclasses.fields(cls)}})


def create_adaptive_config(capabilities: Dict[str, Any]
                           ) -> FederatedTrainingConfig:
    """Capability → hyperparameters, as the reference's table: HIGH → (10
    epochs, batch 64), MEDIUM → (5, 32), LOW → (3, 16, lr 5e-4); small
    datasets cap the batch, large ones double it; low bandwidth adds local
    epochs."""
    power = capabilities.get("compute_power", "medium")
    power = getattr(power, "value", power)  # accept the enum
    bandwidth = capabilities.get("network_bandwidth", 10)
    samples = capabilities.get("available_samples", 1000)

    if power == "high":
        epochs, batch, lr = 10, 64, 0.001
    elif power == "medium":
        epochs, batch, lr = 5, 32, 0.001
    else:
        epochs, batch, lr = 3, 16, 0.0005

    if samples < 500:
        batch = min(batch, 16)
    elif samples > 5000:
        batch = min(batch * 2, 128)

    if bandwidth < 5:
        epochs = max(epochs + 2, 7)

    return FederatedTrainingConfig(
        local_epochs=epochs, batch_size=batch, learning_rate=lr,
        optimizer_type="adam",
    )


class OptimizerState:
    """The state of :class:`LocalOptimizer` over a list of stacked leaves:
    the step count with Adam's bias corrections, and Adam's two moments
    or SGD's trace, one tensor a leaf."""

    def __init__(self, slots: List[List[torch.Tensor]]):
        self.count = 0
        self.c1 = self.c2 = 1.0
        self.slots = slots


def _commit(dst: torch.Tensor, new: torch.Tensor,
            active: Optional[torch.Tensor]) -> None:
    """dst ← new in dst's dtype, or for the active clients only."""
    if active is None:
        dst.copy_(new)
    else:
        dst.copy_(torch.where(active, new, dst))


class LocalOptimizer:
    """optax's "adam" / "adamw" / "sgd" as the reference's ``make_optimizer``
    builds them, at learning rate 1 over stacked leaves: a step is
    :meth:`begin_step`, then :meth:`leaf_update` for each leaf, which
    returns the update that the caller scales by −lr."""

    def __init__(self, cfg: FederatedTrainingConfig,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        if cfg.optimizer_type not in ("adam", "adamw", "sgd"):
            raise ValueError(f"Unknown optimizer: {cfg.optimizer_type}")
        self.kind = cfg.optimizer_type
        self.momentum = cfg.momentum
        self.weight_decay = cfg.weight_decay
        self.state_dtype = _STATE_DTYPES[cfg.optimizer_state_dtype]
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, leaves: List[torch.Tensor]) -> OptimizerState:
        if self.kind == "sgd":  # optax.trace's f32 accumulator
            return OptimizerState([[torch.zeros_like(
                p, dtype=torch.float32) for p in leaves]])
        return OptimizerState([
            [torch.zeros_like(p, dtype=self.state_dtype) for p in leaves]
            for _ in range(2)])

    def begin_step(self, state: OptimizerState) -> None:
        state.count += 1
        f32 = np.float32
        state.c1 = float(f32(1) - f32(self.b1) ** f32(state.count))
        state.c2 = float(f32(1) - f32(self.b2) ** f32(state.count))

    @torch.no_grad()
    def leaf_update(self, state: OptimizerState, i: int, g: torch.Tensor,
                    p: torch.Tensor, active: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """Leaf i's lr = 1 update, its state committed (for the clients
        whose broadcastable bool ``active`` is true, where given)."""
        g = g.float()
        if self.kind == "sgd":
            t = state.slots[0][i]
            tr = g + self.momentum * t
            _commit(t, tr, active)
            return tr
        b1, b2 = self.b1, self.b2
        m, v = state.slots[0][i], state.slots[1][i]
        mu = b1 * m.float() + (1 - b1) * g
        nu = b2 * v.float() + (1 - b2) * (g * g)
        u = (mu / state.c1) / (torch.sqrt(nu / state.c2) + self.eps)
        if self.kind == "adamw":
            u = u + self.weight_decay * p
        _commit(m, mu, active)
        _commit(v, nu, active)
        return u


def per_example_losses(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """Softmax cross-entropy of each example: (C, B, K), (C, B) → (C, B)."""
    C, B, K = logits.shape
    return F.cross_entropy(logits.reshape(C * B, K), labels.reshape(C * B),
                           reduction="none").reshape(C, B)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """Per-client mean softmax cross-entropy: logits (C, B, K), labels
    (C, B) → (C,)."""
    return per_example_losses(logits, labels).mean(1)


def rounding_seeds(rseed: int, num_clients: int, device, first: int = 0
                   ) -> torch.Tensor:
    """(C,) u32 seeds of the stochastic rounding of a round, one a client
    (global ids first, …): the two halves of fold(fold(round, c),
    ROUNDING) xor-ed."""
    s = prng.client_stream_seeds(rseed, num_clients, prng.Stream.ROUNDING,
                                 first=first)
    return _u32_seeds(s, device)


def _u32_seeds(s: np.ndarray, device) -> torch.Tensor:
    s = (s ^ (s >> np.uint64(32))) & np.uint64(0xFFFFFFFF)
    return to_device(s.astype(np.int64), device)


def _row_rounding_seeds(rseeds: np.ndarray, ids: np.ndarray, device
                        ) -> torch.Tensor:
    """:func:`rounding_seeds` of each row's own (round seed, global id)."""
    with np.errstate(over="ignore"):
        s = prng.fold_many(prng.fold_many(prng.fold_many(
            rseeds, ids.astype(np.uint64)), int(prng.Stream.ROUNDING)), 0)
    return _u32_seeds(s, device)


def _stream_groups(rseed, rows, C: int):
    """Normalize ``(rseed, rows)``: returns (round seed, (first, total),
    None) where the rows are consecutive clients of one round, else (None,
    (None, total), groups) with one (round seed, local rows, global ids)
    a distinct round seed (module docstring)."""
    if rows is None:
        return int(rseed), (0, C), None
    where, total = rows
    seeds = np.broadcast_to(np.asarray(rseed, dtype=np.uint64), (C,))
    if np.ndim(where) == 0:
        ids = np.arange(int(where), int(where) + C, dtype=np.int64)
    else:
        ids = np.asarray(where, np.int64)
        if ids.shape != (C,):
            raise ValueError(f"rows' ids must name {C} clients, got "
                             f"shape {ids.shape}")
    if (seeds == seeds[0]).all() and np.array_equal(
            ids, np.arange(ids[0], ids[0] + C)):
        return int(seeds[0]), (int(ids[0]), total), None
    groups = []
    for s in dict.fromkeys(seeds.tolist()):
        loc = np.flatnonzero(seeds == np.uint64(s))
        groups.append((int(s), loc, ids[loc]))
    return None, (None, total), groups


def _gather_groups(parts, groups, device):
    """Each group's rows of its own whole draw (``parts[g]``, a tree whose
    leaves lead with ``total``), in the local row order."""
    order = np.concatenate([loc for _, loc, _ in groups])
    inv = torch.as_tensor(np.argsort(order), device=device)
    ids = [torch.as_tensor(gids, device=device) for _, _, gids in groups]
    return tree_map(lambda *leaves: torch.cat(
        [leaf[i] for leaf, i in zip(leaves, ids)])[inv], *parts)


def make_local_train_fn(model, cfg: FederatedTrainingConfig,
                        samples_per_client: int, mean: torch.Tensor,
                        std: torch.Tensor, grad_mask=None,
                        dp_sgd_fn: Optional[Callable] = None,
                        augment_fn: Optional[Callable] = None) -> Callable:
    """Build ``local_train(params, images_u8, labels, n_valid, rseed,
    epochs=None, correction=None, lr=None, extra=None, rows=None) ->
    (new_params, metrics)``, or ``(new_params, metrics, new_extra)`` when
    ``extra`` is given.

    ``params`` is a tree of (C, ...) f32 tensors (not modified),
    ``images_u8`` (C, N, H, W, ch), ``labels`` (C, N) int64, ``n_valid``
    (C,) true shard sizes and ``rseed`` the round's seed
    (``prng.round_seed``). ``epochs`` is an optional (C,) integer budget,
    each at most ``local_epochs`` (none: every client runs all of them);
    ``correction`` an optional tree like ``params`` added to every step's
    gradient (SCAFFOLD's c − c_i); ``lr`` an optional (C,) learning rate
    in place of ``learning_rate``. ``grad_mask`` is a tree of unstacked
    leaf masks multiplied into every gradient last. ``dp_sgd_fn(params,
    xb, yb, wmask, dropout_seed, noise_seed)`` replaces every step's
    gradient (module docstring). ``extra`` is a dict of the model's
    other collections, ``{"batch_stats": tree of (C, ...) tensors}``, which
    the training forward updates (not modified). ``augment_fn(xb,
    generator)`` augments each normalized batch. ``rows=(first, total)``:
    these C clients are global clients first, … of ``total`` (module
    docstring); ``augment_fn`` then takes ``rows=`` too, and
    ``dp_sgd_fn`` gets it as a keyword. ``rows=(ids, total)`` with a
    (C,) sequence of global ids, and ``rseed`` a (C,) sequence of round
    seeds: each row draws its own round's streams (module docstring).
    ``metrics`` holds (C,)
    tensors ``loss`` and ``accuracy`` of each client's last active epoch,
    ``epochs_completed`` and ``samples_processed``.
    """
    batch = cfg.batch_size
    steps_per_epoch = max(1, samples_per_client // batch)
    max_epochs = cfg.local_epochs
    optimizer = LocalOptimizer(cfg)
    if cfg.param_storage_dtype not in (None, "bfloat16"):
        raise ValueError(
            f"param_storage_dtype must be None or 'bfloat16', got "
            f"{cfg.param_storage_dtype!r}")
    store_bf16 = cfg.param_storage_dtype == "bfloat16"
    mu = float(cfg.proximal_mu)

    def local_train(params, images_u8, labels, n_valid, rseed, epochs=None,
                    correction=None, lr=None, extra=None, rows=None):
        device = images_u8.device
        C, N = images_u8.shape[:2]
        rseed, (first, total), groups = _stream_groups(rseed, rows, C)
        if groups is not None and (dp_sgd_fn is not None
                                   or augment_fn is not None):
            raise ValueError("rows from several rounds (rows=(ids, total)) "
                             "do not take DP-SGD or augmentation: their "
                             "draws are one round's")
        sharded = total != C and groups is None
        shard_kw = {"rows": (first, total)} if sharded else {}
        if extra is not None and set(extra) != {"batch_stats"}:
            raise ValueError("extra holds the batch_stats collection, got "
                             f"{sorted(extra)}")
        stats = None if extra is None else extra["batch_stats"]
        paths = tree_paths(params)
        anchor = [tree_get(params, p) for p in paths]  # FedProx's w_global
        if store_bf16:
            # the reference's round-to-nearest cast of the start: the
            # returned delta includes it
            store = [a.to(torch.bfloat16).contiguous() for a in anchor]
            if groups is not None:
                seeds = np.empty(C, np.uint64)
                ids = np.empty(C, np.int64)
                for s, loc, gids in groups:
                    seeds[loc], ids[loc] = s, gids
                sr_seed0 = _row_rounding_seeds(seeds, ids, device)
            else:
                sr_seed0 = (rounding_seeds(rseed, C, device, first=first)
                            if sharded else rounding_seeds(rseed, C, device))
        else:
            store = [a.detach().clone(memory_format=torch.contiguous_format)
                     .requires_grad_(True) for a in anchor]
        opt = optimizer.init(store)
        corr = (None if correction is None
                else [tree_get(correction, p) for p in paths])
        masks = (None if grad_mask is None
                 else [tree_get(grad_mask, p) for p in paths])
        if epochs is not None:
            epochs = torch.as_tensor(epochs).to(device=device,
                                                dtype=torch.int64)
        n = n_valid.clamp(min=1).long()[:, None]
        row_idx = torch.arange(C, device=device)[:, None]
        if groups is None:
            shuffle_seed = prng.stream_seed(rseed, prng.Stream.SHUFFLE)
            dropout_seed = prng.stream_seed(rseed, prng.Stream.DROPOUT)
            noise_seed = prng.stream_seed(rseed, prng.Stream.DP_NOISE)
            augment_seed = prng.stream_seed(rseed, prng.Stream.AUGMENT)
        else:
            shuffle_seeds = [prng.stream_seed(s, prng.Stream.SHUFFLE)
                             for s, _, _ in groups]
            dropout_seeds = [prng.stream_seed(s, prng.Stream.DROPOUT)
                             for s, _, _ in groups]
            has_dropout = getattr(model, "dropout_keep", None) is not None

        def per_leaf(v):
            """A (C,) vector shaped to broadcast over each leaf."""
            return [v.reshape((C,) + (1,) * (s.dim() - 1)) for s in store]

        # −lr for each leaf: the scalar, or the (C,) rates shaped per leaf
        neg_lr = ([-cfg.learning_rate] * len(store) if lr is None
                  else per_leaf(-torch.as_tensor(lr, dtype=torch.float32,
                                                 device=device)))
        ep_losses, ep_accs = [], []
        for epoch in range(max_epochs):
            if groups is None:
                g = prng.generator(prng.fold(shuffle_seed, epoch), device)
                draw = torch.rand((total, N), generator=g,
                                  device=device)[first:first + C]
            else:
                draw = _gather_groups([torch.rand(
                    (total, N), device=device, generator=prng.generator(
                        prng.fold(s, epoch), device))
                    for s in shuffle_seeds], groups, device)
            perm_raw = torch.argsort(draw, dim=1)
            del draw
            # remap padded slots into the valid region (keeps batches dense)
            perm = torch.where(perm_raw < n, perm_raw, perm_raw % n)
            active = None if epochs is None else per_leaf(epoch < epochs)
            stats_active = (None if epochs is None or stats is None else
                            (epoch < epochs).reshape(C, 1))
            ep_loss = torch.zeros(C, device=device)
            ep_acc = torch.zeros(C, device=device)
            for step in range(steps_per_epoch):
                ctr = epoch * steps_per_epoch + step
                idx = perm[:, step * batch:(step + 1) * batch]
                xb = (images_u8[row_idx, idx].float() / 255.0 - mean) / std
                yb = labels[row_idx, idx]
                if augment_fn is not None:
                    xb = augment_fn(xb, prng.generator(
                        prng.fold(augment_seed, ctr), device), **shard_kw)
                drop_kw = {}
                if groups is not None:
                    dgen = None
                    keeps = ([model.dropout_keep(total, batch,
                                                 prng.generator(prng.fold(
                                                     s, ctr), device),
                                                 device)
                              for s in dropout_seeds] if has_dropout
                             else [None])
                    if keeps[0] is not None:
                        drop_kw = {"dropout_mask": _gather_groups(
                            keeps, groups, device)}
                    del keeps
                else:
                    dgen = prng.generator(prng.fold(dropout_seed, ctr),
                                          device)
                if sharded and getattr(model, "dropout_keep", None):
                    # the whole (total, B, ...) draw, this shard's rows
                    keep = model.dropout_keep(total, batch, dgen, device)
                    if keep is not None:
                        drop_kw = {"dropout_mask": tree_map(
                            lambda k: k[first:first + C], keep)}
                p32 = ([s.float().requires_grad_(True) for s in store]
                       if store_bf16 else store)
                tree = tree_from_leaves(paths, p32)

                def forward():
                    """The training forward: logits, and the updated
                    statistics (None without them)."""
                    if stats is None:
                        return model(tree, xb, train=True,
                                     generator=dgen, **drop_kw), None
                    return model(tree, xb, train=True, generator=dgen,
                                 batch_stats=stats, **drop_kw)

                if dp_sgd_fn is None:
                    logits, new_stats = forward()
                    loss = cross_entropy_loss(logits, yb)
                    grads = list(torch.autograd.grad(loss.sum(), p32))
                else:
                    with torch.no_grad():
                        logits, new_stats = forward()
                        loss = cross_entropy_loss(logits, yb)
                    raw = perm_raw[:, step * batch:(step + 1) * batch]
                    g_tree = dp_sgd_fn(
                        tree, xb, yb, (raw < n).float(),
                        prng.fold(dropout_seed, ctr),
                        prng.fold(noise_seed, ctr), **shard_kw)
                    grads = [tree_get(g_tree, p) for p in paths]
                    del g_tree
                if new_stats is not None:
                    stats = new_stats if stats_active is None else tree_map(
                        lambda new, old: torch.where(stats_active, new, old),
                        new_stats, stats)
                if store_bf16:
                    step_seed = sr_seed0 + ((ctr * rounding.STEP_STRIDE)
                                            & 0xFFFFFFFF)
                optimizer.begin_step(opt)
                with torch.no_grad():
                    for i, p in enumerate(p32):
                        gr, grads[i] = grads[i], None
                        if corr is not None:
                            gr = gr + corr[i].to(gr.dtype)
                        if mu > 0.0:
                            gr = gr + mu * (p - anchor[i])
                        if masks is not None:
                            gr = gr * masks[i].to(gr.dtype)
                        a = None if active is None else active[i]
                        u = optimizer.leaf_update(opt, i, gr, p, a)
                        u = u * neg_lr[i]
                        del gr
                        if store_bf16:
                            _commit(store[i], rounding.stochastic_round_bf16(
                                p + u, rounding.leaf_seed(step_seed, i)), a)
                        elif a is None:
                            p.add_(u)
                        else:
                            p.copy_(torch.where(a, p + u, p))
                        del u
                ep_loss += loss.detach()
                ep_acc += (logits.detach().argmax(-1) == yb).float().mean(1)
            ep_losses.append(ep_loss / steps_per_epoch)
            ep_accs.append(ep_acc / steps_per_epoch)
        new_params = tree_from_leaves(
            paths, [t.detach().float() for t in store])
        if epochs is None:
            done = torch.full((C,), max_epochs, dtype=torch.int64,
                              device=device)
            loss_c, acc_c = ep_losses[-1], ep_accs[-1]
        else:
            done = epochs
            last = (epochs - 1).clamp(0, max_epochs - 1)
            cols = torch.arange(C, device=device)
            loss_c = torch.stack(ep_losses)[last, cols]
            acc_c = torch.stack(ep_accs)[last, cols]
        metrics = {
            "loss": loss_c, "accuracy": acc_c,
            "epochs_completed": done.to(torch.int32),
            "samples_processed": (done * steps_per_epoch * batch).to(
                torch.int32)}
        if extra is None:
            return new_params, metrics
        return new_params, metrics, {"batch_stats": stats}

    # the engine's SCAFFOLD and FedNova step counts use the trainer's own
    local_train.steps_per_epoch = steps_per_epoch
    return local_train


def model_kwargs(batch_stats) -> Dict[str, Any]:
    """The forward's keywords for a model's non-param collections: its
    ``batch_stats`` where it has them (eval mode normalizes with them)."""
    return {} if batch_stats is None else {"batch_stats": batch_stats}


@torch.no_grad()
def evaluate_test_set(model, params, images: torch.Tensor,
                      labels: torch.Tensor, batch_size: int = 512,
                      batch_stats=None, per_class: bool = False
                      ) -> Dict[str, Any]:
    """Loss and accuracy of one (unstacked) model on normalized images,
    averaged over full batches as ``fl_tpu``'s ``make_eval_fn`` does; a
    BatchNorm model normalizes with its running ``batch_stats``. With
    ``per_class``, also ``per_class_accuracy``: each class's correct count
    over its count in those batches (0 where a class is absent)."""
    n = images.shape[0]
    bs = min(batch_size, n)
    stacked = tree_map(lambda v: v[None], params)
    kw = model_kwargs(None if batch_stats is None
                      else tree_map(lambda v: v[None], batch_stats))
    losses, accs, correct_by, total_by = [], [], 0.0, 0.0
    for i in range(max(1, n // bs)):
        xb = images[None, i * bs:(i + 1) * bs]
        yb = labels[None, i * bs:(i + 1) * bs]
        logits = model(stacked, xb, **kw)
        losses.append(cross_entropy_loss(logits, yb))
        hit = (logits.argmax(-1) == yb).float()
        accs.append(hit.mean(1))
        if per_class:
            onehot = F.one_hot(yb[0], logits.shape[-1]).float()
            correct_by = correct_by + (hit[0, :, None] * onehot).sum(0)
            total_by = total_by + onehot.sum(0)
    out = {"loss": float(torch.cat(losses).mean()),
           "accuracy": float(torch.cat(accs).mean())}
    if per_class:
        out["per_class_accuracy"] = (
            correct_by / torch.clamp(total_by, min=1.0)).tolist()
    return out


def train_variables(local_train: Callable, variables, images_u8, labels,
                    n_valid, rseed, **kw):
    """``local_train`` over a stacked variables tree: the params trained,
    a BatchNorm model's ``batch_stats`` carried through ``extra=``.
    Returns (new variables, metrics)."""
    if "batch_stats" not in variables:
        params, metrics = local_train(variables["params"], images_u8, labels,
                                      n_valid, rseed, **kw)
        return {"params": params}, metrics
    params, metrics, extra = local_train(
        variables["params"], images_u8, labels, n_valid, rseed,
        extra={"batch_stats": variables["batch_stats"]}, **kw)
    return {"params": params, **extra}, metrics


def evaluate_u8_test_set(model, variables, images_u8, labels, mean, std,
                         device, per_class: bool = False) -> Dict[str, Any]:
    """:func:`evaluate_test_set` of one model's variables on a uint8 test
    set, normalized on the host with the data's ``mean`` / ``std`` (the
    reference's ``evaluate_test_set`` of the clustered and async
    engines)."""
    mean = np.asarray(torch.as_tensor(mean).cpu(), np.float32)
    std = np.asarray(torch.as_tensor(std).cpu(), np.float32)
    x = (np.asarray(images_u8, np.float32) / 255.0 - mean) / std
    return evaluate_test_set(
        model, variables["params"],
        torch.as_tensor(x, dtype=torch.float32).to(device),
        torch.as_tensor(np.asarray(labels, np.int64)).to(device),
        batch_stats=variables.get("batch_stats"), per_class=per_class)
