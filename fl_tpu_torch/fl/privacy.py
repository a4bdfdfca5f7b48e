"""Differential privacy of the delta-clipping and client-level modes, and
the host ledgers.

``dp_noise_client_deltas`` is the port of ``fl_tpu.fl.privacy.
dp_noise_client_deltas`` (the per-leaf-group epilogue): one L2 norm per
client over all leaves; scale = min(1, C/‖Δ‖), sens = min(‖Δ‖, C),
σ = sens·√(2 ln(1.25/δ))/ε; then every element gets Δ·scale + σ·z through
the clip+noise kernel (``fl_tpu_torch.ops.dp.clip_noise``, K3 on CUDA).

The tree is the whole variables tree the engine releases (CIFAR10CNN's
``batch_stats`` with its ``params``, as the reference noises them). Leaf
groups: a leaf with at least ``STANDALONE_MIN`` elements per client runs
the kernel on its own (C, D) view, with no copy (SimpleCNN's fc1 kernel,
95% of the bytes; CIFAR10CNN's conv5, conv6, fc1 and fc2 kernels); the
small leaves are concatenated into one more group. Every (round, client,
group) has its own seed, so no noise stream is reused.

Client-level DP-FedAvg (``dp_mode="client_dp"``) is the port of
``fl_tpu.fl.privacy``'s central-noise functions (``privacy.py:259-347``),
plain PyTorch as the reference's are XLA: :func:`clip_client_deltas`,
:func:`clipped_masked_mean` (the engine's clip and fixed-denominator masked
sum in one pass, with each client's clip scale folded into its weight so
that no clipped copy of the (C, D) deltas is made),
:func:`central_noise_tree`, and adaptive clipping's
:func:`adaptive_clip_delta_multiplier`, :func:`noisy_clipped_fraction` and
:func:`geometric_clip_update` (Andrew et al. 2021). Their draws come from
``torch.Generator``s seeded by derived seeds (``core.prng``) where the
reference takes keys.

Example-level DP-SGD (``dp_mode="dp_sgd"``) is the port of
``make_dp_sgd_grad_fn``, ``make_ghost_dp_sgd_grad_fn`` and
``model_supports_ghost_dp`` (``privacy.py:350-610``): each example's
gradient clipped to C, padded slots masked to zero, the sum over the FIXED
batch B, N(0, (z·C/B)²) added. The microbatch form gets per-example
gradients without ``vmap`` (the fused conv segment is an
``autograd.Function`` with no vmap rule): a (C, m) chunk of examples is
folded into the client axis as a (C·m, 1) batch, each example with its own
copy of its client's parameters, so the model's stacked forward and
backward (K1/K2 on ``fused_conv_block="residual"``) return per-example
weight gradients directly. The ghost form takes two batched backwards on
the unfused formulation and never forms a per-example gradient; its
kinds are the dense and 3x3 conv layers and GroupNorm (CIFAR10CNN's
``norm="group"``), whose per-example scale and bias gradients are spatial
sums of dy·x̂ and dy, x̂ recomputed from the captured input.

:class:`PrivacyBudgetTracker` and :class:`PrivacyAccountant` are host-side
copies of the reference's ledgers. The host API (``privacy.py:51-137`` and
``:701-917`` of the reference) follows them: the Gaussian mechanism's math,
the one-client release :func:`clip_and_noise_tree` (the tree flattened to
one (1, D) row through ``ops.dp.clip_noise_matrix``, so K3 carries it on a
card; σ from the CLIPPED norm) and :func:`clip_and_noise_tree_at_sigma`
(an explicit σ; returns the PRE-clip norm), and the reference's facades
:class:`GradientClipper`, :class:`GaussianNoiseGenerator` (seeded draws
k = 1, 2, … from fold(seed, k); its tree noise goes through the kernel at
scale 1) and :class:`DifferentialPrivacyEngine`.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fl_tpu_torch.core import prng
from fl_tpu_torch.core.mesh import resolve_device
from fl_tpu_torch.core.pytree import (
    clip_by_global_norm, global_norm, tree_from_leaves, tree_get,
    tree_leaves, tree_map, tree_paths)
from fl_tpu_torch.core.types import PrivacyConfig
from fl_tpu_torch.core.transfer import to_device
from fl_tpu_torch.fl.local_training import per_example_losses
from fl_tpu_torch.ops import dp as dp_ops

STANDALONE_MIN = 1 << 16

logger = logging.getLogger(__name__)


class PrivacyError(Exception):
    """ref: PrivacyError, src/shared/privacy.py:20-22."""


def leaf_groups(tree) -> List[List[tuple]]:
    """Paths grouped for the clip+noise kernel: each large leaf alone (in
    tree order), then all small leaves together."""
    paths = tree_paths(tree)
    big = [[p] for p in paths
           if tree_get(tree, p)[0].numel() >= STANDALONE_MIN]
    small = [p for p in paths if [p] not in big]
    return big + ([small] if small else [])


def client_norms(tree) -> torch.Tensor:
    """(C,) global L2 norm of each client's stacked leaves."""
    sq = [t.reshape(t.shape[0], -1).float().square().sum(1)
          for t in tree_leaves(tree)]
    return torch.stack(sq).sum(0).sqrt()


def dp_noise_client_deltas(stacked_deltas, rseed: int, epsilon: float,
                           delta: float, max_norm: float, first: int = 0,
                           use_kernel: Optional[bool] = None
                           ) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """Reference-mode DP over stacked client deltas (leading axis C).
    ``rseed`` is the round's seed; client c's group g noise is keyed by
    fold(fold(fold(rseed, c), DP_NOISE), g), c the GLOBAL client id (the
    rows are clients first, …, first + C − 1). ``use_kernel``: None takes
    K3 on a CUDA tensor and the plain version on a CPU one, True K3 (a CPU
    tensor raises), False the plain version (the reference's
    ``use_pallas_dp``). Returns (noisy tree, sensitivity (C,), sigma
    (C,))."""
    clip_noise = dp_ops.clip_noise_route(use_kernel)
    scale, sens = dp_ops.clip_factors(client_norms(stacked_deltas), max_norm)
    sigma = sens * dp_ops.gaussian_factor(epsilon, delta)

    paths, noisy = [], []
    for gi, group in enumerate(leaf_groups(stacked_deltas)):
        leaves = [tree_get(stacked_deltas, p) for p in group]
        C = leaves[0].shape[0]
        flats = [t.reshape(C, -1).float() for t in leaves]
        x = flats[0] if len(flats) == 1 else torch.cat(flats, 1)
        seeds = to_device(prng.as_int64(prng.client_stream_seeds(
            rseed, C, prng.Stream.DP_NOISE, gi, first)), x.device)
        out = clip_noise(x.contiguous(), scale, sigma, seeds)
        parts = torch.split(out, [f.shape[1] for f in flats], 1)
        for p, t, part in zip(group, leaves, parts):
            paths.append(p)
            noisy.append(part.reshape(t.shape).to(t.dtype))
    return tree_from_leaves(paths, noisy), sens, sigma


def clip_client_deltas(stacked_deltas, max_norm: float
                       ) -> Tuple[Any, torch.Tensor]:
    """Clip each client's delta to global L2 norm ≤ C (no per-client
    noise). Returns (clipped stacked deltas, per-client pre-clip norms)."""
    clipped = torch.func.vmap(
        lambda tree: clip_by_global_norm(tree, max_norm)[0])(stacked_deltas)
    return clipped, client_norms(stacked_deltas)


def clipped_masked_mean(stacked_deltas, max_norm, mask: torch.Tensor,
                        expected_count: float) -> Tuple[Any, torch.Tensor]:
    """Σₖ maskₖ·clip_C(Δₖ) / m̄ leaf by leaf, in f32, and the (C,) pre-clip
    norms: :func:`clip_client_deltas` followed by the client_dp masked sum
    over the FIXED expected participant count m̄, with client k's clip scale
    min(1, C / max(‖Δₖ‖, 1e-12)) folded into its weight. ``max_norm`` may
    be a 0-d tensor (the adaptive clip norm)."""
    norms = client_norms(stacked_deltas)
    scale = dp_ops.clip_factors(norms, max_norm)[0]
    w = mask.float() * scale / expected_count
    mean = tree_map(lambda d: torch.tensordot(w, d.float(), dims=1),
                    stacked_deltas)
    return mean, norms


def central_noise_tree(tree, seed: int, sigma) -> Any:
    """Add N(0, σ²) to every element of an unstacked tree — the aggregator's
    noise of client-level DP-FedAvg (McMahan et al. 2018: the fixed-m̄ mean
    of C-clipped updates has sensitivity C/m̄, so σ = z·C/m̄). Leaf i of
    ``tree_paths`` order draws from its own sub-stream fold(seed, i)."""
    out = []
    for i, leaf in enumerate(tree_leaves(tree)):
        g = prng.generator(prng.fold(seed, i), leaf.device)
        noise = torch.randn(leaf.shape, generator=g, device=leaf.device,
                            dtype=torch.float32)
        out.append(leaf + (sigma * noise).to(leaf.dtype))
    return tree_from_leaves(tree_paths(tree), out)


def adaptive_clip_delta_multiplier(noise_multiplier: float,
                                   count_stddev: float) -> float:
    """Noise multiplier z_Δ of the clipped-delta aggregate such that the
    joint release (aggregate at z_Δ·C, centered clipped count at σ_b) is one
    Gaussian mechanism at ``noise_multiplier`` z: z⁻² = z_Δ⁻² + (2σ_b)⁻²
    (Andrew et al. 2021, Theorem 1), so the accountant is unchanged."""
    if count_stddev <= 0:
        raise PrivacyError("count_stddev must be positive")
    inv = noise_multiplier ** -2 - (2.0 * count_stddev) ** -2
    if inv <= 0:
        raise PrivacyError(
            f"adaptive clipping infeasible: need 2·count_stddev > "
            f"noise_multiplier (got σ_b={count_stddev}, z={noise_multiplier})"
            " — raise clip_count_stddev or lower the noise multiplier"
        )
    return float(inv ** -0.5)


def noisy_clipped_fraction(centered_sum: torch.Tensor, expected_count,
                           count_stddev: float, seed: int) -> torch.Tensor:
    """DP estimate of the fraction of participants whose pre-clip norm was
    ≤ C, from the reduced centered sum Σᵢ mᵢ·(bᵢ − ½) plus N(0, σ_b²) drawn
    from ``seed``, over the fixed expected count m̄."""
    g = prng.generator(seed, centered_sum.device)
    noise = torch.randn((), generator=g, device=centered_sum.device)
    return (centered_sum + count_stddev * noise) / expected_count + 0.5


def geometric_clip_update(clip_norm, noisy_fraction: torch.Tensor,
                          target_quantile: float, learning_rate: float
                          ) -> torch.Tensor:
    """C ← C·exp(−η_C·(b̃ − γ)) (Andrew et al. 2021, Alg. 1): the fixed
    point is the γ-quantile of the client delta norms."""
    return clip_norm * torch.exp(
        -learning_rate * (noisy_fraction - target_quantile))


# ---------------------------------------------------------------------------
# per-example DP-SGD
# ---------------------------------------------------------------------------

_SQ_COLUMNS = 1 << 15  # column block of the f32 passes over bf16 gradients


def _rows_sq(g: torch.Tensor) -> torch.Tensor:
    """Σ g² over every dim but the first, in f32, a column block at a time
    (no f32 copy of a whole bf16 gradient)."""
    g = g.reshape(g.shape[0], -1)
    return sum(g[:, i:i + _SQ_COLUMNS].float().square().sum(1)
               for i in range(0, g.shape[1], _SQ_COLUMNS))


def _weighted_rows(w: torch.Tensor, g: torch.Tensor, m: int
                   ) -> torch.Tensor:
    """(C·m, ...) per-example rows g and (C·m,) f32 weights w → Σ over each
    client's m rows of w·g, (C, ...) in f32, a column block at a time."""
    shape = g.shape[1:]
    C = g.shape[0] // m
    g = g.reshape(C, m, -1)
    w = w.reshape(C, 1, m)
    out = torch.empty((C, g.shape[2]), dtype=torch.float32, device=g.device)
    for i in range(0, g.shape[2], _SQ_COLUMNS):
        out[:, i:i + _SQ_COLUMNS] = torch.bmm(
            w, g[:, :, i:i + _SQ_COLUMNS].float())[:, 0]
    return out.reshape((C,) + tuple(shape))


def _noisy_mean(total, batch: int, sigma: float, noise_seed: int,
                first: int = 0):
    """total / B + N(0, σ²) leaf by leaf: the one noise rule of both DP-SGD
    forms. Client c's row of leaf i (``tree_paths`` order) draws from the
    seed fold(fold(noise_seed, i), c), c the GLOBAL client id (the rows
    are clients first, …), through the clip+noise kernel at scale 1/B (K3
    on a CUDA tensor), so no rank draws another rank's rows."""
    out = []
    for i, t in enumerate(tree_leaves(total)):
        C = t.shape[0]
        x = t.reshape(C, -1).float().contiguous()
        seeds = to_device(prng.as_int64(prng.client_seeds_of(
            prng.fold(noise_seed, i), C, first)), x.device)
        scale = torch.full((C,), 1.0 / batch, dtype=torch.float32,
                           device=x.device)
        out.append(dp_ops.clip_noise(x, scale, torch.full_like(scale, sigma),
                                     seeds).reshape(t.shape))
    return tree_from_leaves(tree_paths(total), out)


def _clip_scale(sq: torch.Tensor, max_grad_norm: float,
                wmask: torch.Tensor) -> torch.Tensor:
    norms = torch.sqrt(sq)
    scale = torch.clamp(max_grad_norm / torch.clamp(norms, min=1e-12),
                        max=1.0)
    return scale * wmask.float()


def make_dp_sgd_grad_fn(model, max_grad_norm: float,
                        noise_multiplier: float,
                        microbatch_size: int = 16) -> Callable:
    """Per-example-clipped, noised gradients of the mean cross-entropy over
    stacked clients (the reference's ``make_dp_sgd_grad_fn`` with its
    loss_fn the model's training loss). Returns

        dp_grad(params, xb, yb, wmask, dropout_seed, noise_seed,
                rows=None) -> grads

    with ``params`` a tree of (C, ...) tensors, ``xb`` (C, B, ...)
    normalized images, ``yb`` (C, B) labels and ``wmask`` (C, B) weights
    (0 on padded shard slots); ``grads`` is a tree of (C, ...) f32
    gradients, Σ_i min(1, C/‖g_i‖)·wmask_i·g_i / B + N(0, (z·C/B)²).

    The batch goes in chunks of m = min(microbatch_size, B) examples. A
    chunk is folded into the client axis: client c's examples become m
    clients of one example each, every one with its own copy of client c's
    parameters (made contiguous: the fused kernels need it), so one
    forward and one backward over the (C·m, 1) batch give each example's
    gradient of every leaf. The leaves of the model's "dense"
    ``DP_LAYERS`` are folded in the compute dtype (the gradient through
    their cast is the compute-dtype gradient upcast, so nothing changes
    but the memory); the others in f32, so that a fused segment returns
    their gradients unrounded as it does for a whole batch. Peak memory is about
    C·m·|params| gradient values plus as many parameter copies. Dropout:
    one single-example mask a client per step (``dropout_seed``), shared by
    all its examples, as the reference applies one key to every example.
    ``rows=(first, total)``: the C clients are global clients first, … of
    ``total`` (a shard of the client axis); the dropout draw is made for
    all ``total`` and sliced, and the noise keyed by global id.
    """
    cdt = getattr(model, "dtype", torch.float32)
    dense = {entry[0] for entry in getattr(model, "DP_LAYERS", None) or ()
             if entry[1] == "dense"}

    def dp_grad(params, xb, yb, wmask, dropout_seed, noise_seed, rows=None):
        C, B = yb.shape
        first, total_c = (0, C) if rows is None else rows
        m = min(microbatch_size, B)
        if B % m:
            raise ValueError(f"batch {B} must be divisible by microbatch "
                             f"{m}")
        paths = tree_paths(params)
        device = xb.device
        keep = None
        if hasattr(model, "dropout_keep"):
            keep = model.dropout_keep(
                total_c, 1, prng.generator(dropout_seed, device), device)
        if keep is not None:
            keep = tree_map(lambda t: t[first:first + C].repeat_interleave(
                m, 0), keep)

        def fold(p, layer):
            dt = cdt if layer in dense else torch.float32
            return (p.detach().to(dt).repeat_interleave(m, 0)
                    .requires_grad_(True))

        total = [torch.zeros(tree_get(params, p).shape, dtype=torch.float32,
                             device=device) for p in paths]
        for j in range(B // m):
            sl = slice(j * m, (j + 1) * m)
            folded = tree_from_leaves(
                paths, [fold(tree_get(params, p), p[0]) for p in paths])
            xc = xb[:, sl].reshape((C * m, 1) + tuple(xb.shape[2:]))
            yc = yb[:, sl].reshape(C * m, 1)
            logits = model(folded, xc, train=True, dropout_mask=keep)
            loss = per_example_losses(logits, yc).sum()
            leaves = [tree_get(folded, p) for p in paths]
            grads = torch.autograd.grad(loss, leaves)
            del logits, loss, folded, leaves
            sq = sum(_rows_sq(g) for g in grads)
            scale = _clip_scale(sq, max_grad_norm,
                                wmask[:, sl].reshape(C * m))
            for t, g in zip(total, grads):
                t += _weighted_rows(scale, g, m)
            del grads
        return _noisy_mean(tree_from_leaves(paths, total), B,
                           noise_multiplier * max_grad_norm / B, noise_seed,
                           first)

    return dp_grad


def _conv_sq(a: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """(n, H, W, I), (n, H, W, O) f32 → (n,) per-example squared norm of a
    SAME 3x3 conv's kernel and bias gradient: the bias's ‖Σ_s dy‖², then
    tap by tap the (n, I, O) kernel gradient of the tap as one batched
    product over the shifted input (the reference's nine-tap form)."""
    n, H, W, I = a.shape
    O = dy.shape[-1]
    ap = F.pad(a, (0, 0, 1, 1, 1, 1))
    dyf = dy.reshape(n, H * W, O)
    s = dy.sum((1, 2)).square().sum(-1)
    for ky in range(3):
        for kx in range(3):
            xt = ap[:, ky:ky + H, kx:kx + W, :].reshape(n, H * W, I)
            g = torch.bmm(xt.transpose(1, 2), dyf)
            s = s + g.square().sum((1, 2))
    return s


def _groupnorm_sq(a: torch.Tensor, dy: torch.Tensor, groups: int,
                  eps: float) -> torch.Tensor:
    """(n, H, W, ch), (n, H, W, ch) f32 → (n,) per-example squared norm
    of a GroupNorm's scale and bias gradient: x̂ recomputed from the
    layer's input ``a`` with its group statistics (not by inverting the
    affine output, which divides by the learned scale), then ‖Σ_s dy·x̂‖²
    + ‖Σ_s dy‖² over the spatial sites s."""
    n, H, W, ch = a.shape
    g = a.reshape(n, H, W, groups, ch // groups)
    mu = g.mean((1, 2, 4), keepdim=True)
    var = (g - mu).square().mean((1, 2, 4), keepdim=True)
    x_hat = ((g - mu) / torch.sqrt(var + eps)).reshape(a.shape)
    g_scale = (dy * x_hat).sum((1, 2))
    g_bias = dy.sum((1, 2))
    return g_scale.square().sum(1) + g_bias.square().sum(1)


def make_ghost_dp_sgd_grad_fn(model, max_grad_norm: float,
                              noise_multiplier: float,
                              norm_chunk: Optional[int] = None) -> Callable:
    """Ghost-norm (two-pass) DP-SGD: the mechanism of
    :func:`make_dp_sgd_grad_fn` without per-example gradients (Goodfellow
    2015; Li et al. 2021), the same ``dp_grad`` signature.

    - pass 1: the tapped forward (``dp_capture``: each layer's input;
      ``dp_perturb``: zeros at each pre-activation) and one backward with
      respect to the perturbations, whose gradient is every example's
      layer-output gradient dy_i (examples are independent in a summed
      loss);
    - per-example norms in f32: a dense layer's kernel ‖x_i‖²·‖dy_i‖² and
      bias ‖dy_i‖²; a 3x3 conv's nine-tap form (``_conv_sq``; with
      ``norm_chunk`` dividing B, over chunks of that many examples); a
      GroupNorm's ``_groupnorm_sq`` (its DP_LAYERS entry carries ``groups``
      and ``eps``);
    - pass 2: the backward of Σ_i s_i·loss_i, s_i = min(1, C/‖g_i‖)·mask_i,
      is the clipped masked sum.

    The noise is :func:`make_dp_sgd_grad_fn`'s, leaf for leaf, so both
    forms give the same noisy gradient for the same seeds. Dropout: one
    batch mask from ``dropout_seed``, the same in both passes. Needs a
    model declaring ``DP_LAYERS`` and the taps (SimpleCNN on the unfused
    formulation, a fused one raises; CIFAR10CNN with ``norm="group"``)."""
    layers = [(e[0], e[1], e[2] if len(e) > 2 else {})
              for e in model.DP_LAYERS]

    def dp_grad(params, xb, yb, wmask, dropout_seed, noise_seed, rows=None):
        C, B = yb.shape
        first, total_c = (0, C) if rows is None else rows
        device = xb.device
        keep = model.dropout_keep(total_c, B,
                                  prng.generator(dropout_seed, device),
                                  device)
        if keep is not None and total_c != C:
            keep = tree_map(lambda t: t[first:first + C], keep)
        p = tree_map(lambda v: v.detach(), params)
        shapes = model.dp_preactivation_shapes(C, B)
        zeros = {name: torch.zeros(shapes[name], dtype=torch.float32,
                                   device=device, requires_grad=True)
                 for name, _, _ in layers}
        logits, caps = model(p, xb, train=True, dropout_mask=keep,
                             dp_perturb=zeros, dp_capture=True)
        dys = dict(zip(zeros, torch.autograd.grad(
            per_example_losses(logits, yb).sum(), list(zeros.values()))))
        del logits, zeros
        sq = torch.zeros((C * B,), dtype=torch.float32, device=device)
        for name, kind, meta in layers:
            a = caps[name].float().reshape((C * B,) + caps[name].shape[2:])
            dy = dys[name].float().reshape((C * B,) + dys[name].shape[2:])
            if kind == "dense":
                dy_sq = dy.square().sum(1)
                sq += a.square().sum(1) * dy_sq + dy_sq
            elif kind == "conv3x3":
                n = (C * norm_chunk if norm_chunk and B % norm_chunk == 0
                     else C * B)
                sq += torch.cat([_conv_sq(a[i:i + n], dy[i:i + n])
                                 for i in range(0, C * B, n)])
            elif kind == "groupnorm":
                sq += _groupnorm_sq(a, dy, int(meta["groups"]),
                                    float(meta.get("eps", 1e-6)))
            else:
                raise ValueError(f"unknown DP layer kind: {kind}")
        del caps, dys
        scale = _clip_scale(sq.reshape(C, B), max_grad_norm, wmask)

        p2 = tree_map(lambda v: v.detach().requires_grad_(True), params)
        logits = model(p2, xb, train=True, dropout_mask=keep)
        loss = (per_example_losses(logits, yb) * scale.detach()).sum()
        paths = tree_paths(p2)
        grads = torch.autograd.grad(loss, [tree_get(p2, p) for p in paths])
        total = tree_from_leaves(paths, [g.float() for g in grads])
        return _noisy_mean(total, B, noise_multiplier * max_grad_norm / B,
                           noise_seed, first)

    return dp_grad


def model_supports_ghost_dp(model) -> bool:
    """True when the model declares the ghost-norm instrumentation contract
    (``DP_LAYERS`` and the ``dp_capture`` / ``dp_perturb`` keywords)."""
    return bool(getattr(model, "DP_LAYERS", None))


class PrivacyBudgetTracker:
    """Additive (ε, δ) budget ledger
    (ref: PrivacyBudgetTracker, src/shared/privacy.py:25-92)."""

    def __init__(self, initial_epsilon: float, initial_delta: float):
        self.initial_epsilon = initial_epsilon
        self.initial_delta = initial_delta
        self.consumed_epsilon = 0.0
        self.consumed_delta = 0.0
        self.consumption_history: List[Dict[str, Any]] = []
        self.start_time = time.time()

    def consume_budget(self, epsilon: float, delta: float,
                       operation: str = "training") -> None:
        self.consumed_epsilon += epsilon
        self.consumed_delta += delta
        self.consumption_history.append({
            "timestamp": time.time(),
            "epsilon": epsilon,
            "delta": delta,
            "operation": operation,
            "total_epsilon": self.consumed_epsilon,
            "total_delta": self.consumed_delta,
        })

    def get_remaining_budget(self) -> Tuple[float, float]:
        return (
            max(0.0, self.initial_epsilon - self.consumed_epsilon),
            max(0.0, self.initial_delta - self.consumed_delta),
        )

    def is_budget_exhausted(self, required_epsilon: float = 0.0,
                            required_delta: float = 0.0) -> bool:
        # small relative tolerance so k rounds of budget/k sum cleanly
        # despite float accumulation
        rem_e, rem_d = self.get_remaining_budget()
        tol_e = 1e-9 * max(self.initial_epsilon, 1.0)
        tol_d = 1e-9 * max(self.initial_delta, 1e-12)
        return rem_e < required_epsilon - tol_e or rem_d < required_delta - tol_d

    def get_budget_status(self) -> Dict[str, Any]:
        rem_e, rem_d = self.get_remaining_budget()
        return {
            "initial_epsilon": self.initial_epsilon,
            "initial_delta": self.initial_delta,
            "consumed_epsilon": self.consumed_epsilon,
            "consumed_delta": self.consumed_delta,
            "remaining_epsilon": rem_e,
            "remaining_delta": rem_d,
            "epsilon_utilization": (
                self.consumed_epsilon / self.initial_epsilon
                if self.initial_epsilon else 0.0
            ),
            "delta_utilization": (
                self.consumed_delta / self.initial_delta
                if self.initial_delta else 0.0
            ),
            "operations_count": len(self.consumption_history),
            "tracking_duration": time.time() - self.start_time,
        }

    # state for checkpoint/resume (the checkpoint's meta.json holds it)
    def state_dict(self) -> Dict[str, Any]:
        return {
            "initial_epsilon": self.initial_epsilon,
            "initial_delta": self.initial_delta,
            "consumed_epsilon": self.consumed_epsilon,
            "consumed_delta": self.consumed_delta,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.initial_epsilon = state["initial_epsilon"]
        self.initial_delta = state["initial_delta"]
        self.consumed_epsilon = state["consumed_epsilon"]
        self.consumed_delta = state["consumed_delta"]


class PrivacyAccountant:
    """Mechanism ledger with additive composition
    (ref: PrivacyAccountant, privacy.py:419-484)."""

    def __init__(self):
        self.privacy_ledger: List[Dict[str, Any]] = []
        self.total_epsilon = 0.0
        self.total_delta = 0.0

    def add_mechanism(self, mechanism_type: str, epsilon: float, delta: float,
                      sensitivity: float, noise_scale: float,
                      metadata: Optional[Dict[str, Any]] = None) -> None:
        self.privacy_ledger.append({
            "timestamp": time.time(),
            "mechanism_type": mechanism_type,
            "epsilon": epsilon,
            "delta": delta,
            "sensitivity": sensitivity,
            "noise_scale": noise_scale,
            "metadata": metadata or {},
        })
        self.total_epsilon += epsilon
        self.total_delta += delta

    def get_total_privacy_cost(self) -> Tuple[float, float]:
        return self.total_epsilon, self.total_delta

    def get_privacy_ledger(self) -> List[Dict[str, Any]]:
        return list(self.privacy_ledger)


# ---------------------------------------------------------------------------
# The host API: the Gaussian mechanism's math, the one-client release and
# the reference's facades (ref: fl_tpu/fl/privacy.py:51-137, :701-917)
# ---------------------------------------------------------------------------

def gaussian_sigma(sensitivity, epsilon: float, delta: float):
    """Gaussian-mechanism noise scale σ = s·√(2·ln(1.25/δ))/ε
    (ref: src/shared/privacy.py:209). Works on floats and tensors."""
    return sensitivity * math.sqrt(2.0 * math.log(1.25 / delta)) / epsilon


def validate_privacy_parameters(epsilon: float, delta: float) -> bool:
    """ref: validate_privacy_parameters, privacy.py:335-356."""
    if epsilon <= 0:
        logger.error("Epsilon must be positive")
        return False
    if epsilon > 10.0:
        logger.warning("Epsilon %s is very high, privacy may be weak", epsilon)
    if delta <= 0 or delta >= 1:
        logger.error("Delta must be in (0, 1)")
        return False
    if delta > 1e-3:
        logger.warning("Delta %s is high, privacy may be weak", delta)
    return True


def advanced_composition_epsilon(epsilon: float, delta: float,
                                 steps: int) -> float:
    """Simplified advanced-composition estimate
    ε' = ε·√(2·k·ln(1/δ)) + k·ε·(e^ε − 1)
    (ref: calculate_privacy_budget, privacy.py:319-333)."""
    if steps <= 1:
        return epsilon
    eps = epsilon * math.sqrt(2.0 * steps * math.log(1.0 / delta))
    eps += steps * epsilon * (math.exp(epsilon) - 1.0)
    return eps


def _as_row(tree) -> Tuple[List[tuple], List[torch.Tensor], torch.Tensor]:
    """A tree's paths, leaves and its leaves flattened into one (1, D) f32
    row."""
    paths, leaves = tree_paths(tree), tree_leaves(tree)
    row = torch.cat([t.reshape(-1).float() for t in leaves])[None]
    return paths, leaves, row


def _from_row(paths, leaves, row: torch.Tensor):
    parts = torch.split(row[0], [t.numel() for t in leaves])
    return tree_from_leaves(paths, [p.reshape(t.shape).to(t.dtype)
                                    for p, t in zip(parts, leaves)])


def _seed_row(seed: int, device) -> torch.Tensor:
    return to_device(prng.as_int64(np.asarray([seed], np.uint64)), device)


def clip_and_noise_tree(tree, seed: int, epsilon: float, delta: float,
                        max_norm: float, use_pallas: Optional[bool] = None
                        ) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """Reference-mode DP on one client's weight-delta tree: clip the global
    L2 norm to ``max_norm``, σ from the CLIPPED norm (privacy.py:296-301),
    i.i.d. Gaussian noise on every element. The tree is flattened into one
    (1, D) row through :func:`fl_tpu_torch.ops.dp.clip_noise_matrix`, so
    on a card K3 carries the release (``use_pallas`` as there); ``seed``
    keys the noise. Returns (noisy tree, clipped norm, sigma), 0-d
    tensors."""
    paths, leaves, row = _as_row(tree)
    noisy, sens, sigma = dp_ops.clip_noise_matrix(
        row, _seed_row(seed, row.device), epsilon, delta, max_norm,
        use_pallas=use_pallas)
    return _from_row(paths, leaves, noisy), sens[0], sigma[0]


def clip_and_noise_tree_at_sigma(tree, seed: int, max_norm: float,
                                 sigma: float,
                                 use_pallas: Optional[bool] = None
                                 ) -> Tuple[Any, torch.Tensor]:
    """Clip a delta tree to global L2 ≤ ``max_norm`` and add i.i.d.
    N(0, σ²) with an EXPLICIT σ (the caller owns the accounting: wire
    adaptive clipping's inflated z_Δ·C). Returns (noisy tree, PRE-clip
    norm)."""
    paths, leaves, row = _as_row(tree)
    pre_norm = row.square().sum().sqrt()
    scale = dp_ops.clip_factors(pre_norm.reshape(1), max_norm)[0]
    sig = torch.full((1,), float(sigma), dtype=torch.float32,
                     device=row.device)
    noisy = dp_ops.clip_noise_route(use_pallas)(row, scale, sig,
                                                _seed_row(seed, row.device))
    return _from_row(paths, leaves, noisy), pre_norm


def _as_tensors(owner: str, gradients, device=None):
    """A gradient dict (tensors or arrays, nested or flat) as tensors: a
    tensor stays on its device, any other leaf goes to ``device`` (None:
    the card; without one this raises, as :func:`resolve_device` does)."""
    def leaf(v):
        if isinstance(v, torch.Tensor):
            return v
        return torch.as_tensor(np.asarray(v),
                               device=resolve_device(owner, device, None))

    return tree_map(leaf, dict(gradients))


class GradientClipper:
    """Host facade over the clip (ref: GradientClipper,
    privacy.py:95-168). Array leaves go to ``device`` (None: the card);
    tensors are clipped where they lie."""

    def __init__(self, max_grad_norm: float, device=None):
        self.max_grad_norm = max_grad_norm
        self.device = device

    def clip_gradients(self, gradients) -> Tuple[Any, float]:
        clipped, sens = clip_by_global_norm(
            _as_tensors("GradientClipper", gradients, self.device),
            self.max_grad_norm)
        return clipped, float(sens)

    def estimate_sensitivity(self, gradients_batch: List[Any]) -> float:
        """Max global norm across a batch of gradient dicts
        (ref: privacy.py:146-168)."""
        if not gradients_batch:
            return 0.0
        return max(float(global_norm(
            _as_tensors("GradientClipper", g, self.device)))
            for g in gradients_batch)


class GaussianNoiseGenerator:
    """Gaussian-mechanism noise (ref: GaussianNoiseGenerator,
    privacy.py:171-254), keyed by an explicit seed instead of global RNG
    state: draw k takes fold(seed, k). Noise on a gradient tree goes
    through the clip+noise kernel (K3 on a card) at scale 1. Array leaves
    and fresh noise go to ``device`` (None: the card); tensors are noised
    where they lie."""

    def __init__(self, seed: Optional[int] = None, device=None):
        self._seed = prng.root_seed(0 if seed is None else seed)
        self._draws = 0
        self.device = device

    def _next_seed(self) -> int:
        self._draws += 1
        return prng.fold(self._seed, self._draws)

    def generate_noise(self, shape, sensitivity: float, epsilon: float,
                       delta: float, device=None) -> torch.Tensor:
        """σ·N(0, 1) of ``shape`` on ``device`` (None: the generator's
        device)."""
        if epsilon <= 0:
            raise PrivacyError("Epsilon must be positive")
        if delta <= 0 or delta >= 1:
            raise PrivacyError("Delta must be in (0, 1)")
        device = resolve_device("GaussianNoiseGenerator",
                                self.device if device is None
                                else device, None)
        sigma = gaussian_sigma(sensitivity, epsilon, delta)
        g = prng.generator(self._next_seed(), device)
        return sigma * torch.randn(tuple(shape), generator=g, device=device)

    def add_noise_to_gradients(self, gradients, sensitivity: float,
                               epsilon: float, delta: float):
        paths, leaves, row = _as_row(_as_tensors(
            "GaussianNoiseGenerator", gradients, self.device))
        sigma = torch.full((1,), float(gaussian_sigma(sensitivity, epsilon,
                                                      delta)),
                           dtype=torch.float32, device=row.device)
        noisy = dp_ops.clip_noise(
            row, torch.ones((1,), dtype=torch.float32, device=row.device),
            sigma, _seed_row(self._next_seed(), row.device))
        return _from_row(paths, leaves, noisy)


class DifferentialPrivacyEngine:
    """Host DP engine mirroring the reference
    (ref: DifferentialPrivacyEngine, privacy.py:257-416): validate →
    budget-check → clip → noise with sensitivity = clipped norm →
    consume. Array gradients go to ``device`` (None: the card), so the
    release runs K3 there; tensors are released where they lie."""

    def __init__(self, privacy_config: PrivacyConfig,
                 seed: Optional[int] = None, device=None):
        self.config = privacy_config
        self.device = device
        self.clipper = GradientClipper(privacy_config.max_grad_norm, device)
        self.noise_generator = GaussianNoiseGenerator(seed, device)
        self.budget_tracker = PrivacyBudgetTracker(
            privacy_config.epsilon, privacy_config.delta)

    def add_noise(self, gradients, epsilon: float, delta: float):
        if not validate_privacy_parameters(epsilon, delta):
            raise PrivacyError("Invalid privacy parameters")
        if self.budget_tracker.is_budget_exhausted(epsilon, delta):
            raise PrivacyError("Privacy budget exhausted")
        clipped, actual_norm = self.clipper.clip_gradients(gradients)
        noisy = self.noise_generator.add_noise_to_gradients(
            clipped, actual_norm, epsilon, delta)
        self.budget_tracker.consume_budget(epsilon, delta, "gradient_noise")
        return noisy

    def clip_gradients(self, gradients, max_norm: float):
        clipped, _ = GradientClipper(max_norm,
                                     self.device).clip_gradients(gradients)
        return clipped

    def calculate_privacy_budget(self, epsilon: float, delta: float,
                                 steps: int) -> float:
        return advanced_composition_epsilon(epsilon, delta, steps)

    def validate_privacy_parameters(self, epsilon: float,
                                    delta: float) -> bool:
        return validate_privacy_parameters(epsilon, delta)

    def get_privacy_analysis(self) -> Dict[str, Any]:
        """ref: get_privacy_analysis, privacy.py:358-402."""
        strength_order = ["strong", "moderate", "weak"]
        eps_strength = ("strong" if self.config.epsilon < 1.0
                        else "moderate" if self.config.epsilon < 5.0
                        else "weak")
        delta_strength = ("strong" if self.config.delta < 1e-5
                          else "moderate" if self.config.delta < 1e-3
                          else "weak")
        recommendations = []
        if self.config.epsilon > 5.0:
            recommendations.append(
                "Consider reducing epsilon for stronger privacy")
        if self.config.delta > 1e-3:
            recommendations.append(
                "Consider reducing delta for better privacy guarantees")
        if self.config.max_grad_norm > 10.0:
            recommendations.append("Consider reducing gradient clipping norm")
        rem_e, _ = self.budget_tracker.get_remaining_budget()
        if rem_e < self.config.epsilon * 0.1:
            recommendations.append("Privacy budget nearly exhausted")
        if not recommendations:
            recommendations.append("Privacy configuration looks good")
        return {
            "privacy_config": {
                "epsilon": self.config.epsilon,
                "delta": self.config.delta,
                "max_grad_norm": self.config.max_grad_norm,
                "noise_multiplier": self.config.noise_multiplier,
            },
            "budget_status": self.budget_tracker.get_budget_status(),
            "privacy_strength": {
                "epsilon_strength": eps_strength,
                "delta_strength": delta_strength,
                "overall_strength": max(eps_strength, delta_strength,
                                        key=strength_order.index),
            },
            "recommendations": recommendations,
        }

    def reset_budget(self, new_epsilon: Optional[float] = None,
                     new_delta: Optional[float] = None) -> None:
        epsilon = new_epsilon or self.config.epsilon
        delta = new_delta or self.config.delta
        self.budget_tracker = PrivacyBudgetTracker(epsilon, delta)
        if new_epsilon:
            self.config.epsilon = new_epsilon
        if new_delta:
            self.config.delta = new_delta


def create_privacy_engine(epsilon: float = 1.0, delta: float = 1e-5,
                          max_grad_norm: float = 1.0,
                          noise_multiplier: float = 1.0,
                          seed: Optional[int] = None, device=None
                          ) -> DifferentialPrivacyEngine:
    """Factory (ref: create_privacy_engine, privacy.py:487-512);
    ``device`` as :class:`DifferentialPrivacyEngine`'s."""
    return DifferentialPrivacyEngine(
        PrivacyConfig(epsilon=epsilon, delta=delta,
                      max_grad_norm=max_grad_norm,
                      noise_multiplier=noise_multiplier),
        seed=seed, device=device)


def estimate_privacy_parameters(target_accuracy: float = 0.9,
                                dataset_size: int = 10_000,
                                num_rounds: int = 100) -> Dict[str, float]:
    """Heuristic parameter suggestion
    (ref: estimate_privacy_parameters, privacy.py:515-557)."""
    base_epsilon = 1.0 if dataset_size > 5000 else 2.0
    if target_accuracy > 0.95:
        epsilon = base_epsilon * 2
    elif target_accuracy < 0.85:
        epsilon = base_epsilon * 0.5
    else:
        epsilon = base_epsilon
    epsilon = epsilon / math.sqrt(num_rounds)
    return {
        "epsilon": epsilon,
        "delta": 1.0 / dataset_size,
        "max_grad_norm": 1.0 if target_accuracy > 0.9 else 2.0,
        "noise_multiplier": 1.0,
    }
