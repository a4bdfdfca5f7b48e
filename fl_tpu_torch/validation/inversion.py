"""Gradient-inversion attack harness: empirical privacy-leakage evidence
(port of ``fl_tpu.validation.inversion``).

An honest-but-curious coordinator that observes one client's released
update tries to reconstruct the client's training images from it: "Deep
Leakage from Gradients" (Zhu et al. 2019), label inference from the
classifier bias gradient (iDLG, Zhao et al. 2020) and gradient matching
with a total-variation prior (Geiping et al. 2020). This module runs that
attack against updates produced by the port's own release path, with and
without DP (``fl.privacy.clip_and_noise_tree``: K3 on a card), so the
privacy story rests on a measured reconstruction gap.

Threat model as the reference's: the attacker sees one client's released
weight delta after one full-batch SGD step and knows the global model,
the learning rate and the preprocessing constants.

The attack differentiates a parameter gradient with respect to the input:
``torch.autograd.grad(..., create_graph=True)`` through the model's
forward, then a second backward to the dummy batch, a double backward
through the unfused SimpleCNN (its ``GroupedConv`` backward is
``aten.convolution_backward``, which autograd differentiates again, and
``F.max_pool2d``'s gradient keeps its first-maximal-member routing). A
fused conv segment (``fused_conv_block=True`` or ``"residual"``) has no
second derivative and is refused. The reference ``vmap``s its restarts;
here they are the stacked client axis: R copies of the victim's
parameters, each with its own dummy batch, so one forward and one double
backward a step serve every restart. Adam with a cosine-decayed rate runs
on the signed input gradient, as optax's ``adam(cosine_decay_schedule)``
computes it.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from fl_tpu_torch.core import prng
from fl_tpu_torch.core.pytree import (
    flatten_dict, tree_from_leaves, tree_leaves, tree_map, tree_paths)
from fl_tpu_torch.fl.local_training import cross_entropy_loss
from fl_tpu_torch.fl.privacy import clip_and_noise_tree

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class InversionAttackConfig:
    """Attack hyperparameters (the reference's defaults: L2 gradient
    matching with signed-gradient Adam and cosine lr decay)."""

    steps: int = 2000           # Adam iterations per restart
    restarts: int = 4           # independent random inits (stacked)
    learning_rate: float = 0.05  # cosine-decayed over `steps`
    tv_weight: float = 1e-3     # total-variation prior weight
    # "l2" (DLG, Zhu et al. 2019) | "cosine" (Geiping et al. 2020 eq. 4)
    matching: str = "l2"
    # signed-gradient descent (Geiping et al. §4)
    signed_gradients: bool = True


def gradient_from_delta(delta: Any, learning_rate: float) -> Any:
    """Recover the single-step SGD gradient from a released weight delta:
    θ_local = θ_global − lr·g  ⇒  g = −Δ/lr."""
    return tree_map(lambda d: -d / learning_rate, delta)


def infer_labels(fc_bias_grad: torch.Tensor, batch_size: int
                 ) -> torch.Tensor:
    """iDLG-style label inference from the final-layer bias gradient: the
    ``batch_size`` most negative coordinates (exact for batch size 1)."""
    order = torch.argsort(fc_bias_grad, stable=True)
    return order[:batch_size].to(torch.int64)


def find_classifier_bias_path(variables, num_classes: int) -> str:
    """The final classifier bias in the flat params dict: the last
    ``…/bias`` leaf of shape ``(num_classes,)``."""
    flat = flatten_dict(variables["params"])
    candidates = [k for k, v in flat.items()
                  if k.endswith("bias") and tuple(v.shape) == (num_classes,)]
    if not candidates:
        raise ValueError(
            f"no (num_classes={num_classes},) bias leaf found; "
            f"params leaves: {sorted(flat)}")
    return candidates[-1]


def _total_variation(x: torch.Tensor) -> torch.Tensor:
    """Anisotropic TV of each (B, H, W, C) batch of a (R, B, H, W, C)
    stack: (R,)."""
    dh = (x[:, :, 1:] - x[:, :, :-1]).abs().flatten(1).mean(1)
    dw = (x[:, :, :, 1:] - x[:, :, :, :-1]).abs().flatten(1).mean(1)
    return dh + dw


def _check_model(model) -> None:
    if getattr(model, "fused_conv_block", False):
        raise ValueError(
            "the inversion attack differentiates a parameter gradient "
            "with respect to the input, and a fused conv segment has no "
            "second derivative: build the model with "
            "fused_conv_block=False")


def _victim_grads(model, params, x: torch.Tensor, labels: torch.Tensor,
                  create_graph: bool):
    """Each stacked copy's gradient of its mean cross-entropy (eval-mode
    forward): params (R, ...) leaves requiring grad, x (R, B, H, W, C),
    labels (R, B)."""
    leaves = tree_leaves(params)
    logits = model(params, x, train=False)
    loss = cross_entropy_loss(logits, labels).sum()
    return torch.autograd.grad(loss, leaves, create_graph=create_graph)


def matching_loss_fn(model, config: InversionAttackConfig) -> Callable:
    """The attack's objective: ``fn(x, params, targets, labels,
    create_graph=True) -> (R,)``, each restart's matching loss between
    its victim gradient at x (R, B, H, W, C) (``params``: (R, ...) leaves
    requiring grad; ``targets``: the (1, ...) target leaves in tree
    order) and the target, plus the TV prior. L2 sums squared gaps;
    cosine sums 1 − cos over the leaves (Geiping et al. 2020 eq. 4)."""
    if config.matching not in ("l2", "cosine"):
        raise ValueError(
            f"matching must be 'l2' or 'cosine', got {config.matching!r}")

    def matching_losses(x, params, targets, labels, create_graph=True):
        g = _victim_grads(model, params, x, labels, create_graph)
        if config.matching == "l2":
            m = sum((gl - tl).square().flatten(1).sum(1)
                    for gl, tl in zip(g, targets))
        else:
            m = 0.0
            for gl, tl in zip(g, targets):
                num = (gl * tl).flatten(1).sum(1)
                den = gl.flatten(1).norm(dim=1) * tl.flatten(1).norm(dim=1)
                m = m + (1.0 - num / torch.clamp(den, min=1e-12))
        return m + config.tv_weight * _total_variation(x)

    return matching_losses


def make_gradient_matching_attack(
    model,
    batch_size: int,
    config: InversionAttackConfig = InversionAttackConfig(),
) -> Callable:
    """Build the attack: reconstruct a normalized image batch from an
    observed parameter gradient.

    Returns ``attack(variables, target_grads, labels, seed) -> (x_best,
    best_loss, losses_per_restart)``: ``variables`` the victim's model
    (unstacked), ``target_grads`` a params-shaped tree, ``labels`` the
    (inferred) (B,) labels; ``x_best`` is the best reconstruction (B, H,
    W, C) in normalized-pixel space. Restart r starts from N(0, 1) drawn
    from fold(seed, r)."""
    _check_model(model)
    matching_losses = matching_loss_fn(model, config)
    H, W, C = model.input_shape
    R = config.restarts

    def attack(variables, target_grads, labels, seed: int):
        vparams = variables["params"]
        dev = tree_leaves(vparams)[0].device
        params = tree_map(
            lambda v: v.detach()[None].repeat(R, *([1] * v.dim()))
            .requires_grad_(True), vparams)
        targets = [t.detach()[None].to(dev)
                   for t in tree_leaves(target_grads)]
        ys = torch.as_tensor(labels).to(dev).long()[None].expand(R, -1)
        x = torch.stack([
            torch.randn((batch_size, H, W, C), device=dev,
                        generator=prng.generator(prng.fold(seed, r), dev))
            for r in range(R)])
        mu = torch.zeros_like(x)
        nu = torch.zeros_like(x)
        for t in range(config.steps):
            x.requires_grad_(True)
            loss = matching_losses(x, params, targets, ys).sum()
            gx, = torch.autograd.grad(loss, x)
            with torch.no_grad():
                x = x.detach()
                if config.signed_gradients:
                    gx = torch.sign(gx)
                # optax.adam over cosine_decay_schedule(lr, steps)
                lr = config.learning_rate * 0.5 * (
                    1.0 + math.cos(math.pi * min(t, config.steps)
                                   / config.steps))
                mu.mul_(ADAM_B1).add_(gx, alpha=1.0 - ADAM_B1)
                nu.mul_(ADAM_B2).addcmul_(gx, gx, value=1.0 - ADAM_B2)
                mhat = mu / (1.0 - ADAM_B1 ** (t + 1))
                vhat = nu / (1.0 - ADAM_B2 ** (t + 1))
                x = x - lr * mhat / (torch.sqrt(vhat) + ADAM_EPS)
        x.requires_grad_(True)
        losses = matching_losses(x, params, targets, ys,
                                 create_graph=False).detach()
        best = int(torch.argmin(losses))
        return x.detach()[best], losses[best], losses

    return attack


def _best_match_mse(recon: np.ndarray, truth: np.ndarray) -> float:
    """Pixel MSE under the best batch-item assignment (exact min over
    permutations, batch ≤ 6)."""
    B = truth.shape[0]
    if B > 6:
        raise ValueError("permutation matching supports batch sizes <= 6")
    pair = np.asarray([
        [float(np.mean((recon[i] - truth[j]) ** 2)) for j in range(B)]
        for i in range(B)
    ])
    return min(
        sum(pair[i, p[i]] for i in range(B)) / B
        for p in itertools.permutations(range(B))
    )


def evaluate_inversion_risk(
    model,
    variables,
    images_u8: np.ndarray,
    labels: np.ndarray,
    mean,
    std,
    learning_rate: float = 0.1,
    dp: Optional[Dict[str, float]] = None,
    attack_config: InversionAttackConfig = InversionAttackConfig(),
    seed: int = 0,
) -> Dict[str, Any]:
    """Measure what one released single-step update leaks.

    The victim takes one full-batch SGD step on ``images_u8`` / ``labels``
    from ``variables`` (one model's tree, on the device the attack runs
    on) and releases it as a weight delta, optionally through the
    reference-semantics DP release (``dp = {"epsilon", "delta",
    "max_norm"}``, :func:`~fl_tpu_torch.fl.privacy.clip_and_noise_tree`);
    then label inference and gradient matching run against the release.
    The DP noise is keyed fold(root(seed), 0), the attack's restarts
    fold(root(seed), 1).

    Returns pixel-space metrics in [0, 1] units (``mse`` / ``psnr_db``
    under the best batch assignment), the iDLG ``label_accuracy``, the
    attack's final matching loss and the reconstructed batch (u8)."""
    _check_model(model)
    B = int(images_u8.shape[0])
    dev = tree_leaves(variables)[0].device
    mean_t = torch.as_tensor(np.asarray(mean, np.float32), device=dev)
    std_t = torch.as_tensor(np.asarray(std, np.float32), device=dev)
    root = prng.root_seed(seed)
    s_dp, s_attack = prng.fold(root, 0), prng.fold(root, 1)

    x_true = (torch.as_tensor(np.asarray(images_u8, np.float32),
                              device=dev) / 255.0 - mean_t) / std_t
    y_true = torch.as_tensor(np.asarray(labels, np.int64), device=dev)

    # --- victim: one SGD step, released as a delta ------------------------
    params = tree_map(lambda v: v.detach()[None].requires_grad_(True),
                      variables["params"])
    g = _victim_grads(model, params, x_true[None], y_true[None], False)
    delta = tree_from_leaves(tree_paths(params),
                             [-learning_rate * gl[0] for gl in g])
    if dp is not None:
        delta, _, sigma = clip_and_noise_tree(
            delta, s_dp, epsilon=float(dp["epsilon"]),
            delta=float(dp["delta"]), max_norm=float(dp["max_norm"]))
        sigma = float(sigma)
    else:
        sigma = 0.0

    # --- attacker: recover gradient, infer labels, reconstruct -----------
    target_grads = gradient_from_delta(delta, learning_rate)
    bias_path = find_classifier_bias_path(variables, model.num_classes)
    y_hat = infer_labels(flatten_dict(target_grads)[bias_path], B)
    attack = make_gradient_matching_attack(model, B, attack_config)
    x_hat, best_loss, losses = attack(variables, target_grads, y_hat,
                                      s_attack)

    # --- metrics in [0,1] pixel space -------------------------------------
    recon_px = torch.clamp(x_hat * std_t + mean_t, 0.0, 1.0).cpu().numpy()
    truth_px = np.asarray(images_u8, np.float64) / 255.0
    mse = _best_match_mse(recon_px.astype(np.float64), truth_px)
    psnr = 10.0 * math.log10(1.0 / max(mse, 1e-12))
    y_hat = y_hat.cpu().numpy()
    label_acc = float(np.mean(np.isin(y_hat, np.asarray(labels)).astype(
        np.float64)))
    return {
        "mse": float(mse),
        "psnr_db": float(psnr),
        "label_accuracy": label_acc,
        "inferred_labels": y_hat.tolist(),
        "true_labels": np.asarray(labels).tolist(),
        "matching_loss": float(best_loss),
        "restart_losses": losses.cpu().tolist(),
        "dp": dict(dp) if dp else None,
        "noise_sigma": sigma,
        "reconstruction_u8": (recon_px * 255.0).astype(np.uint8),
    }


def inversion_report(
    model,
    variables,
    images_u8: np.ndarray,
    labels: np.ndarray,
    mean,
    std,
    epsilon: float = 1.0,
    delta: float = 1e-5,
    max_norm: float = 1.0,
    learning_rate: float = 0.1,
    attack_config: InversionAttackConfig = InversionAttackConfig(),
    seed: int = 0,
) -> Dict[str, Any]:
    """Run the attack against the non-private and the DP release of the
    same update and report the reconstruction gap: DP should collapse
    PSNR to near the random-init floor while the non-private release
    reconstructs the batch."""
    base = evaluate_inversion_risk(
        model, variables, images_u8, labels, mean, std,
        learning_rate=learning_rate, dp=None,
        attack_config=attack_config, seed=seed)
    private = evaluate_inversion_risk(
        model, variables, images_u8, labels, mean, std,
        learning_rate=learning_rate,
        dp={"epsilon": epsilon, "delta": delta, "max_norm": max_norm},
        attack_config=attack_config, seed=seed)
    return {
        "non_private": {k: v for k, v in base.items()
                        if k != "reconstruction_u8"},
        "dp": {k: v for k, v in private.items()
               if k != "reconstruction_u8"},
        "psnr_gap_db": base["psnr_db"] - private["psnr_db"],
        "protected": private["psnr_db"] < base["psnr_db"],
    }
