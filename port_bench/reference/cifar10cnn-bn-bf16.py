"""CIFAR10CNN with BatchNorm, plain: three blocks of [conv3x3 → BatchNorm
→ relu] ×2 → maxpool2 → dropout at 32 / 64 / 128 channels, then flatten
(H, W, C order) → dense(512) → relu → dropout → dense(256) → relu →
dropout → dense(10), dropout rate 0.3, every client with its own weights
and running statistics, in float32.

BatchNorm in training, per client and channel (flax's defaults): the
batch mean and the biased variance max(0, E[x²] − E[x]²) over (B, H, W),
eps 1e-5, and the running statistics updated as 0.99·running + 0.01·batch.
The dropout masks are drawn from the step's generator in the order pool1,
pool2, pool3 (NHWC), fc1, fc2.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

from _round import grouped_conv, stack_planes, unstack_planes  # noqa: E402

KEEP = 0.7
BN_EPS = 1e-5
BN_MOMENTUM = 0.99
WIDTHS = (32, 32, 64, 64, 128, 128)


def dropout_keep(C: int, B: int, generator, device):
    shapes = {"pool1": (C, B, 16, 16, 32), "pool2": (C, B, 8, 8, 64),
              "pool3": (C, B, 4, 4, 128), "fc1": (C, B, 512),
              "fc2": (C, B, 256)}
    return {k: torch.rand(s, generator=generator, device=device) < KEEP
            for k, s in shapes.items()}


def batch_norm(h, p, stats):
    C = p["scale"].shape[0]
    mean = h.mean((0, 2, 3))
    var = torch.clamp(h.square().mean((0, 2, 3)) - mean.square(), min=0.0)
    mul = torch.rsqrt(var + BN_EPS) * p["scale"].reshape(-1)
    y = ((h - mean[:, None, None]) * mul[:, None, None]
         + p["bias"].reshape(-1)[:, None, None])
    new = {"mean": BN_MOMENTUM * stats["mean"]
           + (1 - BN_MOMENTUM) * mean.detach().reshape(C, -1),
           "var": BN_MOMENTUM * stats["var"]
           + (1 - BN_MOMENTUM) * var.detach().reshape(C, -1)}
    return y, new


def forward(params, x, keep, q, stats):
    C, B = x.shape[:2]
    new_stats = {}
    h = stack_planes(x)
    for i in range(1, 7):
        p = params[f"conv{i}"]
        h = q(grouped_conv(h, p["kernel"], q, C) + q(p["bias"]).reshape(
            1, -1, 1, 1))
        h, new_stats[f"bn{i}"] = batch_norm(h, params[f"bn{i}"],
                                            stats[f"bn{i}"])
        h = torch.relu(q(h))
        if i % 2 == 0:
            h = F.max_pool2d(h, 2)
            if keep is not None:
                k = stack_planes(keep[f"pool{i // 2}"])
                h = torch.where(k, h / KEEP, torch.zeros_like(h))
    h = unstack_planes(h, C).reshape(C, B, -1)
    for i in (1, 2, 3):
        p = params[f"fc{i}"]
        h = q(torch.bmm(q(h), q(p["kernel"])) + q(p["bias"])[:, None, :])
        if i < 3:
            h = torch.relu(h)
            if keep is not None:
                h = torch.where(keep[f"fc{i}"], h / KEEP, torch.zeros_like(h))
    return h, new_stats
