"""SimpleCNN, plain: conv3x3(1→32) → relu → maxpool2 → conv3x3(32→64) →
relu → maxpool2 → flatten (H, W, C order) → dense(128) → relu → dropout
0.25 → dense(10), every client with its own weights (flax names and
layouts: HWIO kernels, (in, out) dense kernels), in float32.

Clients are channel groups of one grouped convolution and a batch of the
dense products. ``q`` rounds every value held in the compute dtype (the
identity in float32). The dropout mask is one (C, B, 128) draw from
the step's generator.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

from _round import (PER_EXAMPLE, grouped_conv, stack_planes,  # noqa: E402,F401
                    unstack_planes)

KEEP = 0.75


def dropout_keep(C: int, B: int, generator, device):
    return torch.rand((C, B, 128), generator=generator, device=device) < KEEP


def forward_taps(params, x, keep, q):
    """Logits and, for each parameterized layer, (kind, its input, its
    output before the activation)."""
    C, B = x.shape[:2]
    taps = []
    h = stack_planes(x)
    for name in ("conv1", "conv2"):
        p = params[name]
        a = h
        h = q(grouped_conv(h, p["kernel"], q, C) + q(p["bias"]).reshape(
            1, -1, 1, 1))
        taps.append(("conv", a, h))
        h = F.max_pool2d(torch.relu(h), 2)
    h = unstack_planes(h, C).reshape(C, B, -1)
    a = h
    h = q(torch.bmm(q(h), q(params["fc1"]["kernel"])) + q(
        params["fc1"]["bias"])[:, None, :])
    taps.append(("dense", a, h))
    h = torch.relu(h)
    if keep is not None:
        h = torch.where(keep, h / KEEP, torch.zeros_like(h))
    a = h
    h = q(torch.bmm(q(h), q(params["fc2"]["kernel"])) + q(
        params["fc2"]["bias"])[:, None, :])
    taps.append(("dense", a, h))
    return h, taps


def forward(params, x, keep, q, stats=None):
    logits, _ = forward_taps(params, x, keep, q)
    return logits, None
