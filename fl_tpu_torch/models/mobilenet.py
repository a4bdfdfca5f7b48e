"""LightweightMobileNet — the depthwise-separable CNN for constrained
clients, over stacked clients.

conv3x3(→32·w, no bias) → BatchNorm → relu, then six blocks of a
depthwise 3×3 conv (one group a channel) → BN → relu → pointwise 1×1 conv
→ BN → relu at (out channels, stride) (64, 1), (128, 2), (128, 1), (256,
2), (256, 1), (512, 2), each width scaled by ``width_multiplier`` through
:func:`make_divisible`, global average pooling and the dense
``classifier``: the port of ``fl_tpu.models.mobilenet.LightweightMobileNet``
(the factory's "lightweight" preset takes width 0.5).

The parameters are a tree of (C, ...) tensors with the flax names
(``conv1``, ``bn1``, ``block{i}`` with ``depthwise``, ``bn1``,
``pointwise``, ``bn2``; ``classifier``) and the ``batch_stats`` collection
of the same BatchNorm names. A depthwise conv is one grouped convolution
with a group for each of the C·K planes; its flax kernel (3, 3, 1, K)
stacks to the (C·K, 1, 3, 3) weight. Padding, BatchNorm and precision as
in ``models.resnet``.
"""

from __future__ import annotations

from typing import Dict

import torch

from fl_tpu_torch.models.layers import (
    BatchNormCNN,
    Dense,
    batch_norm,
    batch_stats_init,
    check_dtype,
    conv,
    lecun_normal,
    norm_init,
)

Params = Dict[str, dict]


def make_divisible(v: float, divisor: int = 8) -> int:
    """Channel rounding used by MobileNet-family width scaling
    (ref: src/shared/models_pytorch.py:279-283)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class MobileNetBlock:
    """Depthwise 3×3 + pointwise 1×1, each with BN + relu, over grouped
    planes."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        self.in_features = in_features
        self.features = features
        self.stride = stride

    def init(self, generator, device) -> Params:
        i, f = self.in_features, self.features
        return {"depthwise": {"kernel": lecun_normal((3, 3, 1, i), generator,
                                                     device)},
                "bn1": norm_init(i, device),
                "pointwise": {"kernel": lecun_normal((1, 1, i, f), generator,
                                                     device)},
                "bn2": norm_init(f, device)}

    def init_batch_stats(self, device) -> Params:
        return {"bn1": batch_stats_init(self.in_features, device),
                "bn2": batch_stats_init(self.features, device)}

    def __call__(self, params: Params, stats: Params, h: torch.Tensor,
                 C: int, train: bool, new_stats: Params) -> torch.Tensor:
        def bn_relu(name, t):
            y, new = batch_norm(t, params[name], stats[name], train)
            if new is not None:
                new_stats[name] = new
            return torch.relu(y)

        h = bn_relu("bn1", conv(h, params["depthwise"]["kernel"], h.shape[1],
                                self.stride))
        return bn_relu("bn2", conv(h, params["pointwise"]["kernel"], C))


class LightweightMobileNet(BatchNormCNN):
    """Functional LightweightMobileNet; see the module docstring."""

    name = "lightweight_mobilenet"
    head_name = "classifier"
    BLOCK_CONFIG = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                    (512, 2))

    def __init__(self, num_classes: int = 10, width_multiplier: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        check_dtype(dtype)
        self.num_classes = num_classes
        self.width_multiplier = width_multiplier
        self.dtype = dtype
        self.stem = make_divisible(32 * width_multiplier)
        self.blocks = {}
        width = self.stem
        for i, (out, stride) in enumerate(self.BLOCK_CONFIG, 1):
            out = make_divisible(out * width_multiplier)
            self.blocks[f"block{i}"] = MobileNetBlock(width, out, stride)
            width = out
        self.width = width
        self.head = Dense(num_classes, dtype)
