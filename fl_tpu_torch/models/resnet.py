"""FederatedResNet — the lightweight ResNet the cifar100 route uses, over
stacked clients.

conv3x3(→64, no bias) → BatchNorm → relu, then three stages of basic
blocks (``num_blocks``, (2, 2, 2) by default) at 64 / 128 / 256 channels
with strides 1 / 2 / 2, global average pooling and the dense ``fc``: the
port of ``fl_tpu.models.resnet.FederatedResNet``. A block is conv3x3 → BN
→ relu → conv3x3 → BN, plus its input, or a 1×1 conv → BN shortcut where
the stride or the width changes, then relu.

As the other models of the port, the module holds no weights:
:meth:`FederatedResNet.forward` takes a tree of (C, ...) parameters with
the flax names (``conv1``, ``bn1``, ``layer{s}_block{b}`` with ``conv1``,
``bn1``, ``conv2``, ``bn2`` and, where there is one, ``shortcut_conv``,
``shortcut_bn``; ``fc``) and the ``batch_stats`` collection of the same
BatchNorm names, and runs every client at once on grouped planes
(``models.layers``). The convolutions follow XLA's "SAME" padding, which
at stride 2 pads one pixel below and right only. BatchNorm is flax's,
per client (``layers.batch_norm``); precision follows flax at ``dtype``.
"""

from __future__ import annotations

from typing import Dict, Sequence

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

STAGES = ((64, 1), (128, 2), (256, 2))   # (features, first stride)


class ResNetBlock:
    """The basic two-conv residual block over grouped planes."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        self.in_features = in_features
        self.features = features
        self.stride = stride
        self.shortcut = stride != 1 or in_features != features

    def bn_names(self):
        return ("bn1", "bn2") + (("shortcut_bn",) if self.shortcut else ())

    def init_batch_stats(self, device) -> Params:
        return {n: batch_stats_init(self.features, device)
                for n in self.bn_names()}

    def init(self, generator, device) -> Params:
        f, i = self.features, self.in_features
        p = {"conv1": {"kernel": lecun_normal((3, 3, i, f), generator,
                                              device)},
             "conv2": {"kernel": lecun_normal((3, 3, f, f), generator,
                                              device)}}
        if self.shortcut:
            p["shortcut_conv"] = {"kernel": lecun_normal((1, 1, i, f),
                                                         generator, device)}
        p.update({n: norm_init(f, device) for n in self.bn_names()})
        return p

    def __call__(self, params: Params, stats: Params, h: torch.Tensor,
                 C: int, train: bool, new_stats: Params) -> torch.Tensor:
        """h: (B, C·in, H, W) planes → (B, C·features, H/s, W/s); the
        updated statistics of a training forward go into ``new_stats``."""
        def bn(name, t):
            y, new = batch_norm(t, params[name], stats[name], train)
            if new is not None:
                new_stats[name] = new
            return y

        y = conv(h, params["conv1"]["kernel"], C, self.stride)
        y = torch.relu(bn("bn1", y))
        y = bn("bn2", conv(y, params["conv2"]["kernel"], C))
        if self.shortcut:
            h = bn("shortcut_bn", conv(h, params["shortcut_conv"]["kernel"],
                                       C, self.stride))
        return torch.relu(y + h)


class FederatedResNet(BatchNormCNN):
    """Functional FederatedResNet; see the module docstring."""

    name = "federated_resnet"
    head_name = "fc"
    stem = 64

    def __init__(self, num_classes: int = 10,
                 num_blocks: Sequence[int] = (2, 2, 2),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        check_dtype(dtype)
        self.num_classes = num_classes
        self.num_blocks = tuple(num_blocks)
        self.dtype = dtype
        self.blocks = {}
        width = self.stem
        for s, ((features, first), n) in enumerate(zip(STAGES,
                                                       self.num_blocks)):
            for b in range(n):
                self.blocks[f"layer{s + 1}_block{b + 1}"] = ResNetBlock(
                    width, features, first if b == 0 else 1)
                width = features
        self.width = width
        self.head = Dense(num_classes, dtype)
