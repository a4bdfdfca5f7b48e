"""SimpleCNN — the MNIST flagship model, over stacked clients.

conv3x3(1→32) → relu → maxpool2 → conv3x3(32→64) → relu → maxpool2 →
flatten(7·7·64) → dense(128) → relu → dropout → dense(num_classes), as
``fl_tpu.models.simple_cnn.SimpleCNN(fused_conv_block="residual")``.

The module holds no weights: the parameters are a plain tree with the flax
names and layouts (``conv1``/``conv2``/``fc1``/``fc2``, each with
``kernel``/``bias``; HWIO conv kernels, (in, out) dense kernels), stacked
over a leading client axis, and :meth:`SimpleCNN.forward` takes them as an
argument. Activations are NHWC, so fc1 reads the pooled (7, 7, 64) map in
HWC order exactly as flax flattens it.

Precision follows flax at ``dtype``: parameters stay f32, the image, the
weights and the biases are cast to the compute dtype; fc1 → relu → dropout
→ fc2 run in it; logits come back as f32. The conv segment is
``fl_tpu_torch.ops.conv_block.conv_stack_res`` (kernels K1/K2 on CUDA);
the two dense layers are batched GEMMs over clients (``torch.bmm``), which
the reference also leaves to the compiler.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from fl_tpu_torch.ops.conv_block import conv_stack_res

Params = Dict[str, Dict[str, torch.Tensor]]

_SHAPES = {
    "conv1": (3, 3, 1, 32),
    "conv2": (3, 3, 32, 64),
    "fc1": (7 * 7 * 64, 128),
}


def _lecun_normal(shape, generator, device) -> torch.Tensor:
    """flax's lecun_normal: truncated normal (±2 std) with variance
    1/fan_in, fan_in = every kernel dim but the last."""
    fan_in = math.prod(shape[:-1])
    # std of the unit normal truncated to (-2, 2)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class SimpleCNN(nn.Module):
    """Functional SimpleCNN; see the module docstring."""

    input_shape = (28, 28, 1)

    def __init__(self, num_classes: int = 10, dropout_rate: float = 0.25,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.num_classes = num_classes
        self.dropout_rate = dropout_rate
        self.dtype = dtype

    def param_shapes(self) -> Dict[str, tuple]:
        shapes = dict(_SHAPES, fc2=(128, self.num_classes))
        return {name: {"kernel": s, "bias": (s[-1],)}
                for name, s in shapes.items()}

    def init(self, generator: torch.Generator, device) -> Params:
        """lecun_normal kernels and zero biases, unstacked."""
        return {
            name: {"kernel": _lecun_normal(s["kernel"], generator, device),
                   "bias": torch.zeros(s["bias"], dtype=torch.float32,
                                       device=device)}
            for name, s in self.param_shapes().items()
        }

    def forward(self, params: Params, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """params: tree of (C, ...) tensors; x: (C, B, 28, 28, 1) normalized
        f32 images → (C, B, num_classes) f32 logits. ``generator`` draws the
        whole (C, B, 128) dropout mask when training."""
        cdt = self.dtype
        C, B = x.shape[:2]
        h = conv_stack_res(x.to(cdt), params["conv1"]["kernel"],
                           params["conv1"]["bias"], params["conv2"]["kernel"],
                           params["conv2"]["bias"])
        h = h.reshape(C, B, -1)
        h = torch.bmm(h, params["fc1"]["kernel"].to(cdt)) \
            + params["fc1"]["bias"].to(cdt)[:, None, :]
        h = torch.relu(h)
        if train and self.dropout_rate > 0.0:
            keep_prob = 1.0 - self.dropout_rate
            keep = torch.rand(h.shape, generator=generator,
                              device=h.device) < keep_prob
            h = torch.where(keep, h / keep_prob, torch.zeros_like(h))
        h = torch.bmm(h, params["fc2"]["kernel"].to(cdt)) \
            + params["fc2"]["bias"].to(cdt)[:, None, :]
        return h.float()


def params_from_flax(tree, device="cpu") -> Params:
    """A flax params tree of numpy arrays (with or without a client axis)
    as f32 torch tensors on ``device``, same names and layouts."""
    return {layer: {k: torch.tensor(np.asarray(v, np.float32), device=device)
                    for k, v in leaves.items()}
            for layer, leaves in tree.items()}


def params_to_flax(params: Params):
    """The inverse of :func:`params_from_flax`: numpy f32 arrays."""
    return {layer: {k: v.detach().cpu().numpy().astype(np.float32)
                    for k, v in leaves.items()}
            for layer, leaves in params.items()}


def count_params(params: Params) -> int:
    return sum(v.numel() for leaves in params.values() for v in leaves.values())
