"""Parameter-efficient federated fine-tuning: LoRA adapters and freezing
(port of ``fl_tpu.fl.peft``).

:class:`LoRADense` is a dense layer over stacked clients with a rank-r
adapter, y = x·W + b + (α/r)·(x·A)·B with A ~ N(0, (1/r)²) and B = 0, so
fine-tuning starts exactly at the base function; ``FederatedViT(lora_rank=
r)`` puts one on every attention and MLP projection, and
:func:`merge_lora` folds the adapters into the base kernels for export.

``RoundEngineConfig.trainable_patterns`` names the parameters that train,
by regular expressions over the "/"-joined parameter paths (``conv1/kernel``,
``fc2/bias``, ...); every other leaf is frozen. :func:`trainable_mask`
turns the patterns into a params-shaped 0/1 tree, which the engine passes to
the local trainer's ``grad_mask``: a frozen leaf's gradient is exactly zero,
so its optimizer state and its update stay exactly zero, its FedAvg delta is
zero, and the global model's frozen region keeps its initial bits across
rounds without DP (under delta DP the noise moves it, in the reference too).
"""

from __future__ import annotations

import re
from typing import Any, Sequence, Tuple

import torch

from fl_tpu_torch.core import pytree as pt
from fl_tpu_torch.models.layers import Dense, Leaves


class LoRADense(Dense):
    """A :class:`~fl_tpu_torch.models.layers.Dense` with a rank-r adapter:
    y = x·W + (α/r)·((x·A)·B) + b, every product in the compute dtype, the
    (C, in, r) ``lora_a`` and (C, r, out) ``lora_b`` cast to it. Freeze
    ``kernel`` / ``bias`` and train ``lora_a`` / ``lora_b``
    (:func:`lora_trainable_patterns`)."""

    def __init__(self, features: int, rank: int = 4, alpha: float = 8.0,
                 dtype: torch.dtype = torch.float32, use_bias: bool = True):
        super().__init__(features, dtype, use_bias)
        self.rank = rank
        self.alpha = alpha

    def init(self, in_features: int, generator, device) -> Leaves:
        """The base layer's init, A ~ N(0, (1/r)²) (a standard deviation of
        1/r, not 1/√r) and B = 0, unstacked."""
        p = super().init(in_features, generator, device)
        p["lora_a"] = torch.randn((in_features, self.rank),
                                  generator=generator,
                                  device=device) / self.rank
        p["lora_b"] = torch.zeros((self.rank, self.features), device=device)
        return p

    def __call__(self, params: Leaves, x: torch.Tensor) -> torch.Tensor:
        C, dt = x.shape[0], self.dtype
        h = x.to(dt).reshape(C, -1, x.shape[-1])
        y = torch.bmm(h, params["kernel"].to(dt))
        y = y + torch.bmm(torch.bmm(h, params["lora_a"].to(dt)),
                          params["lora_b"].to(dt)) * (self.alpha / self.rank)
        if self.use_bias:
            y = y + params["bias"].to(dt)[:, None, :]
        return y.reshape(x.shape[:-1] + (self.features,))


def merge_lora(params: Any, alpha: float = 8.0) -> Any:
    """Fold every {kernel, lora_a, lora_b} triple into the base kernel (W ←
    W + (α/r)·A·B, adapters zeroed), stacked or not: the merged tree
    computes the same function at the plain dense cost."""
    def walk(node):
        if isinstance(node, dict):
            if {"kernel", "lora_a", "lora_b"} <= set(node):
                a, b = node["lora_a"], node["lora_b"]
                r = a.shape[-1]
                merged = dict(node)
                merged["kernel"] = (node["kernel"] + (alpha / r)
                                    * torch.matmul(a, b)).to(
                    node["kernel"].dtype)
                merged["lora_a"] = torch.zeros_like(a)
                merged["lora_b"] = torch.zeros_like(b)
                return merged
            return {k: walk(v) for k, v in node.items()}
        return node
    return walk(params)


def trainable_mask(params: Any, patterns: Sequence[str]) -> Any:
    """Params-shaped f32 0/1 tree: leaf is trainable iff its "/"-joined
    path matches ANY of the regex ``patterns`` (re.search semantics)."""
    if not patterns:
        raise ValueError("trainable_patterns must name at least one "
                         "pattern (an empty set would freeze everything)")
    compiled = [re.compile(p) for p in patterns]
    flat = pt.flatten_dict(params)
    hits = {k: any(c.search(k) for c in compiled) for k in flat}
    if not any(hits.values()):
        raise ValueError(
            f"no parameter path matches {list(patterns)}; example paths: "
            f"{sorted(flat)[:5]}")
    mask_flat = {k: torch.ones_like(v, dtype=torch.float32) if hits[k]
                 else torch.zeros_like(v, dtype=torch.float32)
                 for k, v in flat.items()}
    return pt.unflatten_dict(mask_flat)


def lora_trainable_patterns() -> Tuple[str, ...]:
    """The standard LoRA fine-tuning set: adapters, LayerNorm scales/
    biases, and the classification head."""
    return ("lora_a", "lora_b", r"(^|/)ln[_0-9]*\w*/", "(^|/)head/")


def count_trainable(mask: Any) -> Tuple[int, int]:
    """(trainable, total) parameter counts under a 0/1 mask tree."""
    leaves = list(pt.flatten_dict(mask).values())
    total = sum(leaf.numel() for leaf in leaves)
    trainable = int(sum(float(leaf.sum()) for leaf in leaves))
    return trainable, total
