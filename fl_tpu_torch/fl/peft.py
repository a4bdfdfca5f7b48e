"""Parameter freezing for federated fine-tuning (port of ``fl_tpu.fl.peft``).

``RoundEngineConfig.trainable_patterns`` names the parameters that train,
by regular expressions over the "/"-joined parameter paths (``conv1/kernel``,
``fc2/bias``, ...); every other leaf is frozen. :func:`trainable_mask`
turns the patterns into a params-shaped 0/1 tree, which the engine passes to
the local trainer's ``grad_mask``: a frozen leaf's gradient is exactly zero,
so its optimizer state and its update stay exactly zero, its FedAvg delta is
zero, and the global model's frozen region keeps its initial bits across
rounds without DP (under delta DP the noise moves it, in the reference too).

Not ported yet: ``LoRADense`` and ``merge_lora``, which come with the ViT.
"""

from __future__ import annotations

import re
from typing import Any, Sequence, Tuple

import torch

from fl_tpu_torch.core import pytree as pt


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
