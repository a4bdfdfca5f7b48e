"""Parameter-tree helpers: trees are ``{layer: {leaf: tensor}}`` dicts with
flax's names, walked in flax's flatten order (sorted keys)."""

from __future__ import annotations

from typing import List

import torch


def tree_paths(tree) -> List[tuple]:
    """(layer, leaf) paths in flax's flatten order."""
    return [(layer, k) for layer in sorted(tree) for k in sorted(tree[layer])]


def tree_map(fn, *trees):
    """Apply ``fn`` leaf-wise over trees of the same structure."""
    return {layer: {k: fn(*(t[layer][k] for t in trees))
                    for k in trees[0][layer]}
            for layer in trees[0]}


def global_norm(tree) -> torch.Tensor:
    """Global L2 norm over every leaf, in f32 (a 0-d tensor)."""
    sq = [tree[l][k].float().square().sum() for l, k in tree_paths(tree)]
    return torch.stack(sq).sum().sqrt()


def clip_by_global_norm(tree, max_norm: float):
    """Scale the whole tree so its global L2 norm is at most ``max_norm``:
    by min(1, C / max(‖x‖, 1e-12)). Returns ``(clipped tree, min(‖x‖,
    C))`` as ``fl_tpu.core.pytree.clip_by_global_norm``."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    clipped = tree_map(lambda x: (x * scale).to(x.dtype), tree)
    return clipped, torch.clamp(norm, max=max_norm)
