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
