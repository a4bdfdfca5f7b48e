"""Parameter-tree helpers: trees are nested dicts of tensors with flax's
names (``{layer: {leaf}}`` for a model's parameters, ``{"params": ...,
"batch_stats": ...}`` for its variables), walked in flax's flatten order:
sorted keys at every depth, so ``batch_stats`` comes before ``params``. A
leaf's path is the tuple of its keys. Also the "/"-joined flat form of
nested dicts (``fl_tpu.core.pytree``'s ``flatten_dict`` /
``unflatten_dict``), which the masks of ``fl.peft``, the engine's weights
API and the checkpoint use."""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch


def tree_paths(tree) -> List[tuple]:
    """The key path of every leaf, in flax's flatten order (sorted keys at
    every depth)."""
    out: List[tuple] = []

    def rec(prefix, node):
        if isinstance(node, Mapping):
            for k in sorted(node):
                rec(prefix + (k,), node[k])
        else:
            out.append(prefix)

    rec((), tree)
    return out


def tree_get(tree, path: Sequence):
    """The leaf (or subtree) at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def tree_leaves(tree) -> list:
    """The leaves in :func:`tree_paths` order."""
    return [tree_get(tree, p) for p in tree_paths(tree)]


def tree_from_leaves(paths: Sequence[tuple], leaves) -> Dict:
    """The nested dict with ``leaves`` at ``paths``."""
    out: Dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn, *trees):
    """Apply ``fn`` leaf-wise over trees of the same structure (the first
    tree's)."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def global_norm(tree) -> torch.Tensor:
    """Global L2 norm over every leaf, in f32 (a 0-d tensor)."""
    sq = [leaf.float().square().sum() for leaf in tree_leaves(tree)]
    return torch.stack(sq).sum().sqrt()


def clip_by_global_norm(tree, max_norm: float):
    """Scale the whole tree so its global L2 norm is at most ``max_norm``:
    by min(1, C / max(‖x‖, 1e-12)). Returns ``(clipped tree, min(‖x‖,
    C))`` as ``fl_tpu.core.pytree.clip_by_global_norm``."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    clipped = tree_map(lambda x: (x * scale).to(x.dtype), tree)
    return clipped, torch.clamp(norm, max=max_norm)


# ---------------------------------------------------------------------------
# flat-dict <-> nested-dict conversion (wire / checkpoint / weights form)
# ---------------------------------------------------------------------------

def flatten_dict(nested: Mapping[str, Any], sep: str = "/") -> Dict[str, Any]:
    """Flatten a nested mapping into {"a/b/c": leaf} form."""
    out: Dict[str, Any] = {}

    def rec(prefix: str, node: Any) -> None:
        if isinstance(node, Mapping):
            for k in node:
                rec(f"{prefix}{sep}{k}" if prefix else str(k), node[k])
        else:
            out[prefix] = node

    rec("", nested)
    return out


def unflatten_dict(flat: Mapping[str, Any], sep: str = "/") -> Dict[str, Any]:
    """Inverse of :func:`flatten_dict`."""
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = path.split(sep)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def assert_same_structure(a: Mapping[str, Any], b: Mapping[str, Any]) -> None:
    """Raise if two flat weight dicts differ in keys or shapes."""
    ka, kb = set(a.keys()), set(b.keys())
    if ka != kb:
        missing = ka.symmetric_difference(kb)
        raise ValueError(
            f"Weight structures differ; mismatched keys: {sorted(missing)}")
    def shape(x):
        return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)

    for k in a:
        sa, sb = shape(a[k]), shape(b[k])
        if sa != sb:
            raise ValueError(f"Shape mismatch for {k!r}: {sa} vs {sb}")
