"""Client-stacked parameter tree <-> (C, D) flat matrix (port of
``fl_tpu.ops.flatten``).

The uplink compressors work on the flat per-client parameter vector, so
one code path serves every model. These helpers flatten a ``{layer:
{leaf}}`` tree whose leaves carry a leading client axis C into one (C,
D_pad) f32 matrix and back. Leaves go in flax's flatten order (sorted
layer, then sorted leaf: :func:`fl_tpu_torch.core.pytree.tree_paths`) and
in their flax layouts, each reshaped row-major, so every column is the
reference's column: the int8 blocks and PowerSGD's matrix views are
functions of this layout. D is zero-padded to a multiple of ``LANE``.
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from fl_tpu_torch.core.pytree import tree_paths

LANE = 128


def flat_dim(tree, batched: bool = True) -> int:
    """Unpadded total D of a (client-stacked) tree."""
    start = 1 if batched else 0
    return sum(math.prod(tree[l][k].shape[start:]) for l, k in tree_paths(tree))


def padded_dim(d: int) -> int:
    return ((d + LANE - 1) // LANE) * LANE


def stack_flatten(tree) -> Tuple[torch.Tensor, Any]:
    """(C, ...)-leaf tree -> ((C, D_pad) float32 matrix, spec).

    The spec holds the leaf paths, shapes and dtypes for
    :func:`stack_unflatten`."""
    paths = tree_paths(tree)
    leaves = [tree[l][k] for l, k in paths]
    c = leaves[0].shape[0]
    d = flat_dim(tree)
    mat = torch.zeros((c, padded_dim(d)), dtype=torch.float32,
                      device=leaves[0].device)
    offset = 0
    for leaf in leaves:
        size = leaf[0].numel()
        mat[:, offset:offset + size] = leaf.reshape(c, size)
        offset += size
    spec = (paths, [(tuple(leaf.shape), leaf.dtype) for leaf in leaves], d)
    return mat, spec


def stacked_spec(tree, num_rows: int) -> Any:
    """The :func:`stack_flatten` spec of an unstacked tree stacked
    ``num_rows`` times in f32, without building the matrix."""
    paths = tree_paths(tree)
    shapes = [((num_rows,) + tuple(tree[l][k].shape), torch.float32)
              for l, k in paths]
    return (paths, shapes, flat_dim(tree, batched=False))


def stack_unflatten(mat: torch.Tensor, spec: Any):
    """The inverse of :func:`stack_flatten`. A leaf whose dtype is f32 is a
    view of ``mat``."""
    paths, shapes_dtypes, _ = spec
    c = mat.shape[0]
    out: dict = {}
    offset = 0
    for (layer, k), (shape, dtype) in zip(paths, shapes_dtypes):
        size = math.prod(shape[1:])
        chunk = mat[:, offset:offset + size].reshape((c,) + shape[1:])
        out.setdefault(layer, {})[k] = chunk.to(dtype)
        offset += size
    return out
