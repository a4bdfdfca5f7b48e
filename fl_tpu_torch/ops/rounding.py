"""Unbiased stochastic f32 -> bf16 rounding for bf16 parameter storage
(port of ``fl_tpu.ops.rounding``).

Bitcast the f32 to u32, add 16 dither bits below the bf16 mantissa
cutoff, keep the top 16 bits: the carry out of the addition is the round
up, taken with probability equal to the truncated fraction, so the stored
value equals the f32 input in expectation (and sign-magnitude makes it so
for negatives too). The dither is the murmur3 finalizer of (element index
+ seed), the reference's counter-based hash, so a given u32 seed rounds
every element exactly as the reference does.

torch has no full u32 arithmetic, so the hash runs in int64 holding u32
values: every product is split into 16-bit halves so that no int64 product
overflows, and each step is masked back to 32 bits. Non-finite values pass
through as the reference's cast gives them (inf keeps its bits; NaN
becomes the quiet NaN of its sign).

Stacked clients: with a (C,) seed vector the leading axis of ``x`` is the
client axis, and each client's element index restarts at 0 over its own
row, as ``jnp.arange(x.size)`` does for one client under ``vmap``.

Plain PyTorch (a handful of elementwise passes a leaf), as the reference's
is a fusion XLA makes; there is no kernel of its own.
"""

from __future__ import annotations

from typing import Union

import torch

from fl_tpu_torch.core.pytree import tree_paths

_M32 = 0xFFFFFFFF
_LEAF_STRIDE = 0x9E3779B1   # folds the leaf index into the seed
STEP_STRIDE = 0x9E3779B9    # folds the local step into the seed


def _mul32(z: torch.Tensor, k: int) -> torch.Tensor:
    """(z · k) mod 2^32 for int64 z holding u32 values: the product of z
    with k's low and high 16-bit halves, each below 2^48."""
    lo = z * (k & 0xFFFF)
    hi = ((z * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _murmur3_mix(z: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int64 tensors holding u32 values."""
    z = z ^ (z >> 16)
    z = _mul32(z, 0x85EBCA6B)
    z = z ^ (z >> 13)
    z = _mul32(z, 0xC2B2AE35)
    return z ^ (z >> 16)


def _as_seed(seed, device) -> torch.Tensor:
    if not torch.is_tensor(seed):
        seed = torch.tensor(int(seed), dtype=torch.int64)
    return seed.to(device=device, dtype=torch.int64) & _M32


def stochastic_round_bf16(x: torch.Tensor,
                          seed: Union[int, torch.Tensor]) -> torch.Tensor:
    """Round f32 ``x`` to bf16, up with probability = truncated fraction.

    ``seed`` is a u32 value (an int or a 0-d tensor), whose element index
    runs over the whole of ``x``, or a (C,) tensor of u32 values, one a
    client, whose index restarts at 0 on each row of ``x``'s leading
    client axis."""
    if x.dtype != torch.float32:
        raise TypeError(f"stochastic_round_bf16 takes float32, got {x.dtype}")
    seed = _as_seed(seed, x.device)
    if seed.dim() == 0:
        rows, n = 1, x.numel()
        seed = seed.reshape(1, 1)
    else:
        rows = x.shape[0]
        if seed.shape != (rows,):
            raise ValueError(f"{tuple(seed.shape)} seeds for {rows} rows")
        n = x[0].numel() if rows else 0
        seed = seed[:, None]
    u = x.reshape(rows, n).view(torch.int32).to(torch.int64) & _M32
    idx = torch.arange(n, dtype=torch.int64, device=x.device)[None, :]
    dither = _murmur3_mix((idx + seed) & _M32) & 0xFFFF
    top = ((u + dither) & _M32) >> 16
    # non-finite: inf keeps its top bits, NaN is the quiet NaN of its sign
    nan = torch.isnan(x).reshape(rows, n)
    top = torch.where(nan, (u >> 16) & 0x8000 | 0x7FC0,
                      torch.where(torch.isinf(x).reshape(rows, n),
                                  u >> 16, top))
    # the 16 bits as int16 (two's complement) and bitcast: no float cast,
    # which would rewrite NaN payloads
    bits = top - ((top >> 15) << 16)
    return bits.to(torch.int16).view(torch.bfloat16).reshape(x.shape)


def leaf_seed(seed, i: int):
    """The seed of leaf i of a tree rounded with ``seed``."""
    return seed + ((i * _LEAF_STRIDE) & _M32)


def stochastic_round_tree_bf16(tree, seed):
    """:func:`stochastic_round_bf16` over every leaf of a ``{layer: {leaf}}``
    tree in flax's leaf order, leaf i with :func:`leaf_seed`."""
    out = {layer: {} for layer in tree}
    for i, (layer, k) in enumerate(tree_paths(tree)):
        out[layer][k] = stochastic_round_bf16(
            tree[layer][k],
            leaf_seed(_as_seed(seed, tree[layer][k].device), i))
    return out
