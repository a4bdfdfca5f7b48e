"""Lossy uplink compression with error feedback (port of
``fl_tpu.fl.uplink``).

Each client compresses its round delta before it is transmitted, and the
residual is carried to the next round as error feedback (Seide et al.
2014; Karimireddy et al. 2019): the client transmits ``compress(delta +
e_t)`` and keeps ``e_{t+1} = delta + e_t − transmitted``.

The whole population's deltas are one (C, D) f32 matrix
(:func:`fl_tpu_torch.ops.flatten.stack_flatten`), so

- ``int8``: per-row blocks of 2048 with symmetric scale block max / 127,
  rounded half to even and clipped to [-128, 127], then dequantized;
- ``topk``: each row keeps its k largest |x| (one batched ``torch.topk``
  and a scatter);
- ``powersgd``: :mod:`fl_tpu_torch.fl.powersgd` (it carries Q state).

All of it is plain PyTorch over the client axis, as the reference's is
``jnp`` (no Pallas kernel).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

UPLINK_KINDS = ("none", "int8", "topk", "powersgd")

_BLOCK = 2048  # quantization block (fl_tpu_torch.ops.quantize.CHUNK)


def int8_roundtrip_matrix(mat: torch.Tensor) -> torch.Tensor:
    """(C, D) -> (C, D): per-row blockwise int8 quantize → dequantize."""
    C, D = mat.shape
    pad = (-D) % _BLOCK
    xp = F.pad(mat, (0, pad)) if pad else mat
    nb = xp.shape[1] // _BLOCK
    x3 = xp.reshape(C, nb, _BLOCK).float()
    amax = torch.maximum(x3.amax(2), -x3.amin(2)).clamp(min=1e-12)
    # a tensor divisor on x's device: by a Python or CPU scalar, PyTorch's
    # CUDA kernel multiplies by the rounded reciprocal (one ulp off)
    scales = (amax / torch.full_like(amax, 127.0))[:, :, None]
    q = torch.div(x3, scales).round_().clamp_(-128, 127)
    out = q.mul_(scales).reshape(C, nb * _BLOCK)
    return out[:, :D] if pad else out


def topk_roundtrip_matrix(mat: torch.Tensor, k: int) -> torch.Tensor:
    """(C, D) -> (C, D): keep each row's k largest-|x| entries, zero rest."""
    C, D = mat.shape
    k = max(1, min(k, D))
    # unsorted: the scatter does not need the kept entries in order
    _, idx = torch.topk(mat.abs(), k, dim=1, sorted=False)
    return torch.zeros_like(mat).scatter_(1, idx, mat.gather(1, idx))


def make_uplink_fn(kind: str, topk_keep_ratio: float = 0.01,
                   d_valid: Optional[int] = None
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Compression round trip (C, D) -> (C, D) for the configured kind.

    ``d_valid``: the real (unpadded) parameter dimension. The top-k budget
    is ``round(d_valid·keep_ratio)``; without it the budget would count the
    lane padding."""
    if kind == "none":
        return lambda mat: mat
    if kind == "int8":
        return int8_roundtrip_matrix
    if kind == "powersgd":
        raise ValueError(
            "powersgd carries per-client Q state and is applied via "
            "fl_tpu_torch.fl.powersgd.apply_powersgd_with_error_feedback, "
            "not through the stateless make_uplink_fn interface")
    if kind == "topk":
        def fn(mat):
            d = d_valid if d_valid is not None else mat.shape[1]
            k = max(1, int(round(d * topk_keep_ratio)))
            return topk_roundtrip_matrix(mat, k)
        return fn
    raise ValueError(f"unknown uplink compression {kind!r}; "
                     f"choose from {UPLINK_KINDS}")


def apply_uplink_with_error_feedback(mat: torch.Tensor, ef: torch.Tensor,
                                     mask: torch.Tensor,
                                     uplink_fn: Callable) -> tuple:
    """One EF step over participant rows.

    transmitted = compress(delta + e_t); e_{t+1} = delta + e_t − transmitted.
    Non-participants transmit nothing and keep their residual unchanged.
    Returns (transmitted (C, D), new_ef (C, D))."""
    alive = (mask > 0.0).to(mat.dtype)[:, None]
    carried = mat + ef
    transmitted = uplink_fn(carried) * alive
    new_ef = torch.where(alive > 0, carried - transmitted, ef)
    return transmitted, new_ef
