"""3x3 SAME conv as nine shifted batched GEMMs with a hand-written VJP.

The counterpart of ``fl_tpu.ops.conv.conv3x3_same`` under the engine's
client vmap. A 3x3 stride-1 SAME conv is

    y[b, h, w, :] = sum over (dh, dw) of
                        x_pad[b, h + dh, w + dw, :] @ W[dh, dw]

i.e. nine (B*H*W, I) @ (I, O) products, one batched GEMM each over the
client axis. The backward is written the same way:

    dx          = sum over (dh, dw) of shift(dy, 2 - dh, 2 - dw) @ W[dh, dw].T
    dW[dh, dw]  = shift(x, dh, dw).reshape(B*H*W, I).T @ dy

This is XLA work in the reference (no Pallas kernel), so it is plain
PyTorch here, on any device: ``torch.bmm`` on operands cast up to f32, so
that every product and the sum over the nine taps are f32 whatever the
operand dtype, and the result is rounded once. It is one of the
formulations ``chip_smoke.py``'s ``conv_formulations`` times beside the
library convolution and the patch GEMM (``ops/conv_patch.py``).

Shapes: x (C, B, H, W, I), w (C, 3, 3, I, O) -> (C, B, H, W, O); a 4-D x
with a 4-D w is the single-client case. The reference's ``Conv3x3Fast``
flax layer sits behind its ``fast_ops`` model flag, which the port refuses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def with_client_axis(fn, x, *rest):
    """Call ``fn`` on 5-D stacked-client tensors; 4-D ``x`` with operands
    that have no client axis either is the C = 1 case."""
    if x.dim() == 5:
        return fn(x, *rest)
    if x.dim() != 4:
        raise ValueError(f"x must be (C, B, H, W, I) or (B, H, W, I), got "
                         f"{tuple(x.shape)}")
    return fn(x[None], *(t[None] for t in rest))[0]


def check_conv_shapes(x, w):
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[:4]) != (
            x.shape[0], 3, 3, x.shape[4]):
        raise ValueError(
            f"x (C, B, H, W, I) needs w (C, 3, 3, I, O), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}")


def _gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(C, M, K) @ (C, K, N) with f32 products and sums, f32 result."""
    return torch.bmm(a.float(), b.float())


def _shifted(xp, dh, dw, H, W):
    """The (dh, dw) view of a padded (C, B, H+2, W+2, ch) tensor as
    (C, B*H*W, ch) rows."""
    C, ch = xp.shape[0], xp.shape[-1]
    return xp[:, :, dh:dh + H, dw:dw + W, :].reshape(C, -1, ch)


def _pad_hw(t):
    return F.pad(t, (0, 0, 1, 1, 1, 1))


class _Conv3x3Same(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        C, B, H, W, _ = x.shape
        O = w.shape[-1]
        xp = _pad_hw(x)
        acc = torch.zeros((C, B * H * W, O), dtype=torch.float32,
                          device=x.device)
        for dh in range(3):
            for dw in range(3):
                acc += _gemm(_shifted(xp, dh, dw, H, W), w[:, dh, dw])
        ctx.save_for_backward(x, w)
        return acc.reshape(C, B, H, W, O).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        C, B, H, W, I = x.shape
        O = w.shape[-1]
        g = g.to(x.dtype)
        dx = dw_ = None
        if ctx.needs_input_grad[0]:
            gp = _pad_hw(g)
            acc = torch.zeros((C, B * H * W, I), dtype=torch.float32,
                              device=x.device)
            for dh in range(3):
                for dw in range(3):
                    acc += _gemm(_shifted(gp, 2 - dh, 2 - dw, H, W),
                                 w[:, dh, dw].transpose(1, 2))
            dx = acc.reshape(C, B, H, W, I).to(x.dtype)
        if ctx.needs_input_grad[1]:
            xp = _pad_hw(x)
            g2 = g.reshape(C, B * H * W, O)
            rows = [_gemm(_shifted(xp, dh, dw, H, W).transpose(1, 2), g2)
                    for dh in range(3) for dw in range(3)]
            dw_ = torch.stack(rows, 1).reshape(C, 3, 3, I, O).to(w.dtype)
        return dx, dw_


def _conv3x3_same(x, w):
    check_conv_shapes(x, w)
    return _Conv3x3Same.apply(x, w)


def conv3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv over stacked clients as nine shifted GEMMs:
    x (C, B, H, W, I), w (C, 3, 3, I, O) -> (C, B, H, W, O) in x's dtype,
    f32 sums. Differentiable in x and w."""
    return with_client_axis(_conv3x3_same, x, w)
