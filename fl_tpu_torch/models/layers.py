"""Layers shared by the port's models, over stacked clients.

The convolutional models carry activations as grouped planes (B, C·K, H,
W): client c's K channels are planes c·K .. c·K + K − 1, so one grouped
convolution (one group a client, or one a plane for a depthwise conv) runs
every client at once. Parameters are (C, ...) stacks with flax's names and
layouts (HWIO conv kernels, (in, out) dense kernels, per-channel norm
scales and biases). Everything here is plain PyTorch written to flax's
numerics at a compute dtype: parameters stay f32 and are cast at use, the
norms reduce in f32 and round their output once, and no f32 product takes
TF32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

Leaves = Dict[str, torch.Tensor]

BN_MOMENTUM = 0.99
BN_EPS = 1e-5
LN_EPS = 1e-6
COMPUTE_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def check_dtype(dtype: torch.dtype) -> None:
    if dtype not in COMPUTE_DTYPES:
        raise ValueError("dtype must be float32, bfloat16 or float64, "
                         f"got {dtype}")


@contextlib.contextmanager
def cudnn_tf32_off():
    """cuDNN's TF32 switch off inside the block and as it was after it.
    (``torch.backends.cudnn.flags`` would also set cuDNN's other switches
    to its own defaults, ``enabled=False`` among them.)"""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


class GroupedConv(torch.autograd.Function):
    """``F.conv2d(h, w, stride=stride, padding=padding, groups=groups)``
    with TF32 off in the forward and in the backward (autograd runs the
    backward after the caller's ``with`` block has ended, so a context
    manager around the forward alone would not cover it)."""

    @staticmethod
    def forward(ctx, h, w, groups, stride=1, padding=1):
        ctx.save_for_backward(h, w)
        ctx.conf = (groups, stride, padding)
        with cudnn_tf32_off():
            return F.conv2d(h, w, stride=stride, padding=padding,
                            groups=groups)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        groups, stride, padding = ctx.conf
        with cudnn_tf32_off():
            dh, dw, _ = torch.ops.aten.convolution_backward(
                g, h, w, None, [stride] * 2, [padding] * 2, [1, 1], False,
                [0, 0], groups, [ctx.needs_input_grad[0],
                                 ctx.needs_input_grad[1], False])
        return dh, dw, None, None, None


def planes_to_nhwc(h: torch.Tensor, C: int) -> torch.Tensor:
    """(B, C*K, H, W) grouped planes -> (C, B, H, W, K) stacked NHWC."""
    B, CK, H, W = h.shape
    return h.reshape(B, C, CK // C, H, W).permute(1, 0, 3, 4, 2)


def nhwc_to_planes(t: torch.Tensor) -> torch.Tensor:
    """(C, B, H, W, K) stacked NHWC -> (B, C*K, H, W) grouped planes."""
    C, B, H, W, K = t.shape
    return t.permute(1, 0, 4, 2, 3).reshape(B, C * K, H, W)


def lecun_normal(shape, generator, device) -> torch.Tensor:
    """flax's lecun_normal: truncated normal (±2 std) with variance
    1/fan_in, fan_in = every kernel dim but the last."""
    fan_in = math.prod(shape[:-1])
    # std of the unit normal truncated to (-2, 2)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def same_pads(n: int, k: int, s: int):
    """XLA's "SAME" padding of one axis: (low, high) with total max((⌈n/s⌉
    − 1)·s + k − n, 0) and low = total // 2. At stride 2 and an even n it
    is asymmetric ((0, 1) for k = 3), which a symmetric padding would shift
    by one pixel."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(h: torch.Tensor, kernel: torch.Tensor, groups: int,
         stride: int = 1) -> torch.Tensor:
    """flax's ``nn.Conv(padding="SAME", use_bias=False)`` over grouped
    planes: h (B, C·I', H, W) in the compute dtype, kernel the (C, kh, kw,
    I, O) stack of HWIO kernels, cast to h's dtype. ``groups`` is C for a
    dense conv (I = I') and C·I' for a depthwise one (I = 1, flax's
    ``feature_group_count``): either way plane group g takes kernel column
    g, so the (C·O, I, kh, kw) weight is the same reshape."""
    kh, kw, i = kernel.shape[1:4]
    w = kernel.to(h.dtype).permute(0, 4, 3, 1, 2).reshape(-1, i, kh, kw)
    ph = same_pads(h.shape[2], kh, stride)
    pw = same_pads(h.shape[3], kw, stride)
    pad = ph[0]
    if not ph[0] == ph[1] == pw[0] == pw[1]:
        h, pad = F.pad(h, pw + ph), 0
    return GroupedConv.apply(h, w, groups, stride, pad)


def wide(t: torch.Tensor) -> torch.Tensor:
    """t in at least f32, flax's ``force_float32_reductions``."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def norm_apply(x32: torch.Tensor, mean, rstd, scale, bias):
    """flax's ``_normalize``: (x − μ)·(rsqrt(σ² + eps)·scale) + bias."""
    return (x32 - mean) * (rstd * scale) + bias


class _BatchNormTrain(torch.autograd.Function):
    """flax's training BatchNorm over grouped planes (B, C·K, H, W): each
    plane channel normalized by its f32 batch statistics over (B, H, W)
    with the fast variance. Returns (y in x's dtype, batch mean, biased
    batch variance). The backward recomputes x̂ from the saved input (no
    f32 copy of the activation is kept)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x32 = wide(x)
        mean = x32.mean((0, 2, 3))
        var = torch.clamp(x32.square().mean((0, 2, 3)) - mean.square(),
                          min=0.0)
        rstd = torch.rsqrt(var + eps)
        mul = rstd * scale
        y = ((x32 - mean[:, None, None]) * mul[:, None, None]
             + bias[:, None, None]).to(x.dtype)
        ctx.save_for_backward(x, mean, rstd, scale)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, rstd, scale = ctx.saved_tensors
        dy = wide(dy)
        xhat = (wide(x) - mean[:, None, None]) * rstd[:, None, None]
        dbias = dy.sum((0, 2, 3))
        dscale = (dy * xhat).sum((0, 2, 3))
        n = x.numel() // x.shape[1]
        g = (scale * rstd)[:, None, None]
        dx = g * (dy - (dbias / n)[:, None, None]
                  - xhat * (dscale / n)[:, None, None])
        return dx.to(x.dtype), dscale, dbias, None


def batch_norm(h: torch.Tensor, params: Leaves, stats: Leaves, train: bool):
    """flax 0.12.3's ``nn.BatchNorm`` at its defaults over grouped planes,
    per client: ``params`` {"scale", "bias"} and ``stats`` {"mean", "var"}
    are (C, ch) stacks. Training normalizes by the f32 batch statistics of
    each (client, channel) over (B, H, W) (fast variance max(0, E[x²] −
    E[x]²), eps 1e-5) and also returns the running statistics updated as
    0.99·running + 0.01·batch with the *biased* variance (``F.batch_norm``
    uses the unbiased one and the opposite momentum). Evaluation normalizes
    by the running statistics and returns None for them. Returns (y in h's
    dtype, new statistics)."""
    C = params["scale"].shape[0]
    scale = params["scale"].reshape(-1)
    bias = params["bias"].reshape(-1)
    if train:
        y, mean, var = _BatchNormTrain.apply(h, scale, bias, BN_EPS)
        with torch.no_grad():
            new = {"mean": BN_MOMENTUM * stats["mean"]
                   + (1.0 - BN_MOMENTUM) * mean.reshape(C, -1),
                   "var": BN_MOMENTUM * stats["var"]
                   + (1.0 - BN_MOMENTUM) * var.reshape(C, -1)}
        return y, new
    mean = stats["mean"].reshape(-1)[:, None, None]
    rstd = torch.rsqrt(stats["var"].reshape(-1) + BN_EPS)[:, None, None]
    return norm_apply(wide(h), mean, rstd, scale[:, None, None],
                      bias[:, None, None]).to(h.dtype), None


def norm_init(features: int, device) -> Leaves:
    """A BatchNorm's or LayerNorm's unstacked params: unit scale, zero
    bias."""
    return {"scale": torch.ones(features, device=device),
            "bias": torch.zeros(features, device=device)}


def batch_stats_init(features: int, device) -> Leaves:
    """A BatchNorm's unstacked running statistics: mean 0, var 1."""
    return {"mean": torch.zeros(features, device=device),
            "var": torch.ones(features, device=device)}


def layer_norm(x: torch.Tensor, params: Leaves) -> torch.Tensor:
    """flax's ``nn.LayerNorm`` over the last axis of x (C, ..., d), per
    client: f32 statistics with the fast variance, eps 1e-6 (not PyTorch's
    1e-5), the (C, d) scale and bias applied in f32, one rounding to x's
    dtype."""
    x32 = wide(x)
    mean = x32.mean(-1, keepdim=True)
    var = torch.clamp(x32.square().mean(-1, keepdim=True) - mean.square(),
                      min=0.0)
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    return norm_apply(x32, mean, torch.rsqrt(var + LN_EPS),
                      params["scale"].reshape(shape),
                      params["bias"].reshape(shape)).to(x.dtype)


def global_avg_pool(h: torch.Tensor, C: int) -> torch.Tensor:
    """Grouped planes (B, C·K, H, W) -> (C, B, K), the mean over (H, W)."""
    B = h.shape[0]
    return h.mean((2, 3)).reshape(B, C, -1).transpose(0, 1)


def dropout(t: torch.Tensor, keep: Optional[torch.Tensor],
            rate: float) -> torch.Tensor:
    """flax's ``nn.Dropout`` with a drawn keep mask (broadcastable to t):
    kept values divided by the keep probability, the others zero."""
    if keep is None:
        return t
    return torch.where(keep, t / (1.0 - rate), torch.zeros_like(t))


class Dense:
    """flax's ``nn.Dense`` over stacked clients: y = x·W + b for x (C, ...,
    in) in the compute dtype, the (C, in, out) kernel and (C, out) bias cast
    to it, one ``torch.bmm`` for every client."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 use_bias: bool = True):
        self.features = features
        self.dtype = dtype
        self.use_bias = use_bias

    def init(self, in_features: int, generator, device) -> Leaves:
        """lecun_normal kernel, zero bias, unstacked."""
        p = {"kernel": lecun_normal((in_features, self.features), generator,
                                    device)}
        if self.use_bias:
            p["bias"] = torch.zeros(self.features, device=device)
        return p

    def __call__(self, params: Leaves, x: torch.Tensor) -> torch.Tensor:
        C, dt = x.shape[0], self.dtype
        h = x.to(dt).reshape(C, -1, x.shape[-1])
        y = torch.bmm(h, params["kernel"].to(dt))
        if self.use_bias:
            y = y + params["bias"].to(dt)[:, None, :]
        return y.reshape(x.shape[:-1] + (self.features,))


class BatchNormCNN(nn.Module):
    """The frame the port's BatchNorm CNNs share: conv3x3 ``conv1`` (no
    bias) → BatchNorm ``bn1`` → relu → the blocks in order → global average
    pooling → a dense head. A subclass sets ``stem`` (conv1's width),
    ``blocks`` (name → block with ``init``, ``init_batch_stats`` and
    ``__call__(params, stats, h, C, train, new_stats)`` over planes),
    ``head_name``, ``head`` (a :class:`Dense`) and ``width`` (the last
    block's), and ``dtype``. Like the other models it holds no weights."""

    input_shape = (32, 32, 3)

    def init(self, generator: torch.Generator, device) -> Dict[str, dict]:
        """flax's initializers (lecun_normal kernels, unit scales, zero
        biases), unstacked."""
        params = {"conv1": {"kernel": lecun_normal(
                      (3, 3, self.input_shape[-1], self.stem), generator,
                      device)},
                  "bn1": norm_init(self.stem, device)}
        for name, block in self.blocks.items():
            params[name] = block.init(generator, device)
        params[self.head_name] = self.head.init(self.width, generator,
                                                device)
        return params

    def init_batch_stats(self, device) -> Dict[str, dict]:
        """The initial running statistics (mean 0, var 1), unstacked."""
        stats = {"bn1": batch_stats_init(self.stem, device)}
        for name, block in self.blocks.items():
            stats[name] = block.init_batch_stats(device)
        return stats

    def forward(self, params, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                batch_stats=None):
        """params: tree of (C, ...) tensors; x: (C, B, H, W, 3) normalized
        f32 images → (C, B, num_classes) f32 logits. Evaluation normalizes
        with ``batch_stats`` (the (C, ch) running statistics); training
        returns ``(logits, new batch_stats)``. These models have no
        dropout, so ``generator`` is unused."""
        del generator
        if batch_stats is None:
            raise ValueError(f"{self.name} needs the batch_stats collection")
        C = x.shape[0]
        new_stats: Dict[str, dict] = {}
        h = conv(nhwc_to_planes(x.to(self.dtype)), params["conv1"]["kernel"],
                 C)
        h, new = batch_norm(h, params["bn1"], batch_stats["bn1"], train)
        if new is not None:
            new_stats["bn1"] = new
        h = torch.relu(h)
        for name, block in self.blocks.items():
            new_stats[name] = {}
            h = block(params[name], batch_stats[name], h, C, train,
                      new_stats[name])
        out = self.head(params[self.head_name],
                        global_avg_pool(h, C)).float()
        return (out, new_stats) if train else out
