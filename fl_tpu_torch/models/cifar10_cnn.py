"""CIFAR10CNN — the VGG-style CIFAR-10 model, over stacked clients.

Three blocks of [conv3x3 → norm → relu] ×2 → maxpool2 → dropout at 32 / 64
/ 128 channels, then flatten(4·4·128) → dense(512) → relu → dropout →
dense(256) → relu → dropout → dense(num_classes), dropout rate 0.3: the
port of ``fl_tpu.models.cifar10_cnn.CIFAR10CNN``.

As :class:`~fl_tpu_torch.models.simple_cnn.SimpleCNN`, the module holds no
weights: :meth:`CIFAR10CNN.forward` takes a tree of (C, ...) parameters
with the flax names and layouts (``conv1``..``conv6``, ``bn1``..``bn6`` or
``gn1``..``gn6`` with ``scale`` / ``bias``, ``fc1``..``fc3``) and runs
every client at once. The convolutions are library calls (``F.conv2d``
with one group per client, TF32 off), as the reference leaves them to
XLA; each bias is added to its conv's output after that output was rounded
to the compute dtype. Activations travel as grouped planes (B, C·K, H, W)
between the convolutions; fc1 reads the pooled (4, 4, 128) map in HWC
order as flax flattens it.

``norm="batch"`` (the default) is flax 0.12.3's ``nn.BatchNorm`` at its
defaults, per client: in training the statistics of each (client,
channel) over (B, H, W), reduced in f32 with the fast variance max(0,
E[x²] − E[x]²), eps 1e-5, and the running statistics come back updated
as 0.99·running + 0.01·batch with the *biased* variance (``F.batch_norm``'s
own update uses the unbiased variance and the opposite momentum, so it is
not used); in evaluation the running statistics normalize. The running
statistics are the model's ``batch_stats`` collection, ``{"bn<i>":
{"mean", "var"}}`` of (C, channels) f32 tensors.

``norm="group"`` is ``nn.GroupNorm`` with min(8, channels) groups, eps
1e-6, fast variance and f32 reductions, each example on its own; it
carries the ghost-norm DP taps (``DP_LAYERS``): convs and denses capture
their input and are perturbed at their pre-activation, GroupNorms capture
their *input* (the ghost engine recomputes x̂ from it) and are perturbed at
their output.

Precision follows flax at ``dtype``: parameters and statistics stay f32,
the image, weights and biases are cast to the compute dtype, a norm layer
computes in f32 from its compute-dtype input and rounds its output once,
and the logits come back as f32.

Not ported: ``fast_pool_bwd`` selects the reference's scatter-free max-pool
VJP, a TPU formulation of the same values (the factory refuses it by
name); ``F.max_pool2d`` already sends a tied window's gradient to its
first maximum, the contract of ``fl_tpu.ops.pool_vjp``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

import torch.nn.functional as F

from fl_tpu_torch.core.pytree import tree_map
from fl_tpu_torch.models.layers import (
    GroupedConv,
    batch_norm,
    batch_stats_init,
    check_dtype,
    lecun_normal,
    nhwc_to_planes,
    norm_apply,
    norm_init,
    planes_to_nhwc,
    wide,
)

Params = Dict[str, Dict[str, torch.Tensor]]

NORMS = ("batch", "group")
_WIDTHS = (32, 32, 64, 64, 128, 128)
_FC = ((4 * 4 * 128, 512), (512, 256))
GN_EPS = 1e-6


class CIFAR10CNN(nn.Module):
    """Functional CIFAR10CNN; see the module docstring."""

    input_shape = (32, 32, 3)
    name = "cifar10_cnn"

    def __init__(self, num_classes: int = 10, dropout_rate: float = 0.3,
                 dtype: torch.dtype = torch.float32, norm: str = "batch",
                 group_norm_groups: int = 8):
        super().__init__()
        check_dtype(dtype)
        if norm not in NORMS:
            raise ValueError(f"norm={norm!r} not in ('batch', 'group')")
        self.num_classes = num_classes
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.norm = norm
        self.group_norm_groups = group_norm_groups

    # -- structure -------------------------------------------------------
    @property
    def DP_LAYERS(self):
        """The ghost-norm instrumentation map of the GroupNorm variant
        (None for BatchNorm, which couples examples): (name, kind) and, for
        a GroupNorm, (name, "groupnorm", {"groups", "eps"})."""
        if self.norm != "group":
            return None
        layers = []
        for i, w in enumerate(_WIDTHS, 1):
            layers.append((f"conv{i}", "conv3x3"))
            layers.append((f"gn{i}", "groupnorm",
                           {"groups": min(self.group_norm_groups, w),
                            "eps": GN_EPS}))
        return tuple(layers) + (("fc1", "dense"), ("fc2", "dense"),
                                ("fc3", "dense"))

    @property
    def has_batch_stats(self) -> bool:
        return self.norm == "batch"

    def _norm_name(self, i: int) -> str:
        return f"{'bn' if self.norm == 'batch' else 'gn'}{i}"

    def param_shapes(self) -> Dict[str, Dict[str, tuple]]:
        shapes: Dict[str, Dict[str, tuple]] = {}
        cin = self.input_shape[-1]
        for i, w in enumerate(_WIDTHS, 1):
            shapes[f"conv{i}"] = {"kernel": (3, 3, cin, w), "bias": (w,)}
            shapes[self._norm_name(i)] = {"scale": (w,), "bias": (w,)}
            cin = w
        dense = _FC + ((_FC[-1][1], self.num_classes),)
        for i, (a, b) in enumerate(dense, 1):
            shapes[f"fc{i}"] = {"kernel": (a, b), "bias": (b,)}
        return shapes

    def init(self, generator: torch.Generator, device) -> Params:
        """flax's initializers, unstacked: lecun_normal kernels, zero
        biases, unit norm scales."""
        params: Params = {}
        for name, leaves in self.param_shapes().items():
            if "kernel" in leaves:
                params[name] = {
                    "kernel": lecun_normal(leaves["kernel"], generator,
                                           device),
                    "bias": torch.zeros(leaves["bias"], device=device)}
            else:
                params[name] = norm_init(leaves["scale"][0], device)
        return params

    def init_batch_stats(self, device) -> Optional[Params]:
        """The initial running statistics (mean 0, var 1), unstacked; None
        for GroupNorm."""
        if not self.has_batch_stats:
            return None
        return {f"bn{i}": batch_stats_init(w, device)
                for i, w in enumerate(_WIDTHS, 1)}

    def dp_preactivation_shapes(self, num_clients: int, batch: int
                                ) -> Dict[str, tuple]:
        """The (C, B, ...) shape of each ``DP_LAYERS`` perturbation: a
        conv's output and its GroupNorm's are the same."""
        C, B = num_clients, batch
        H, W, _ = self.input_shape
        shapes = {}
        for i, w in enumerate(_WIDTHS, 1):
            s = 2 ** ((i - 1) // 2)
            shapes[f"conv{i}"] = shapes[f"gn{i}"] = (C, B, H // s, W // s, w)
        shapes["fc1"], shapes["fc2"] = (C, B, 512), (C, B, 256)
        shapes["fc3"] = (C, B, self.num_classes)
        return shapes

    def dropout_keep(self, num_clients: int, batch: int,
                     generator: Optional[torch.Generator], device
                     ) -> Optional[Dict[str, torch.Tensor]]:
        """The bool keep masks of a training forward, the draws
        :meth:`forward` makes itself, in this order: after each pool
        ((C, B, H, W, ch), ``pool1``..``pool3``) and after fc1 and fc2
        ((C, B, features)). None without dropout."""
        if self.dropout_rate <= 0.0:
            return None
        C, B = num_clients, batch
        H, W, _ = self.input_shape
        shapes = {"pool1": (C, B, H // 2, W // 2, 32),
                  "pool2": (C, B, H // 4, W // 4, 64),
                  "pool3": (C, B, H // 8, W // 8, 128),
                  "fc1": (C, B, 512), "fc2": (C, B, 256)}
        keep = 1.0 - self.dropout_rate
        return {k: torch.rand(s, generator=generator, device=device) < keep
                for k, s in shapes.items()}

    # -- forward ---------------------------------------------------------
    def forward(self, params: Params, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                batch_stats: Optional[Params] = None,
                dropout_mask: Optional[Dict[str, torch.Tensor]] = None,
                dp_perturb: Optional[Dict[str, torch.Tensor]] = None,
                dp_capture: bool = False):
        """params: tree of (C, ...) tensors; x: (C, B, 32, 32, 3) normalized
        f32 images → (C, B, num_classes) f32 logits.

        ``norm="batch"`` needs ``batch_stats`` (the (C, ch) running
        statistics): evaluation normalizes with them, and training returns
        ``(logits, new batch_stats)``. ``generator`` draws the dropout masks
        when training, unless ``dropout_mask`` (:meth:`dropout_keep`'s dict,
        each mask broadcastable to its layer) is given. ``dp_perturb`` /
        ``dp_capture``: the ghost-DP taps of ``norm="group"``; with
        ``dp_capture`` the result is (logits, captures)."""
        use_bn = self.norm == "batch"
        if use_bn and batch_stats is None:
            raise ValueError("norm='batch' needs the batch_stats collection")
        if use_bn and (dp_capture or dp_perturb is not None):
            raise ValueError("only norm='group' carries the ghost-DP taps "
                             "(BatchNorm couples examples)")
        cdt = self.dtype
        C, B = x.shape[:2]
        captures: Dict[str, torch.Tensor] = {}
        new_stats: Params = {}
        keep = None
        if train and self.dropout_rate > 0.0:
            keep = (dropout_mask if dropout_mask is not None else
                    self.dropout_keep(C, B, generator, x.device))
        keep_prob = 1.0 - self.dropout_rate

        def drop(name, t, planes):
            if keep is None:
                return t
            k = keep[name]
            if planes:
                k = nhwc_to_planes(k.expand(C, B, *k.shape[2:]))
            return torch.where(k, t / keep_prob, torch.zeros_like(t))

        def pert_planes(name, t):
            if dp_perturb is not None:
                t = t + nhwc_to_planes(dp_perturb[name].to(t.dtype))
            return t

        def norm_layer(h, i):
            p = params[self._norm_name(i)]
            if use_bn:
                y, new = batch_norm(h, p, batch_stats[f"bn{i}"], train)
                if new is not None:
                    new_stats[f"bn{i}"] = new
                return y
            # GroupNorm: statistics of each (example, client, group)
            if dp_capture:
                captures[f"gn{i}"] = planes_to_nhwc(h, C)
            Bh, CK, H, W = h.shape
            G = min(self.group_norm_groups, CK // C)
            g32 = wide(h).reshape(Bh, C, G, CK // (C * G), H, W)
            mean = g32.mean((3, 4, 5), keepdim=True)
            var = torch.clamp(g32.square().mean((3, 4, 5), keepdim=True)
                              - mean.square(), min=0.0)
            y = norm_apply(g32, mean, torch.rsqrt(var + GN_EPS),
                           p["scale"].reshape(1, C, G, -1, 1, 1),
                           p["bias"].reshape(1, C, G, -1, 1, 1))
            return pert_planes(f"gn{i}", y.reshape(h.shape).to(cdt))

        def grouped(w):     # (C, 3, 3, I, O) -> (C*O, I, 3, 3)
            return w.to(cdt).permute(0, 4, 3, 1, 2).reshape(
                -1, w.shape[3], 3, 3)

        h = nhwc_to_planes(x.to(cdt))
        for i in range(1, 7):
            p = params[f"conv{i}"]
            if dp_capture:
                captures[f"conv{i}"] = planes_to_nhwc(h, C)
            h = (GroupedConv.apply(h, grouped(p["kernel"]), C)
                 + p["bias"].to(cdt).reshape(1, -1, 1, 1))
            h = torch.relu(norm_layer(pert_planes(f"conv{i}", h), i))
            if i % 2 == 0:
                h = drop(f"pool{i // 2}", F.max_pool2d(h, 2), True)
        h = planes_to_nhwc(h, C).reshape(C, B, -1)
        for i in (1, 2, 3):
            p = params[f"fc{i}"]
            captures[f"fc{i}"] = h
            h = (torch.bmm(h, p["kernel"].to(cdt))
                 + p["bias"].to(cdt)[:, None, :])
            if dp_perturb is not None:
                h = h + dp_perturb[f"fc{i}"].to(h.dtype)
            if i < 3:
                h = drop(f"fc{i}", torch.relu(h), False)
        out = h.float()
        if dp_capture:
            return out, captures
        if use_bn and train:
            return out, new_stats
        return out


def variables_from_flax(variables, device="cpu"):
    """A flax variables dict (``{"params", "batch_stats"}`` of numpy
    arrays, with or without a client axis, nested to any depth) as f32
    torch tensors on ``device``, same names and layouts."""
    return tree_map(lambda v: torch.tensor(np.asarray(v, np.float32),
                                           device=device), variables)


def variables_to_flax(variables):
    """The inverse of :func:`variables_from_flax`: numpy f32 arrays."""
    return tree_map(lambda v: v.detach().cpu().numpy().astype(np.float32),
                    variables)
