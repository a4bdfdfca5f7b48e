"""SimpleCNN — the MNIST flagship model, over stacked clients.

conv3x3(1→32) → relu → maxpool2 → conv3x3(32→64) → relu → maxpool2 →
flatten(7·7·64) → dense(128) → relu → dropout → dense(num_classes), as
``fl_tpu.models.simple_cnn.SimpleCNN`` with each of its three values of
``fused_conv_block``.

The module holds no weights: the parameters are a plain tree with the flax
names and layouts (``conv1``/``conv2``/``fc1``/``fc2``, each with
``kernel``/``bias``; HWIO conv kernels, (in, out) dense kernels), stacked
over a leading client axis, and :meth:`SimpleCNN.forward` takes them as an
argument. Activations are NHWC, so fc1 reads the pooled (7, 7, 64) map in
HWC order exactly as flax flattens it.

Precision follows flax at ``dtype``: parameters stay f32, the image, the
weights and the biases are cast to the compute dtype; fc1 → relu → dropout
→ fc2 run in it; logits come back as f32. ``dtype=torch.float64`` (the
unfused chain only) computes and returns float64 throughout, for the
float64 gradient checks (``torch.autograd.gradcheck``). The two dense
layers are batched GEMMs over clients (``torch.bmm``), which the
reference also leaves to the compiler.

``fused_conv_block`` chooses how the conv segment is computed; the
parameter tree and the values (up to rounding) are the same for all three:

- ``False`` (the default, as in the reference): the unfused chain through
  autograd, as flax computes it — conv, bias added to the conv's rounded
  output in the compute dtype, relu, 2×2 max pool, twice. The convolutions
  are library calls (``F.conv2d`` with one group per client), as the
  reference leaves them to XLA; no hand-written kernel runs. They never
  take TF32, forward or backward: an f32 model computes in f32 on a CUDA
  device too, whatever ``torch.backends.cudnn.allow_tf32`` says.
- ``True``: ``fl_tpu_torch.ops.conv_block.conv_stack``, the fused segment
  whose backward keeps no residual (the K4 kernels on CUDA).
- ``"residual"``: ``conv_stack_res``, the fused segment whose forward keeps
  the pool2 window index (kernels K1/K2 on CUDA).

The fused ops add the biases in f32 before one rounding, the unfused chain
after it: they agree to the compute dtype's rounding, not bit for bit.

DP instrumentation (ghost-norm clipping, ``fl_tpu_torch.fl.privacy.
make_ghost_dp_sgd_grad_fn``), the reference's contract on the unfused
formulation: ``dp_capture=True`` also returns each parameterized layer's
*input* (``DP_LAYERS`` names them), and ``dp_perturb`` (zero tensors shaped
like each layer's pre-activation, :meth:`SimpleCNN.dp_preactivation_shapes`)
is added at each pre-activation, so one backward with respect to the
perturbations gives every example's layer-output gradient. Neither changes
the parameters or the forward values. A fused segment is one opaque
kernel and refuses both. ``dropout_mask`` takes a keep mask drawn by
:meth:`SimpleCNN.dropout_keep` in place of the forward's own draw (DP-SGD
shares one mask between its passes, or one example's mask across a
client's examples).

Not ported from the reference's model: ``fast_ops``, ``fast_pool_bwd``,
``fast_conv2_bwd`` and ``fast_stem_wgrad`` select among XLA lowerings of
the same values and mean nothing here (the factory refuses them by name).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

import torch.nn.functional as F

from fl_tpu_torch.core.pytree import tree_leaves, tree_map
from fl_tpu_torch.models.layers import (
    GroupedConv,
    WeightsAPI,
    lecun_normal,
    nhwc_to_planes,
    planes_to_nhwc,
)
from fl_tpu_torch.ops.conv_block import conv_stack, conv_stack_res

Params = Dict[str, Dict[str, torch.Tensor]]

_SHAPES = {
    "conv1": (3, 3, 1, 32),
    "conv2": (3, 3, 32, 64),
    "fc1": (7 * 7 * 64, 128),
}


FUSED_CONV_BLOCK = (False, True, "residual")


def conv_segment_unfused(x, w1, b1, w2, b2, dp_perturb=None,
                         captures=None) -> torch.Tensor:
    """The conv segment as the unfused flax chain, over stacked clients
    through autograd: same shapes as ``conv_stack``. Clients become channel
    groups of one grouped convolution; kernels and biases are cast to x's
    dtype, and each bias is added to its conv's output after that output
    was rounded to the compute dtype (a separate op, as flax's ``nn.Conv``
    adds it, not ``F.conv2d``'s ``bias=``). ``F.max_pool2d`` sends the
    gradient to the first maximal window member, like XLA's
    select-and-scatter.

    The ghost-DP taps: ``dp_perturb["conv1"]`` / ``["conv2"]`` ((C, B, H,
    W, O) tensors) are added to each conv's pre-activation, in x's dtype;
    ``captures`` (a dict) receives each conv's (C, B, H, W, I) input."""
    cdt = x.dtype
    C, B, H, W, _ = x.shape

    def grouped(w):     # (C, 3, 3, I, O) -> (C*O, I, 3, 3)
        return w.to(cdt).permute(0, 4, 3, 1, 2).reshape(-1, w.shape[3], 3, 3)

    h = x.reshape(C, B, H, W).permute(1, 0, 2, 3)
    for name, w, b in (("conv1", w1, b1), ("conv2", w2, b2)):
        if captures is not None:
            captures[name] = planes_to_nhwc(h, C)
        h = GroupedConv.apply(h, grouped(w), C) + b.to(cdt).reshape(1, -1, 1, 1)
        if dp_perturb is not None:
            h = h + nhwc_to_planes(dp_perturb[name].to(cdt))
        h = F.max_pool2d(torch.relu(h), 2)
    return planes_to_nhwc(h, C)


_FUSED_TAPS_MESSAGE = (
    "fused_conv_block replaces the conv segment with one "
    "opaque Pallas program and cannot expose the ghost-DP "
    "activation taps (dp_capture/dp_perturb); build the model "
    "with fused_conv_block=False for dp_sgd ghost mode")


class SimpleCNN(WeightsAPI, nn.Module):
    """Functional SimpleCNN; see the module docstring."""

    input_shape = (28, 28, 1)
    name = "simple_cnn"
    # the instrumented layers of ghost-norm DP-SGD: name -> kind
    DP_LAYERS = (("conv1", "conv3x3"), ("conv2", "conv3x3"),
                 ("fc1", "dense"), ("fc2", "dense"))

    def __init__(self, num_classes: int = 10, dropout_rate: float = 0.25,
                 dtype: torch.dtype = torch.float32,
                 fused_conv_block: Union[bool, str] = False):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16, torch.float64):
            raise ValueError("dtype must be float32 or bfloat16 (or "
                             f"float64, unfused), got {dtype}")
        if not (isinstance(fused_conv_block, bool)
                or fused_conv_block == "residual"):
            raise ValueError(
                f"fused_conv_block must be one of {FUSED_CONV_BLOCK}, got "
                f"{fused_conv_block!r}")
        if dtype == torch.float64 and fused_conv_block:
            raise ValueError("float64 runs the unfused chain only "
                             "(fused_conv_block=False)")
        self.fused_conv_block = fused_conv_block
        self.num_classes = num_classes
        self.dropout_rate = dropout_rate
        self.dtype = dtype

    def param_shapes(self) -> Dict[str, tuple]:
        shapes = dict(_SHAPES, fc2=(128, self.num_classes))
        return {name: {"kernel": s, "bias": (s[-1],)}
                for name, s in shapes.items()}

    def init(self, generator: torch.Generator, device) -> Params:
        """lecun_normal kernels and zero biases, unstacked."""
        return {
            name: {"kernel": lecun_normal(s["kernel"], generator, device),
                   "bias": torch.zeros(s["bias"], dtype=torch.float32,
                                       device=device)}
            for name, s in self.param_shapes().items()
        }

    def dp_preactivation_shapes(self, num_clients: int, batch: int
                                ) -> Dict[str, tuple]:
        """The (C, B, ...) shape of each ``DP_LAYERS`` pre-activation."""
        H, W, _ = self.input_shape
        C, B = num_clients, batch
        return {"conv1": (C, B, H, W, _SHAPES["conv1"][-1]),
                "conv2": (C, B, H // 2, W // 2, _SHAPES["conv2"][-1]),
                "fc1": (C, B, _SHAPES["fc1"][-1]),
                "fc2": (C, B, self.num_classes)}

    def dropout_keep(self, num_clients: int, batch: int,
                     generator: Optional[torch.Generator], device
                     ) -> Optional[torch.Tensor]:
        """The (C, B, 128) bool keep mask of a training forward, the draw
        :meth:`forward` makes itself; None without dropout."""
        if self.dropout_rate <= 0.0:
            return None
        return torch.rand((num_clients, batch, _SHAPES["fc1"][-1]),
                          generator=generator, device=device) \
            < 1.0 - self.dropout_rate

    def forward(self, params: Params, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_mask: Optional[torch.Tensor] = None,
                dp_perturb: Optional[Dict[str, torch.Tensor]] = None,
                dp_capture: bool = False):
        """params: tree of (C, ...) tensors; x: (C, B, 28, 28, 1) normalized
        f32 images → (C, B, num_classes) f32 logits. ``generator`` draws the
        whole (C, B, 128) dropout mask when training, unless
        ``dropout_mask`` (a keep mask broadcastable to it) is given.
        ``dp_perturb`` / ``dp_capture``: the ghost-DP taps (module
        docstring); with ``dp_capture`` the result is (logits, captures)."""
        if self.fused_conv_block and (dp_capture or dp_perturb is not None):
            raise ValueError(_FUSED_TAPS_MESSAGE)
        cdt = self.dtype
        C, B = x.shape[:2]
        captures: Dict[str, torch.Tensor] = {}

        def pert(name, t):
            if dp_perturb is not None:
                t = t + dp_perturb[name].to(t.dtype)
            return t

        x = x.to(cdt)
        w1, b1 = params["conv1"]["kernel"], params["conv1"]["bias"]
        w2, b2 = params["conv2"]["kernel"], params["conv2"]["bias"]
        if self.fused_conv_block:
            op = (conv_stack_res if self.fused_conv_block == "residual"
                  else conv_stack)
            h = op(x, w1, b1, w2, b2)
        else:
            h = conv_segment_unfused(
                x, w1, b1, w2, b2, dp_perturb,
                captures if dp_capture else None)
        h = h.reshape(C, B, -1)
        captures["fc1"] = h
        h = pert("fc1", torch.bmm(h, params["fc1"]["kernel"].to(cdt))
                 + params["fc1"]["bias"].to(cdt)[:, None, :])
        h = torch.relu(h)
        if train and self.dropout_rate > 0.0:
            keep_prob = 1.0 - self.dropout_rate
            keep = (dropout_mask if dropout_mask is not None else
                    self.dropout_keep(C, B, generator, h.device))
            h = torch.where(keep, h / keep_prob, torch.zeros_like(h))
        captures["fc2"] = h
        h = pert("fc2", torch.bmm(h, params["fc2"]["kernel"].to(cdt))
                 + params["fc2"]["bias"].to(cdt)[:, None, :])
        out = h if cdt == torch.float64 else h.float()
        return (out, captures) if dp_capture else out


def params_from_flax(tree, device="cpu") -> Params:
    """A flax params tree of numpy arrays (with or without a client axis,
    nested to any depth) as f32 torch tensors on ``device``, same names and
    layouts."""
    return tree_map(lambda v: torch.tensor(np.asarray(v, np.float32),
                                           device=device), tree)


def load_uplink_state(engine, state) -> None:
    """Load an uplink state, a (C, W) numpy array such as the JAX engine's
    ``uplink_error`` (the error feedback, then PowerSGD's Q factors), into
    the port's engine. The two layouts agree column for column; the random
    Q inits of the two packages differ by construction."""
    t = torch.tensor(np.asarray(state, np.float32),
                     device=engine.uplink_error.device)
    if t.shape != engine.uplink_error.shape:
        raise ValueError(f"uplink state of shape {tuple(t.shape)}, the "
                         "engine's is "
                         f"{tuple(engine.uplink_error.shape)}")
    engine.uplink_error = t


def load_feddyn_state(engine, h, g) -> None:
    """Load FedDyn's state, numpy arrays such as the JAX engine's
    ``feddyn_h`` (D_pad,) and ``feddyn_grads`` (C, D_pad), into the port's
    engine: the same flat layout, column for column."""
    ht = torch.tensor(np.asarray(h, np.float32), device=engine.device)
    gt = torch.tensor(np.asarray(g, np.float32), device=engine.device)
    if (engine.feddyn_h is None or ht.shape != engine.feddyn_h.shape
            or gt.shape != engine.feddyn_grads.shape):
        want = (None if engine.feddyn_h is None else
                (tuple(engine.feddyn_h.shape),
                 tuple(engine.feddyn_grads.shape)))
        raise ValueError(f"FedDyn state of shapes {tuple(ht.shape)}, "
                         f"{tuple(gt.shape)}; the engine's is {want}")
    engine.feddyn_h, engine.feddyn_grads = ht, gt


def params_to_flax(params: Params):
    """The inverse of :func:`params_from_flax`: numpy f32 arrays."""
    return tree_map(lambda v: v.detach().cpu().numpy().astype(np.float32),
                    params)


def count_params(params: Params) -> int:
    return sum(v.numel() for v in tree_leaves(params))
