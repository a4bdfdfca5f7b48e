"""FederatedViT — the compact Vision Transformer, over stacked clients.

Patch embedding (a conv with kernel = stride = ``patch_size``, "VALID",
with bias) → + the learned ``pos_embed`` → dropout → ``depth`` pre-LN
encoder blocks → LayerNorm ``ln_out`` → the mean over tokens → the dense
``head``: the port of ``fl_tpu.models.vit.FederatedViT``. A block is
LayerNorm → explicit q / k / v projections → softmax(q·kᵀ/√hd) in f32 →
dropout on the probabilities → ·v → ``out`` → residual, then LayerNorm →
``mlp_in`` → GELU (tanh form, flax's default) → dropout → ``mlp_out`` →
residual. With ``lora_rank`` > 0 every projection of a block is a
:class:`~fl_tpu_torch.fl.peft.LoRADense` (federated fine-tuning with
``fl.peft.lora_trainable_patterns()``).

The parameters are a tree of (C, ...) tensors with the flax names and
layouts (``patch_embed`` {kernel (p, p, 3, d), bias}, the top-level leaf
``pos_embed`` (1, n, d), ``block{i}`` with ``ln1``, ``q``, ``k``, ``v``,
``out``, ``ln2``, ``mlp_in``, ``mlp_out``, then ``ln_out``, ``head``);
tokens are (C, B, n, d) in row-major patch order. The patch embedding is a
reshape and one batched product whose patch rows are in the HWIO kernel's
(row, column, channel) order. Precision follows flax at ``dtype``: q·kᵀ
from compute-dtype q and k into f32, scaled and softmaxed in f32, dropped
out, cast to the compute dtype and multiplied by v; the LayerNorms are
flax's (eps 1e-6, f32 statistics with the fast variance). The products are
written out (not ``scaled_dot_product_attention``) so that a drawn
dropout mask can be applied to the probabilities.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fl_tpu_torch.models.layers import (
    Dense,
    WeightsAPI,
    check_dtype,
    dropout,
    lecun_normal,
    layer_norm,
    norm_init,
    wide,
)

Params = Dict[str, object]
Masks = Dict[str, torch.Tensor]


def _dense(features: int, lora_rank: int, dtype):
    """A projection: plain Dense, or a LoRA-adapted one when fine-tuning
    (the same function at init, since B = 0)."""
    if lora_rank > 0:
        # fl.peft imports the models package: imported here, not at the top
        from fl_tpu_torch.fl.peft import LoRADense

        return LoRADense(features, rank=lora_rank, dtype=dtype)
    return Dense(features, dtype)


class EncoderBlock:
    """The pre-LN transformer block over (C, B, n, d) tokens."""

    PROJECTIONS = ("q", "k", "v", "out", "mlp_in", "mlp_out")

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int,
                 dropout_rate: float, dtype, lora_rank: int = 0):
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.mlp_ratio = mlp_ratio
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        d, hidden = embed_dim, embed_dim * mlp_ratio
        self.proj = {name: _dense(f, lora_rank, dtype) for name, f in
                     zip(self.PROJECTIONS, (d, d, d, d, hidden, d))}

    def init(self, generator, device) -> Params:
        d, hidden = self.embed_dim, self.embed_dim * self.mlp_ratio
        fan_in = dict(q=d, k=d, v=d, out=d, mlp_in=d, mlp_out=hidden)
        p: Params = {"ln1": norm_init(d, device), "ln2": norm_init(d, device)}
        for name, layer in self.proj.items():
            p[name] = layer.init(fan_in[name], generator, device)
        return p

    def __call__(self, params: Params, x: torch.Tensor,
                 keep: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]
                 ) -> torch.Tensor:
        """x: (C, B, n, d) tokens; ``keep`` the (attention, MLP) dropout
        masks or Nones."""
        C, B, n, d = x.shape
        heads = self.num_heads
        hd = d // heads
        h = layer_norm(x, params["ln1"])

        def split(name):     # (C, B, n, d) -> (C, B, heads, n, hd)
            t = self.proj[name](params[name], h)
            return t.reshape(C, B, n, heads, hd).transpose(2, 3)

        q, k, v = split("q"), split("k"), split("v")
        scores = torch.matmul(wide(q), wide(k).transpose(-1, -2))
        attn = torch.softmax(scores / math.sqrt(hd), dim=-1)
        attn = dropout(attn, keep[0], self.dropout_rate)
        h = torch.matmul(attn.to(self.dtype), v)
        h = h.transpose(2, 3).reshape(C, B, n, d)
        x = x + self.proj["out"](params["out"], h)
        h = layer_norm(x, params["ln2"])
        h = F.gelu(self.proj["mlp_in"](params["mlp_in"], h),
                   approximate="tanh")
        h = dropout(h, keep[1], self.dropout_rate)
        return x + self.proj["mlp_out"](params["mlp_out"], h)


class FederatedViT(WeightsAPI, nn.Module):
    """Functional FederatedViT; see the module docstring. Defaults give
    545,930 parameters at 32×32 (574,602 with ``lora_rank=4``)."""

    input_shape = (32, 32, 3)
    name = "federated_vit"

    def __init__(self, num_classes: int = 10, patch_size: int = 4,
                 embed_dim: int = 128, depth: int = 4, num_heads: int = 4,
                 mlp_ratio: int = 2, dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32, lora_rank: int = 0):
        super().__init__()
        check_dtype(dtype)
        self.num_classes = num_classes
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.mlp_ratio = mlp_ratio
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.lora_rank = lora_rank
        self.blocks = [EncoderBlock(embed_dim, num_heads, mlp_ratio,
                                    dropout_rate, dtype, lora_rank)
                       for _ in range(depth)]
        self.head = Dense(num_classes, dtype)

    def num_patches(self, h: int, w: int) -> int:
        """The token count of an h×w image; raises the reference's error
        when the patch does not divide it."""
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} not divisible by patch_size={p}")
        return (h // p) * (w // p)

    def init(self, generator: torch.Generator, device) -> Params:
        """flax's initializers (lecun_normal kernels, zero biases, unit
        LayerNorm scales, ``pos_embed`` ~ N(0, 0.02²), the adapters'
        own), unstacked."""
        H, W, ch = self.input_shape
        n, p, d = self.num_patches(H, W), self.patch_size, self.embed_dim
        params: Params = {
            "patch_embed": {"kernel": lecun_normal((p, p, ch, d), generator,
                                                   device),
                            "bias": torch.zeros(d, device=device)},
            "pos_embed": 0.02 * torch.randn((1, n, d), generator=generator,
                                            device=device)}
        for i, block in enumerate(self.blocks):
            params[f"block{i}"] = block.init(generator, device)
        params["ln_out"] = norm_init(d, device)
        params["head"] = self.head.init(d, generator, device)
        return params

    def dropout_keep(self, num_clients: int, batch: int,
                     generator: Optional[torch.Generator], device
                     ) -> Optional[Masks]:
        """The bool keep masks of a training forward, the draws
        :meth:`forward` makes itself, in this order: after ``pos_embed``
        ("embed", (C, B, n, d)), then in each block on the attention
        probabilities ("block{i}/attn", (C, B, heads, n, n)) and after the
        GELU ("block{i}/mlp", (C, B, n, d·mlp_ratio)). None without
        dropout."""
        if self.dropout_rate <= 0.0:
            return None
        C, B = num_clients, batch
        H, W, _ = self.input_shape
        n, d = self.num_patches(H, W), self.embed_dim
        shapes = {"embed": (C, B, n, d)}
        for i in range(self.depth):
            shapes[f"block{i}/attn"] = (C, B, self.num_heads, n, n)
            shapes[f"block{i}/mlp"] = (C, B, n, d * self.mlp_ratio)
        keep = 1.0 - self.dropout_rate
        return {k: torch.rand(s, generator=generator, device=device) < keep
                for k, s in shapes.items()}

    def forward(self, params: Params, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_mask: Optional[Masks] = None) -> torch.Tensor:
        """params: tree of (C, ...) tensors; x: (C, B, H, W, 3) normalized
        f32 images → (C, B, num_classes) f32 logits. ``generator`` draws
        the dropout masks when training, unless ``dropout_mask``
        (:meth:`dropout_keep`'s dict, each mask broadcastable to its site)
        is given."""
        C, B, H, W, ch = x.shape
        n, p, d = self.num_patches(H, W), self.patch_size, self.embed_dim
        cdt = self.dtype
        keep: Masks = {}
        if train and self.dropout_rate > 0.0:
            keep = (dropout_mask if dropout_mask is not None else
                    self.dropout_keep(C, B, generator, x.device))
        patches = x.to(cdt).reshape(C, B, H // p, p, W // p, p, ch).permute(
            0, 1, 2, 4, 3, 5, 6).reshape(C, B * n, p * p * ch)
        emb = params["patch_embed"]
        h = (torch.bmm(patches, emb["kernel"].to(cdt).reshape(C, -1, d))
             + emb["bias"].to(cdt)[:, None, :])
        h = h.reshape(C, B, n, d) + params["pos_embed"].to(cdt)
        h = dropout(h, keep.get("embed"), self.dropout_rate)
        for i, block in enumerate(self.blocks):
            h = block(params[f"block{i}"], h,
                      (keep.get(f"block{i}/attn"), keep.get(f"block{i}/mlp")))
        h = layer_norm(h, params["ln_out"]).mean(2)
        return self.head(params["head"], h).float()

    @staticmethod
    def flops_per_sample(input_hw: int = 32, patch: int = 4,
                         dim: int = 128, depth: int = 4,
                         mlp_ratio: int = 2, channels: int = 3) -> int:
        """Forward MACs (host-side estimate for capability adaptation)."""
        n = (input_hw // patch) ** 2
        embed = n * patch * patch * channels * dim
        per_block = (4 * n * dim * dim            # QKV + out proj
                     + 2 * n * n * dim            # attention matmuls
                     + 2 * n * dim * dim * mlp_ratio)
        return int(embed + depth * per_block)
