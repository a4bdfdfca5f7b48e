"""The inputs a run hands to the program and to the reference alike: the
clients' shards and the initial global model, both made from the seed on
the device.

The initial model follows the configuration file's ``params`` (each
leaf's shape and initializer, flax's: ``lecun_normal`` kernels, a normal
truncated at two standard deviations with variance 1/fan_in, ``zeros`` and
``ones``) and ``batch_stats``; every truncated normal of the model is drawn
in one call and cut into the leaves.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from . import data, prng

# tags of the harness's own input streams under the run's seed
DATA_TAG = 101
INIT_TAG = 102
# std of the unit normal truncated to (-2, 2)
TRUNC_STD = 0.87962566103423978


def initial_variables(config: Dict[str, Any], seed: int, device
                      ) -> Dict[str, Any]:
    """{"params": ..., ["batch_stats": ...]} of unstacked f32 leaves."""
    spec = {"params": config["params"]}
    if config.get("batch_stats"):
        spec["batch_stats"] = config["batch_stats"]
    leaves = [(coll, layer, leaf, tuple(shape), init)
              for coll, layers in spec.items()
              for layer, entries in layers.items()
              for leaf, (shape, init) in entries.items()]
    normal = [x for x in leaves if x[4] == "lecun_normal"]
    total = sum(math.prod(x[3]) for x in normal)
    g = prng.torch_generator(prng.fold(prng.root_seed(seed), INIT_TAG),
                             device)
    draws = torch.empty(total, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(draws, 0.0, 1.0, -2.0, 2.0, generator=g)
    out: Dict[str, Any] = {}
    at = 0
    for coll, layer, leaf, shape, init in leaves:
        if init == "lecun_normal":
            n = math.prod(shape)
            std = math.sqrt(1.0 / math.prod(shape[:-1])) / TRUNC_STD
            t = draws[at:at + n].reshape(shape) * std
            at += n
        elif init == "zeros":
            t = torch.zeros(shape, dtype=torch.float32, device=device)
        elif init == "ones":
            t = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            raise ValueError(f"unknown initializer {init!r}")
        out.setdefault(coll, {}).setdefault(layer, {})[leaf] = t
    return out


def client_shards(workload: Dict[str, Any], seed: int, device):
    """(C, N, H, W, ch) uint8 images and (C, N) int64 labels."""
    d = workload["data"]
    return data.shards(d["dataset"], d["clients"], d["samples_per_client"],
                       prng.fold(prng.root_seed(seed), DATA_TAG), device)
