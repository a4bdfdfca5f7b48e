"""The system under test: the port's federated round engine, built from a
configuration and a workload file, fed the run's inputs.

Everything the benchmark takes from the program goes through here: the
engine, its entry point ``run_rounds_pipelined``, its global model after
each round and its per-client losses, and the launch counters that the
port's kernels keep. The port is imported only inside these functions.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_kwargs(config: Dict[str, Any], workload: Dict[str, Any]
                 ) -> Dict[str, Any]:
    kw = dict(config["model_kwargs"], dtype=DTYPES[config["dtype"]])
    kw.update(workload.get("model", {}))
    return kw


def build_engine(config: Dict[str, Any], workload: Dict[str, Any],
                 images: torch.Tensor, labels: torch.Tensor,
                 variables: Dict[str, Any], seed: int, device):
    """The engine over these shards, its global model set to
    ``variables`` (copied)."""
    from fl_tpu_torch.core.types import PrivacyConfig
    from fl_tpu_torch.data.federated import FederatedArrays
    from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
    from fl_tpu_torch.models import create_model
    from fl_tpu_torch.ops.preprocess import make_cifar_augment
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    C, N = labels.shape
    norm = config["normalize"]
    arrays = FederatedArrays(
        images=images.cpu().numpy(),
        labels=labels.cpu().numpy().astype(np.int32),
        num_samples=np.full((C,), N, np.int32),
        mean=np.asarray(norm["mean"], np.float32),
        std=np.asarray(norm["std"], np.float32),
        num_classes=config["num_classes"])
    cfg = RoundEngineConfig(
        training=FederatedTrainingConfig(**workload["training"]),
        privacy=PrivacyConfig(**workload["privacy"]),
        seed=int(seed), **workload["engine"])
    engine = FederatedRoundEngine(
        create_model(config["model"], **model_kwargs(config, workload)),
        arrays, cfg, device=device,
        augment_fn=make_cifar_augment() if workload.get("augment") else None)
    engine.global_variables = {
        coll: {layer: {k: v.clone() for k, v in leaves.items()}
               for layer, leaves in layers.items()}
        for coll, layers in variables.items()}
    return engine


def run_rounds(engine, n: int):
    """The timed entry point: ``n`` rounds, depth-1 pipelined."""
    return engine.run_rounds_pipelined(n, evaluate=False)


def follow_rounds(engine, n: int):
    """``n`` rounds through the timed entry point, one a call, with what
    each returned: the round's loss, every client's loss and the global
    model (on the device)."""
    out = []
    for _ in range(n):
        res = run_rounds(engine, 1)[0]
        out.append({"loss": float(res.train_loss),
                    "client_losses": client_losses(engine),
                    "variables": global_variables(engine)})
    return out


def client_losses(engine) -> np.ndarray:
    """The (C,) losses of the last finalized round, as the engine keeps
    them."""
    return np.asarray(engine.last_client_losses, np.float64).copy()


def global_variables(engine) -> Dict[str, Any]:
    return engine.global_variables


def reset_counters() -> None:
    from fl_tpu_torch import ops

    ops.reset_launch_counts()


def launch_counts() -> Dict[str, int]:
    from fl_tpu_torch import ops

    return dict(ops.launch_counts())
