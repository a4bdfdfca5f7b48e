"""Entry points of the port: one forward on the flagship model, and one
federated superstep over the client mesh (the counterparts of the
reference's ``__graft_entry__.py``).

``entry()`` returns a forward on SimpleCNN (the factory's default: f32,
the unfused conv chain) and its example arguments, zero MNIST-shaped
images (32, 28, 28, 1) NHWC on the device.

``dryrun_multichip(n)`` runs ONE federated training superstep on ``n``
ranks that shard the client axis (2n clients of 16 samples, one epoch at
batch 8, delta DP at ε 1 with ε_r 0.5, FedAvg over the ranks): NCCL, one
card a rank, where the host has ``n`` cards; otherwise ``n`` gloo ranks
that share the first card; gloo ranks on the CPU only when asked with
``device="cpu"``.

Run: ``python -m fl_tpu_torch.entry [n] [--device cpu]`` (n = 8 by
default, as the reference).
"""

from __future__ import annotations

import argparse
import math
from typing import Any, Dict, List, Optional

import torch

from fl_tpu_torch.core.mesh import resolve_device

DRYRUN_SAMPLES = 16
DRYRUN_SYNTH_PER_CLIENT = 24


def entry(device=None):
    """A forward on SimpleCNN and its example arguments ``(variables, x)``,
    on the card unless ``device="cpu"``: ``forward(variables, x)`` maps
    (B, 28, 28, 1) normalized f32 images to (B, 10) f32 logits."""
    from fl_tpu_torch.core.pytree import tree_map
    from fl_tpu_torch.models import create_model, init_variables

    dev = resolve_device("entry", device, None)
    model = create_model("simple_cnn")
    variables = init_variables(model, seed=0, device=dev)
    x = torch.zeros((32,) + tuple(model.input_shape), dtype=torch.float32,
                    device=dev)

    def forward(variables, x):
        stacked = tree_map(lambda t: t[None], variables["params"])
        with torch.no_grad():
            return model(stacked, x[None], train=False)[0]

    return forward, (variables, x)


def dryrun_engine(n_devices: int, mesh=None, device=None):
    """The dry run's engine: 2n IID clients of 16 synthetic MNIST images,
    SimpleCNN, one epoch at batch 8, delta DP (ε 1, ε_r 0.5), on ``mesh``
    or, without one, in this process on ``device``."""
    from fl_tpu_torch.core.types import PrivacyConfig
    from fl_tpu_torch.data import load_dataset, make_federated_arrays
    from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
    from fl_tpu_torch.models import create_model
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    num_clients = 2 * n_devices
    splits = load_dataset(
        "mnist", n_train_synth=num_clients * DRYRUN_SYNTH_PER_CLIENT,
        n_test_synth=64)
    arrays = make_federated_arrays(
        splits, num_clients=num_clients, strategy="iid",
        samples_per_client=DRYRUN_SAMPLES, seed=0)
    cfg = RoundEngineConfig(
        training=FederatedTrainingConfig(local_epochs=1, batch_size=8),
        dp_mode="delta",
        privacy=PrivacyConfig(epsilon=1.0, delta=1e-5, max_grad_norm=1.0),
        epsilon_per_round=0.5,
        seed=0,
    )
    return FederatedRoundEngine(create_model("simple_cnn"), arrays, cfg,
                                mesh=mesh,
                                device=None if mesh is not None else device)


def _dryrun_rank(mesh) -> Dict[str, Any]:
    """One rank's share of the superstep: its result, the kernel launches
    it made and the global weights on the host."""
    from fl_tpu_torch import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    engine = dryrun_engine(mesh.world_size, mesh=mesh)
    ops.reset_launch_counts()
    result = engine.run_round(evaluate=False)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return {
        "rank": mesh.rank,
        "train_loss": float(result.train_loss),
        "participating_clients": int(result.participating_clients),
        "launches": {k: v for k, v in ops.launch_counts().items() if v},
        "weights": {k: v.detach().cpu()
                    for k, v in engine.get_model_weights().items()},
    }


def dryrun_multichip(n_devices: int, device=None) -> List[Dict[str, Any]]:
    """One sharded superstep on ``n_devices`` ranks (see the module
    docstring); asserts a finite loss and 2n participants, prints the
    reference's ``dryrun_multichip OK:`` line and returns each rank's
    result (``_dryrun_rank``) in rank order."""
    from fl_tpu_torch.core.mesh import spawn

    dev = resolve_device("dryrun_multichip", device, None)
    if dev.type == "cuda":
        if torch.cuda.device_count() >= n_devices:
            backend, where = "nccl", "cuda"
        else:
            backend, where = "gloo", "cuda:0"
    else:
        backend, where = "gloo", "cpu"
    ranks = spawn(_dryrun_rank, n_devices, backend=backend, device=where)
    num_clients = 2 * n_devices
    result = ranks[0]
    assert all(math.isfinite(r["train_loss"]) for r in ranks), \
        "non-finite loss from sharded step"
    assert all(r["participating_clients"] == num_clients for r in ranks), (
        f"participating clients {[r['participating_clients'] for r in ranks]}"
        f", expected {num_clients}")
    print(f"dryrun_multichip OK: {n_devices} devices, {num_clients} clients, "
          f"loss={result['train_loss']:.4f}")
    return ranks


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m fl_tpu_torch.entry")
    p.add_argument("n", nargs="?", type=int, default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    # through the module's import name, so that the spawned ranks find the
    # rank job under it and not under __main__
    from fl_tpu_torch import entry as module

    module.dryrun_multichip(args.n, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
