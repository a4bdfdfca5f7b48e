"""The DP-FTRL MNIST headline on the port: accuracy at ε with NO
sampling assumption (``scripts/dp_ftrl_mnist.py`` of the reference).

``dp_mode="dp_ftrl"`` (Kairouz et al. 2021): deterministic rotation
cohorts and whole-transcript Gaussian certification, so no privacy
amplification by Poisson sampling is assumed. The data is the synthetic
MNIST fallback.

Run: ``python -m fl_tpu_torch.experiments.dp_ftrl_mnist [--eps 2.0]
[--clients 1024] [--device cpu] ...``. Writes
``docs/torch/dp_ftrl_mnist.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from fl_tpu_torch.experiments._common import (add_port_flags, device_of,
                                              platform, write_record)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fl_tpu_torch.experiments.dp_ftrl_mnist")
    p.add_argument("--eps", type=float, default=2.0)
    p.add_argument("--delta", type=float, default=1e-5)
    p.add_argument("--clients", type=int, default=1024)
    p.add_argument("--cohort", type=int, default=512)
    p.add_argument("--k", type=int, default=4, help="max participations")
    p.add_argument("--clip", type=float, default=0.5)
    p.add_argument("--local-epochs", type=int, default=2)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--server-lr", type=float, default=1.0)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--samples", type=int, default=64)
    p.add_argument("--nonce", type=int, default=None,
                   help="tree nonce for exact reproduction")
    add_port_flags(p, "dp_ftrl_mnist.json")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = device_of(args)

    import torch

    from fl_tpu_torch.core.types import PrivacyConfig
    from fl_tpu_torch.data import load_dataset, make_federated_arrays
    from fl_tpu_torch.fl import dp_ftrl
    from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
    from fl_tpu_torch.models import create_model
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    rounds = dp_ftrl.max_rounds_within_participations(
        args.clients, args.cohort, args.k)
    z = dp_ftrl.calibrate_noise_multiplier(args.eps, args.delta)
    eps_cert = dp_ftrl.gaussian_epsilon(z, args.delta)
    h = dp_ftrl.tree_height(rounds)
    print(f"T={rounds} rounds, h={h}, z={z:.4f}, certified eps={eps_cert:.4f}, "
          f"sigma_node={z * args.clip * (args.k * h) ** 0.5:.3f}",
          file=sys.stderr)

    splits = load_dataset("mnist",
                          n_train_synth=args.clients * args.samples,
                          n_test_synth=4096)
    fa = make_federated_arrays(splits, num_clients=args.clients,
                               strategy="non_iid",
                               samples_per_client=args.samples, seed=0)
    cfg = RoundEngineConfig(
        training=FederatedTrainingConfig(
            local_epochs=args.local_epochs, batch_size=args.batch,
            learning_rate=args.lr, optimizer_type="sgd", momentum=0.0,
            # bf16 compute with bf16-stored params (stochastic rounding)
            param_storage_dtype="bfloat16"),
        dp_mode="dp_ftrl",
        privacy=PrivacyConfig(epsilon=args.eps + 1e-6, delta=args.delta,
                              max_grad_norm=args.clip, noise_multiplier=z),
        ftrl_rounds=rounds, ftrl_max_participations=args.k,
        ftrl_cohort_size=args.cohort, ftrl_momentum=args.momentum,
        ftrl_server_lr=args.server_lr, ftrl_tree_nonce=args.nonce,
        seed=0,
    )
    eng = FederatedRoundEngine(
        create_model("simple_cnn", dtype=torch.bfloat16), fa, cfg,
        test_images=splits.test_images, test_labels=splits.test_labels,
        device=device)

    t0 = time.time()
    best = 0.0
    for r in range(rounds):
        res = eng.run_round()
        best = max(best, res.test_accuracy or 0.0)
        print(f"round {r}: acc={res.test_accuracy:.4f} "
              f"({time.time() - t0:.0f}s)", file=sys.stderr)
    final = eng.history[-1].test_accuracy

    out = {
        "mode": "dp_ftrl", "epsilon_certified": eps_cert,
        "delta": args.delta, "z": z, "rounds": rounds,
        "tree_height": h, "clients": args.clients, "cohort": args.cohort,
        "max_participations": args.k, "clip": args.clip,
        "local_epochs": args.local_epochs, "batch": args.batch,
        "lr": args.lr, "server_lr": args.server_lr,
        "momentum": args.momentum,
        "final_accuracy": final, "best_accuracy": best,
        "tree_nonce": eng._ftrl_nonce,
        "data": "synthetic-mnist-fallback",
        "wall_s": round(time.time() - t0, 1),
        "platform": platform(device),
    }
    write_record(args.out, out, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
