"""Measured comparison of the heterogeneity-correction family on the port
(``scripts/heterogeneity_comparison.py`` of the reference).

Runs FedAvg, FedProx, SCAFFOLD, FedNova, FedDyn and FedAdam on the SAME
non-IID synthetic-MNIST population with heterogeneous per-client epoch
budgets (LOW/MEDIUM/HIGH, cycled), through the production
``FederatedRoundEngine``; only the knob under study changes. SGD local
steps everywhere (SCAFFOLD and FedNova require it), the same seed,
budgets and data.

Run: ``python -m fl_tpu_torch.experiments.heterogeneity_comparison
[--rounds 20] [--clients 16] [--samples 128] [--device cpu]``. Writes
``docs/torch/heterogeneity_comparison.json``.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np

from fl_tpu_torch.experiments._common import (add_port_flags, device_of,
                                              platform, write_record)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m fl_tpu_torch.experiments.heterogeneity_comparison")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--samples", type=int, default=128,
                    help="samples per client")
    ap.add_argument("--local-epochs", type=int, default=8,
                    help="max epoch budget (heterogeneous cycle tops here)")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--partition", default="non_iid",
                    choices=["iid", "non_iid", "pathological"])
    add_port_flags(ap, "heterogeneity_comparison.json")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = device_of(args)

    from fl_tpu_torch.data import create_data_loader, make_federated_arrays
    from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
    from fl_tpu_torch.models import get_model_for_dataset
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    C = args.clients
    loader = create_data_loader(
        "mnist", num_clients=C, partition_strategy=args.partition,
        n_train_synth=C * args.samples, n_test_synth=1024)
    arrays = make_federated_arrays(
        loader.splits, C, args.partition,
        samples_per_client=args.samples, seed=args.seed)
    xte, yte = loader.get_test_set()
    # LOW/MEDIUM/HIGH capability budgets, cycled (capped by --local-epochs)
    budgets = np.asarray(
        [[2, args.local_epochs // 2, args.local_epochs][i % 3]
         for i in range(C)], np.int32)

    def train_cfg(**kw):
        # plain SGD everywhere: SCAFFOLD's Option II identity requires
        # momentum 0, and a fair comparison holds the local optimizer
        # fixed across variants
        return FederatedTrainingConfig(
            local_epochs=args.local_epochs, batch_size=16,
            learning_rate=args.lr, optimizer_type="sgd", momentum=0.0,
            **kw)

    variants = {
        "fedavg": RoundEngineConfig(training=train_cfg(), seed=args.seed),
        "fedprox": RoundEngineConfig(
            training=train_cfg(proximal_mu=0.1), seed=args.seed),
        "scaffold": RoundEngineConfig(
            training=train_cfg(), scaffold=True, seed=args.seed),
        "fednova": RoundEngineConfig(
            training=train_cfg(), fednova=True, seed=args.seed),
        "feddyn": RoundEngineConfig(
            training=train_cfg(), feddyn_alpha=0.1, seed=args.seed),
        "fedadam": RoundEngineConfig(
            training=train_cfg(), server_optimizer="fedadam",
            server_lr=0.01, seed=args.seed),
    }

    results = {}
    for name, cfg in variants.items():
        eng = FederatedRoundEngine(
            get_model_for_dataset("mnist"), arrays, cfg,
            test_images=xte, test_labels=yte, device=device)
        eng.epochs_per_client = budgets
        t0 = time.time()
        hist = eng.run(args.rounds, evaluate_every=1)
        accs = [r.test_accuracy for r in hist]
        results[name] = {
            "test_accuracy": accs,
            "final": accs[-1],
            "best": max(accs),
            "wall_s": round(time.time() - t0, 1),
        }
        print(f"{name:9s} final={accs[-1]:.4f} best={max(accs):.4f} "
              f"({results[name]['wall_s']}s)", flush=True)

    out = {
        "description": (
            "Heterogeneity-correction family on pathological non-IID "
            "synthetic MNIST with heterogeneous per-client epoch budgets "
            "(cycled LOW/MED/HIGH). Same engine, data, budgets, seed; "
            "only the algorithm knob changes."),
        "config": {
            "clients": C, "samples_per_client": args.samples,
            "rounds": args.rounds, "budgets": budgets.tolist(),
            "lr": args.lr, "seed": args.seed,
            "partition": "pathological",
        },
        "platform": platform(device),
        "results": results,
    }
    path = write_record(args.out, out, indent=2)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
