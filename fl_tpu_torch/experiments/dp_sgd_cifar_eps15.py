"""The CIFAR-10 accuracy-at-ε headline on the port: DP-SGD with the
DP-sound ``CIFAR10CNN(norm="group")`` (``scripts/dp_sgd_cifar_eps15.py``
of the reference).

Per-example DP-SGD, ghost-norm clipping (C = 1) and Gaussian noise with
z calibrated by the PLD accountant (or RDP) so that the configured
rounds land on the ε budget, on the GroupNorm CIFAR CNN (BatchNorm
couples examples, which leaves per-example gradients undefined). The
data is the synthetic CIFAR-10 fallback unless real batches are mounted
under $FL_TPU_DATA_DIR. Prints the FINAL line; writes no record.

Run: ``python -m fl_tpu_torch.experiments.dp_sgd_cifar_eps15
[--clients 24] [--rounds 30] [--device cpu]``
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

from fl_tpu_torch.experiments._common import add_port_flags, device_of


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fl_tpu_torch.experiments.dp_sgd_cifar_eps15")
    # the reference's measured headline config: q = 0.0625
    p.add_argument("--clients", type=int, default=24)
    p.add_argument("--samples-per-client", type=int, default=4096)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--rounds", type=int, default=30)
    p.add_argument("--epsilon", type=float, default=1.5)
    p.add_argument("--delta", type=float, default=1e-5)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--dp-impl", default="ghost",
                   choices=["auto", "ghost", "microbatch"])
    p.add_argument("--accountant", default="pld", choices=["pld", "rdp"],
                   help="noise calibration + certification: the PLD "
                        "accountant (fl_tpu_torch.fl.pld) certifies "
                        "~10-15%% tighter than RDP, so 'pld' runs with "
                        "less noise at the same certified ε")
    add_port_flags(p)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = device_of(args)

    import torch

    from fl_tpu_torch.core.types import PrivacyConfig
    from fl_tpu_torch.data import load_dataset, make_federated_arrays
    from fl_tpu_torch.fl.accounting import calibrate_noise_multiplier
    from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
    from fl_tpu_torch.models import create_model
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    q = args.batch / args.samples_per_client
    steps = args.rounds * (args.samples_per_client // args.batch)
    pld_dt = None
    if args.accountant == "pld":
        from fl_tpu_torch.fl.pld import (
            calibrate_noise_multiplier_pld,
            suggest_pld_dt,
        )

        # one step-scaled grid for BOTH calibration and the engine's
        # budget gate, so the gate provably admits the planned steps
        pld_dt = suggest_pld_dt(args.epsilon, steps)
        z = calibrate_noise_multiplier_pld(args.epsilon, args.delta, q,
                                           steps, dt=pld_dt)
    else:
        z = calibrate_noise_multiplier(args.epsilon, args.delta, q, steps)
    print(f"clients={args.clients} q={q:.4f} steps={steps} "
          f"calibrated z={z:.3f} ({args.accountant})", flush=True)

    splits = load_dataset(
        "cifar10",
        n_train_synth=args.clients * args.samples_per_client,
        n_test_synth=4096,
    )
    arrays = make_federated_arrays(
        splits, num_clients=args.clients, strategy="iid",
        samples_per_client=args.samples_per_client, seed=0,
    )
    engine = FederatedRoundEngine(
        create_model("cifar10_cnn", norm="group", dtype=torch.bfloat16),
        arrays,
        RoundEngineConfig(
            training=FederatedTrainingConfig(
                local_epochs=1, batch_size=args.batch,
                learning_rate=args.lr, optimizer_type="sgd",
            ),
            dp_mode="dp_sgd",
            privacy=PrivacyConfig(epsilon=args.epsilon, delta=args.delta,
                                  max_grad_norm=args.max_grad_norm,
                                  noise_multiplier=z),
            max_clients=args.clients, seed=0, dp_microbatch=8,
            dp_sgd_impl=args.dp_impl, accountant=args.accountant,
            pld_dt=pld_dt,
        ),
        test_images=splits.normalized(splits.test_images),
        test_labels=splits.test_labels,
        device=device,
    )
    t0 = time.time()
    for r in range(args.rounds):
        res = engine.run_round()
        eps = engine.rdp_accountant.get_epsilon(args.delta)
        tag = "eps_rdp" if args.accountant == "pld" else "eps"
        print(f"round {r:3d}: acc={res.test_accuracy:.4f} "
              f"loss={res.train_loss:.4f} {tag}={eps:.4f} "
              f"({res.round_time_s:.1f}s)", flush=True)
    final = engine.history[-1].test_accuracy
    if args.accountant == "pld":
        eps = engine.certified_epsilon(args.delta)
        eps_rdp = engine.rdp_accountant.get_epsilon(args.delta)
        print(f"\nFINAL accuracy={final:.4f} at PLD-certified eps="
              f"{eps:.4f} (RDP would report {eps_rdp:.4f}; "
              f"dataset={splits.name}) wall={time.time() - t0:.0f}s")
    else:
        eps = engine.rdp_accountant.get_epsilon(args.delta)
        print(f"\nFINAL accuracy={final:.4f} at eps={eps:.4f} "
              f"(dataset={splits.name}) wall={time.time() - t0:.0f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
