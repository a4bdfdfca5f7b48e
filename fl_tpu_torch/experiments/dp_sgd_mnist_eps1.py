"""The headline DP result on the port: MNIST at ε = 1.0 (δ = 1e-5)
under per-example DP-SGD (``scripts/dp_sgd_mnist_eps1.py`` of the
reference).

128 federated clients train SimpleCNN (bf16) with per-example clipping
(C = 1) and Gaussian noise whose z the PLD accountant (or RDP with
``--accountant rdp``) calibrates so that the configured rounds land on
the ε budget; the engine's "auto" form takes ghost norms on the unfused
model. The data is the synthetic MNIST fallback unless real IDX files
are mounted under $FL_TPU_DATA_DIR. Prints the FINAL line and PASS or
FAIL, and exits 0 on PASS; writes no record.

Run: ``python -m fl_tpu_torch.experiments.dp_sgd_mnist_eps1
[--clients 128] [--rounds 30] [--device cpu]``
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

from fl_tpu_torch.experiments._common import add_port_flags, device_of


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fl_tpu_torch.experiments.dp_sgd_mnist_eps1")
    p.add_argument("--clients", type=int, default=128)
    p.add_argument("--samples-per-client", type=int, default=8192)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--rounds", type=int, default=30)
    p.add_argument("--epsilon", type=float, default=1.0)
    p.add_argument("--delta", type=float, default=1e-5)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--target", type=float, default=0.91)
    p.add_argument("--dp-impl", default="auto",
                   choices=["auto", "ghost", "microbatch"],
                   help="DP-SGD implementation (ghost-norm two-pass vs "
                        "per-example microbatch; see fl_tpu_torch.fl."
                        "privacy)")
    p.add_argument("--holdout", type=int, default=0,
                   help="hold out the LAST N train examples as a "
                        "selection-free eval set (deterministic slice, no "
                        "shuffling)")
    p.add_argument("--accountant", default="pld", choices=["pld", "rdp"],
                   help="noise calibration + final certification: the PLD "
                        "accountant (fl_tpu_torch.fl.pld) certifies the "
                        "same mechanism ~10-15%% tighter than RDP, so "
                        "'pld' runs with less noise at the same "
                        "certified ε")
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
    from fl_tpu_torch.fl.pld import calibrate_noise_multiplier_pld
    from fl_tpu_torch.models import create_model
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    q = args.batch / args.samples_per_client
    steps = args.rounds * (args.samples_per_client // args.batch)
    pld_dt = None
    if args.accountant == "pld":
        from fl_tpu_torch.fl.pld import suggest_pld_dt

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
        "mnist",
        n_train_synth=args.clients * args.samples_per_client
        + max(args.holdout, 0),
        n_test_synth=4096,
    )
    holdout = None
    if args.holdout > 0:
        import dataclasses as _dc

        holdout = (splits.train_images[-args.holdout:],
                   splits.train_labels[-args.holdout:])
        splits = _dc.replace(
            splits,
            train_images=splits.train_images[:-args.holdout],
            train_labels=splits.train_labels[:-args.holdout])
        print(f"holdout: {args.holdout} train examples withheld "
              f"({splits.train_images.shape[0]} remain for training)")
    arrays = make_federated_arrays(
        splits, num_clients=args.clients, strategy="iid",
        samples_per_client=args.samples_per_client, seed=0,
    )
    engine = FederatedRoundEngine(
        create_model("simple_cnn", dtype=torch.bfloat16), arrays,
        RoundEngineConfig(
            training=FederatedTrainingConfig(
                local_epochs=1, batch_size=args.batch,
                learning_rate=args.lr, optimizer_type="sgd",
            ),
            dp_mode="dp_sgd",
            privacy=PrivacyConfig(epsilon=args.epsilon, delta=args.delta,
                                  max_grad_norm=1.0, noise_multiplier=z),
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
    eps_rdp = engine.rdp_accountant.get_epsilon(args.delta)
    if args.accountant == "pld":
        # certify the steps actually taken with the tight hockey-stick
        # bound (the per-round prints above are RDP, cheap but looser)
        eps = engine.certified_epsilon(args.delta)
        print(f"\nFINAL accuracy={final:.4f} at PLD-certified eps="
              f"{eps:.4f} (RDP would report {eps_rdp:.4f}; target "
              f"{args.target} @ {args.epsilon}) wall={time.time() - t0:.0f}s")
    else:
        eps = eps_rdp
        print(f"\nFINAL accuracy={final:.4f} at eps={eps:.4f} "
              f"(target {args.target} @ {args.epsilon}) "
              f"wall={time.time() - t0:.0f}s")
    if holdout is not None:
        from fl_tpu_torch.fl.local_training import evaluate_test_set

        hacc = evaluate_test_set(
            engine.model, engine.global_variables["params"],
            torch.as_tensor(splits.normalized(holdout[0])).to(device),
            torch.as_tensor(holdout[1].astype("int64")).to(device),
        )["accuracy"]
        print(f"HOLDOUT accuracy={hacc:.4f} on {args.holdout} "
              "digits never used for config selection or training")
    ok = final >= args.target and eps <= args.epsilon + 1e-6
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
