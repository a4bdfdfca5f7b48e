"""Adversarial-robustness evidence on the port: the measured attack and
defense matrix (``scripts/adversarial_eval.py`` of the reference).

Runs both poisoning attacks (untargeted label flip and a targeted pixel
backdoor, each with a 50x count lie) against every aggregation rule
through the production engine, on the reference's tiny MLP.

Run: ``python -m fl_tpu_torch.experiments.adversarial_eval [--rounds 5]
[--clients 8] [--device cpu]``. Writes
``docs/torch/adversarial_evaluation.json``.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from fl_tpu_torch.experiments._common import (add_port_flags, device_of,
                                              platform, write_record)
from fl_tpu_torch.models.layers import WeightsAPI, lecun_normal


class TinyMLP(WeightsAPI, torch.nn.Module):
    """The reference script's flax ``TinyMLP`` (784 → 32 → relu → 10,
    lecun_normal kernels, zero biases) in the port's model interface:
    ``init(generator, device)`` and ``forward(params, x, train=,
    generator=)`` over stacked clients."""

    name = "tiny_mlp"
    input_shape = (28, 28, 1)
    num_classes = 10
    LAYERS = (("fc1", (784, 32)), ("fc2", (32, 10)))

    def init(self, generator, device):
        return {name: {"kernel": lecun_normal(s, generator, device),
                       "bias": torch.zeros(s[-1], device=device)}
                for name, s in self.LAYERS}

    def forward(self, params, x, *, train=False, generator=None):
        C, B = x.shape[:2]
        h = torch.relu(torch.bmm(x.reshape(C, B, -1).float(),
                                 params["fc1"]["kernel"])
                       + params["fc1"]["bias"][:, None])
        return (torch.bmm(h, params["fc2"]["kernel"])
                + params["fc2"]["bias"][:, None])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m fl_tpu_torch.experiments.adversarial_eval")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--attackers", type=int, nargs="+", default=[1, 5])
    ap.add_argument("--inflate", type=float, default=50.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-seed", type=int, default=21,
                    help="synthetic population seed (vary alongside "
                         "--seed when sweeping for variance)")
    add_port_flags(ap, "adversarial_evaluation.json")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = device_of(args)

    from fl_tpu_torch.data.federated import FederatedArrays
    from fl_tpu_torch.data.synthetic import synthetic_mnist
    from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
    from fl_tpu_torch.validation.poisoning import (
        evaluate_backdoor_robustness,
        evaluate_poisoning_robustness,
    )

    C, n = args.clients, args.samples
    xtr, ytr, xte, yte = synthetic_mnist(n_train=C * n, n_test=512,
                                         seed=args.data_seed)
    data = FederatedArrays(
        images=xtr.reshape(C, n, 28, 28, 1),
        labels=ytr.reshape(C, n).astype(np.int32),
        num_samples=np.full(C, n, np.int32),
        mean=np.asarray([0.1307], np.float32),
        std=np.asarray([0.3081], np.float32), num_classes=10)
    training = FederatedTrainingConfig(
        local_epochs=3, batch_size=16, learning_rate=0.05,
        optimizer_type="sgd")

    t0 = time.time()
    flip = evaluate_poisoning_robustness(
        TinyMLP, data, xte, yte, attacker_ids=args.attackers,
        training=training, num_rounds=args.rounds,
        inflate_samples=args.inflate, seed=args.seed, device=device)
    backdoor = evaluate_backdoor_robustness(
        TinyMLP, data, xte, yte, attacker_ids=args.attackers,
        training=training, num_rounds=args.rounds,
        inflate_samples=args.inflate, seed=args.seed, device=device)

    print(f"label flip: clean_fedavg={flip['clean_fedavg']:.3f} "
          f"poisoned={ {k: round(v, 3) for k, v in flip['poisoned'].items()} }")
    for agg, r in backdoor["results"].items():
        print(f"backdoor {agg}: clean={r['clean_accuracy']:.3f} "
              f"ASR={r['backdoor_success_rate']:.3f}")

    out = {
        "description": (
            "Attack/defense matrix through the production engine: "
            "untargeted label flipping and a targeted pixel-trigger "
            "backdoor, both with inflated client-reported sample "
            "counts. Synthetic MNIST; defenses are the engine's "
            "aggregation rules."),
        "config": {"clients": C, "samples_per_client": n,
                   "attackers": list(args.attackers),
                   "inflate_samples": args.inflate,
                   "rounds": args.rounds, "seed": args.seed,
                   "data_seed": args.data_seed},
        "platform": platform(device),
        "label_flip": flip,
        "backdoor": backdoor,
        "wall_s": round(time.time() - t0, 1),
    }
    path = write_record(args.out, out, indent=2, default=float)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
