"""The gradient-inversion headline on the port: what one released update
leaks, with and without DP (``scripts/inversion_demo.py`` of the
reference).

Runs the DLG/iDLG-style attack (``fl_tpu_torch.validation.inversion``)
against one client's single-step release of SimpleCNN on synthetic
MNIST at batch sizes 1 and 4, non-private against the DP release at
ε = 1.0 (the clip and noise of the release go through K3 on the card).

Run: ``python -m fl_tpu_torch.experiments.inversion_demo [--steps 2000]
[--restarts 4] [--device cpu]``. Writes
``docs/torch/inversion_report.json``.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

from fl_tpu_torch.experiments._common import (add_port_flags, device_of,
                                              platform, write_record)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m fl_tpu_torch.experiments.inversion_demo")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--restarts", type=int, default=4)
    ap.add_argument("--epsilon", type=float, default=1.0)
    add_port_flags(ap, "inversion_report.json")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = device_of(args)

    from fl_tpu_torch.data.synthetic import synthetic_mnist
    from fl_tpu_torch.models import init_variables
    from fl_tpu_torch.models.factory import ModelFactory
    from fl_tpu_torch.validation.inversion import (InversionAttackConfig,
                                                   inversion_report)

    model = ModelFactory.create_model("simple_cnn")
    variables = init_variables(model, seed=0, device=device)
    xtr, ytr, _, _ = synthetic_mnist(n_train=16, n_test=1, seed=3)
    cfg = InversionAttackConfig(steps=args.steps, restarts=args.restarts)

    results = {}
    for batch in (1, 4):
        t0 = time.time()
        rep = inversion_report(
            model, variables, xtr[:batch], ytr[:batch], 0.1307, 0.3081,
            epsilon=args.epsilon, delta=1e-5, max_norm=1.0,
            attack_config=cfg, seed=0)
        rep["wall_s"] = round(time.time() - t0, 1)
        results[f"batch_{batch}"] = rep
        print(f"batch={batch}: non-private "
              f"{rep['non_private']['psnr_db']:.1f} dB "
              f"(labels {rep['non_private']['label_accuracy']:.0%}) vs DP "
              f"{rep['dp']['psnr_db']:.1f} dB "
              f"(labels {rep['dp']['label_accuracy']:.0%}) — "
              f"gap {rep['psnr_gap_db']:.1f} dB [{rep['wall_s']}s]",
              flush=True)

    out = {
        "description": (
            "DLG/iDLG gradient-inversion attack vs this framework's "
            "release path: single-step SGD delta of SimpleCNN on "
            "synthetic MNIST, attacker knows lr/preprocessing. "
            "PSNR of best-of-restarts reconstruction vs the true batch."),
        "attack": {"steps": args.steps, "restarts": args.restarts,
                   "matching": cfg.matching,
                   "learning_rate": cfg.learning_rate},
        "dp_release": {"epsilon": args.epsilon, "delta": 1e-5,
                       "max_norm": 1.0, "mode": "delta (reference semantics)"},
        "platform": platform(device),
        "results": results,
    }
    path = write_record(args.out, out, indent=2, default=float)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
