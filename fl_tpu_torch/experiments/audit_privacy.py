"""One-run privacy audit on the port: a measured ε lower bound beside the
certified ε (``scripts/audit_privacy.py`` of the reference).

Runs the update-canary client-level membership audit
(``fl_tpu_torch.validation.audit``; Steinke, Nasr & Jagielski 2023)
against the production client_dp superstep: the certified ε from the RDP
accountant above, the audited ε from a real attack below.

Run: ``python -m fl_tpu_torch.experiments.audit_privacy --clients 16
--canaries 48 --rounds 8 --noise-multiplier 1.0 [--device cpu]``.
Writes ``docs/torch/privacy_audit.json``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

from fl_tpu_torch.experiments._common import (add_port_flags, device_of,
                                              platform, write_record)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m fl_tpu_torch.experiments.audit_privacy")
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--canaries", type=int, default=48)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--noise-multiplier", type=float, default=1.0)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--guess-fraction", type=float, default=0.25)
    ap.add_argument("--confidence", type=float, default=0.95)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--samples-per-client", type=int, default=16)
    add_port_flags(ap, "privacy_audit.json")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = device_of(args)

    from fl_tpu_torch.core.types import PrivacyConfig
    from fl_tpu_torch.data import load_dataset, make_federated_arrays
    from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
    from fl_tpu_torch.models import create_model
    from fl_tpu_torch.orchestration import RoundEngineConfig
    from fl_tpu_torch.validation.audit import run_client_membership_audit

    mnist = load_dataset("mnist", n_train_synth=4096, n_test_synth=256)
    fa = make_federated_arrays(
        mnist, num_clients=args.clients, strategy="iid",
        samples_per_client=args.samples_per_client, seed=args.seed)
    model = create_model("simple_cnn")
    cfg = RoundEngineConfig(
        training=FederatedTrainingConfig(local_epochs=1, batch_size=16),
        dp_mode="client_dp",
        privacy=PrivacyConfig(
            epsilon=1e9, delta=1e-5, max_grad_norm=args.clip,
            noise_multiplier=args.noise_multiplier),
        participation_rate=args.participation,
        seed=args.seed)

    t0 = time.time()
    out = run_client_membership_audit(
        model, fa, cfg, num_canaries=args.canaries, num_rounds=args.rounds,
        guess_fraction=args.guess_fraction, confidence=args.confidence,
        seed=args.seed, device=device)
    out["wall_time_s"] = round(time.time() - t0, 1)
    out["config"] = {
        "clients": args.clients, "canaries": args.canaries,
        "rounds": args.rounds, "noise_multiplier": args.noise_multiplier,
        "participation": args.participation, "clip": args.clip,
        "model": "simple_cnn", "dataset": "mnist (synthetic fallback ok)",
    }
    out["platform"] = platform(device)
    out.pop("scores", None)
    out.pop("included", None)

    path = write_record(args.out, out, indent=2)
    print(json.dumps({
        "empirical_epsilon_lower_bound":
            out["empirical_epsilon_lower_bound"],
        "certified_epsilon": out["certified_epsilon"],
        "consistent": out["consistent"],
        "correct_guesses": f"{out['num_correct']}/{out['num_guesses']}",
        "wall_time_s": out["wall_time_s"],
        "artifact": str(path),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
