"""Measured parity: distributed DP (Skellam over modular integer
aggregation, untrusted server) against client_dp (central Gaussian,
trusted server) at the SAME noise multiplier, cohort and workload, on
the port (``scripts/distributed_dp_parity.py`` of the reference).

z is chosen so that the per-round noise norm z·c·√d/m̄ stays well under
the clipped signal (z = 0.05, 512 clients, d ≈ 422k → ≈ 0.06): a
mechanism-parity experiment at bench scale, not a privacy headline; the
ε at this z over 20 rounds is reported and is enormous.

Run: ``python -m fl_tpu_torch.experiments.distributed_dp_parity``
(``--device cpu``, and ``--clients/--samples/--rounds`` to cut it).
Writes ``docs/torch/distributed_dp_parity.json``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

from fl_tpu_torch.experiments._common import (add_port_flags, device_of,
                                              platform, write_record)

NUM_CLIENTS = 512
SAMPLES = 64
ROUNDS = 20
Z = 0.05


def build(dp_mode, fuse=True, *, clients=NUM_CLIENTS, samples=SAMPLES,
          device=None):
    import torch

    from fl_tpu_torch.core.types import PrivacyConfig
    from fl_tpu_torch.data import load_dataset, make_federated_arrays
    from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
    from fl_tpu_torch.models import create_model
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    splits = load_dataset("mnist", n_train_synth=clients * samples,
                          n_test_synth=2048)
    arrays = make_federated_arrays(splits, num_clients=clients,
                                   strategy="iid",
                                   samples_per_client=samples, seed=0)
    model = create_model("simple_cnn", dtype=torch.bfloat16)
    cfg = RoundEngineConfig(
        training=FederatedTrainingConfig(
            local_epochs=5, batch_size=32, learning_rate=0.001,
            optimizer_type="adam", optimizer_state_dtype="bfloat16"),
        dp_mode=dp_mode,
        privacy=(PrivacyConfig(epsilon=1e9, delta=1e-5, max_grad_norm=1.0,
                               noise_multiplier=Z)
                 if dp_mode != "none" else None),
        dist_fuse_noise=fuse,
        max_clients=clients, seed=0,
    )
    x, y = splits.test_images, splits.test_labels
    return FederatedRoundEngine(model, arrays, cfg, test_images=x,
                                test_labels=y, device=device)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_arm(dp_mode, fuse=True, label=None, *, clients=NUM_CLIENTS,
            samples=SAMPLES, rounds=ROUNDS, device=None):
    eng = build(dp_mode, fuse, clients=clients, samples=samples,
                device=device)
    t0 = time.perf_counter()
    eng.run_round(evaluate=False)  # the warm-up: first launches and builds
    _sync(eng.device)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(rounds):
        eng.run_round(evaluate=False)
    _sync(eng.device)
    dt = time.perf_counter() - t0
    acc = eng.evaluate()["accuracy"]
    eps = (eng.rdp_accountant.get_epsilon(1e-5)
           if getattr(eng, "rdp_accountant", None) is not None else None)
    out = {
        "dp_mode": label or dp_mode,
        "rounds_per_sec": round(rounds / dt, 3),
        "test_accuracy_after_21_rounds": round(float(acc), 4),
        "epsilon_at_1e-5": (round(eps, 1) if eps is not None else None),
        "compile_warmup_s": round(compile_s, 1),
    }
    print(json.dumps(out), flush=True)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fl_tpu_torch.experiments.distributed_dp_parity")
    p.add_argument("--clients", type=int, default=NUM_CLIENTS)
    p.add_argument("--samples", type=int, default=SAMPLES)
    p.add_argument("--rounds", type=int, default=ROUNDS)
    add_port_flags(p, "distributed_dp_parity.json")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = device_of(args)
    kw = dict(clients=args.clients, samples=args.samples,
              rounds=args.rounds, device=device)
    results = {
        "workload": {
            "clients": args.clients, "samples_per_client": args.samples,
            "local_epochs": 5, "batch": 32, "rounds_timed": args.rounds,
            "noise_multiplier": Z, "clip_norm": 1.0, "dist_bits": 14,
            "model": "simple_cnn bf16 (~422k params)",
            "data": "synthetic MNIST fallback (zero-egress env)",
            "note": ("mechanism-parity experiment at bench scale; z chosen "
                     "for per-round noise norm ~0.06 << clip 1.0 — NOT a "
                     "privacy headline (see epsilon)"),
        },
        "platform": platform(device),
        "arms": [
            run_arm("none", **kw),
            run_arm("client_dp", **kw),
            run_arm("distributed", fuse=True,
                    label="distributed (fused aggregate noise, default)",
                    **kw),
            run_arm("distributed", fuse=False,
                    label="distributed (per-client noise shares)", **kw),
        ],
    }
    path = write_record(args.out, results, indent=2)
    print("wrote", path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
