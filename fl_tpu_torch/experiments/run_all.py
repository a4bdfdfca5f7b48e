"""Run the experiment drivers at their full, published sizes, one process
each, and keep each run's log, exit code and wall time.

Each driver writes its record into ``--out-dir`` under the reference's
file name; its whole output goes to ``--out-dir/<driver>.log``; a driver
still running after ``--timeout`` seconds is stopped, its log kept, and
the summary says so. The summary, one JSON line a driver and
``--out-dir/summary.json``, names the device the runs were measured on.

Run: ``python -m fl_tpu_torch.experiments.run_all --out-dir DIR
[--device cpu] [--timeout 1800] [driver ...]`` (all drivers by default,
in the order below).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

from fl_tpu_torch.experiments._common import platform

DRIVERS = ("quick_start", "complete_system", "audit_privacy",
           "adversarial_eval", "inversion_demo", "heterogeneity_comparison",
           "dp_ftrl_mnist", "distributed_dp_parity", "peft_finetune",
           "dp_sgd_cifar_eps15", "dp_sgd_mnist_eps1")
# the drivers that write a JSON record, and its file name
RECORDS = {
    "audit_privacy": "privacy_audit.json",
    "adversarial_eval": "adversarial_evaluation.json",
    "inversion_demo": "inversion_report.json",
    "heterogeneity_comparison": "heterogeneity_comparison.json",
    "dp_ftrl_mnist": "dp_ftrl_mnist.json",
    "distributed_dp_parity": "distributed_dp_parity.json",
    "peft_finetune": "peft_finetune.json",
}


def closing_lines(log: str, n: int = 3) -> List[str]:
    return [ln for ln in log.splitlines() if ln.strip()][-n:]


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m fl_tpu_torch.experiments.run_all")
    p.add_argument("drivers", nargs="*", default=list(DRIVERS))
    p.add_argument("--out-dir", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--timeout", type=float, default=1800.0)
    args = p.parse_args(argv)
    unknown = sorted(set(args.drivers) - set(DRIVERS))
    if unknown:
        p.error(f"unknown drivers {unknown}; choose from {list(DRIVERS)}")
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    summary = {"platform": platform(args.device), "runs": []}
    for name in args.drivers:
        cmd = [sys.executable, "-m", f"fl_tpu_torch.experiments.{name}",
               "--device", args.device]
        if name in RECORDS:
            cmd += ["--out", str(out_dir / RECORDS[name])]
        log_path = out_dir / f"{name}.log"
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            try:
                rc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                                    timeout=args.timeout).returncode
                timed_out = False
            except subprocess.TimeoutExpired:
                rc, timed_out = None, True
        run = {"driver": name, "rc": rc, "timed_out": timed_out,
               "wall_s": round(time.perf_counter() - t0, 1),
               "closing_lines": closing_lines(log_path.read_text()),
               "record": RECORDS.get(name)}
        summary["runs"].append(run)
        print(json.dumps(run), flush=True)
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps({"platform": summary["platform"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
