"""Readings of the numbers that decide ``correct``, for setting their
limits: the port's own over many seeds, and those of the control and the
planted faults, each against the float32 reference, in one process.

    python3 port_bench/control.py --workload <cell> --seeds 1 2 3
        --variants program float8 half_clients half_batch
        [--clients C --samples N]

``program`` is the port driven as a run's set-up drives it; ``float8``
the control, the reference put in the port's place and computed in
float8 (the nearest precision below the configuration's bfloat16); the
faults are the reference with the round returning its state unchanged
(``unchanged``), the mean taken over half of the clients
(``half_clients``) or each local step on half of its batch
(``half_batch``). One JSON line a (seed, variant) on standard output;
with ``--leaves`` also every leaf's gap.
Not part of a benchmark run. ``--clients`` and ``--samples`` shrink the
cell for a test on the CPU.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import run  # noqa: E402
from lib import check, inputs, system  # noqa: E402


def cell_files(name: str):
    bench = run.read_json(HERE.parent / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    workload = run.read_json(HERE / "workloads" / f"{cell['traffic']}.json")
    return cell, workload, run.read_json(HERE.parent / conf["file"])


def shrink(workload, clients, samples):
    if clients:
        workload["data"]["clients"] = clients
        workload["engine"]["max_clients"] = clients
    if samples:
        workload["data"]["samples_per_client"] = samples
    return workload


def program_records(config, workload, images, labels, theta0, seed, dev):
    engine = system.build_engine(config, workload, images, labels, theta0,
                                 seed, dev)
    return check.host_records(
        system.follow_rounds(engine, workload["check"]["rounds"]))


def readings(name, seeds, variants, device, clients=None, samples=None,
             leaves=False):
    """Yields one dict a (seed, variant)."""
    import torch

    cell, workload, config = cell_files(name)
    workload = shrink(workload, clients, samples)
    model = run.load("reference", cell["config"])
    ref_round = sys.modules["_round"]
    dev = torch.device(device)
    rounds = workload["check"]["rounds"]
    for seed in seeds:
        images, labels = inputs.client_shards(workload, seed, dev)
        theta0 = inputs.initial_variables(config, seed, dev)
        ref = check.host_records(ref_round.run(model, workload, config, theta0, images,
                                 labels, seed, rounds))
        for variant in variants:
            if variant == "program":
                got = program_records(config, workload, images, labels,
                                      theta0, seed, dev)
            else:
                precision = "float8" if variant == "float8" else "float32"
                faults = () if variant == "float8" else (variant,)
                got = check.host_records(ref_round.run(model, workload, config, theta0,
                                         images, labels, seed, rounds,
                                         precision=precision,
                                         faults=faults))
            values = check.readings(check.to_host(theta0), got, ref)
            if not leaves:
                values.pop("leaves")
            yield dict(cell=name, seed=seed, variant=variant, **values)
            del got
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="port_bench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=["program", "float8"])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--clients", type=int)
    ap.add_argument("--samples", type=int)
    ap.add_argument("--leaves", action="store_true",
                    help="also each leaf's gap of the update and change")
    args = ap.parse_args(argv)
    for line in readings(args.workload, args.seeds, args.variants,
                         args.device, args.clients, args.samples,
                         args.leaves):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
