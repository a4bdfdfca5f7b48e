"""The benchmark of fl_tpu_torch, the PyTorch and CUDA port: one cell of
``BENCHMARK.json`` on one NVIDIA GPU.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

run from the root of a checkout. The cell names a workload file
(``port_bench/workloads/<traffic>.json``: the traffic, by the engine's field
names) and a configuration (``port_bench/configs/<config>.json``). The run:

1. makes the clients' shards and the initial model from ``--seed`` on the
   device (``lib/inputs.py``) and builds the port's round engine over them
   (``lib/system.py``);
2. set-up: drives the engine through its first rounds with the window's
   own call, one round a call, keeping each round's results for the
   check; these rounds also compile and warm every shape the window uses;
3. the window: ``run_rounds_pipelined`` in calls of the workload's
   ``rounds_per_call`` until ``--seconds`` have passed, the last call's
   rounds finished and their metrics on the host; with ``--trace 1`` under
   ``torch.profiler`` (CPU and CUDA) with the harness's spans around the
   engine's dispatch and finalize;
4. frees the engine, runs the plain reference (``reference/<config>.py``)
   through the rounds of step 2 and compares (``lib/check.py``);
5. prints each number compared beside its limit on standard error, and as
   the last line of standard output one JSON object: ``correct``,
   ``attempted`` and ``failed`` (rounds of the window), ``metrics`` (the
   cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones,
   each computed by ``metrics/<name>.py``), ``device``, with ``--trace 1``
   ``breakdown``, and last ``checks``.

It exits non-zero with no result where the port is not in the checkout,
where there is no CUDA device, and where a module of JAX, of the JAX
package or of the repository's other benchmark tools has been loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Callable, Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
# every kernel cache in the checkout, at a fixed path, before anything
# imports triton
os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

from lib import check, inputs, modules, system  # noqa: E402
from lib.trace import Trace, events_of  # noqa: E402


def load(kind: str, name: str):
    """The module ``port_bench/<kind>/<name>.py``."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench_{kind}_{name.replace('-', '_').replace('.', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


class Context:
    """What a metric reader reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def load(self, kind: str, name: str):
        return load(kind, name)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _span(name: str, fn: Callable) -> Callable:
    import torch

    def wrapped(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return wrapped


def run_cell(name: str, cell: Dict[str, Any], workload: Dict[str, Any],
             config: Dict[str, Any], metric_specs: List[Dict[str, Any]],
             seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START, chips: int = 1) -> Dict[str, Any]:
    """One run of the cell; returns the result object."""
    import torch

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # -- set-up ------------------------------------------------------------
    images, labels = inputs.client_shards(workload, seed, dev)
    theta0 = inputs.initial_variables(config, seed, dev)
    engine = system.build_engine(config, workload, images, labels, theta0,
                                 seed, dev)
    followed = system.follow_rounds(engine, workload["check"]["rounds"])
    sync()
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    system.reset_counters()

    # -- the window --------------------------------------------------------
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        prof = profile(activities=acts)
        engine._dispatch_round = _span("bench.dispatch",
                                       engine._dispatch_round)
        engine._finalize_round = _span("bench.finalize",
                                       engine._finalize_round)
    per_call = int(workload["rounds_per_call"])
    attempted = failed = 0
    results: list = []
    with prof if prof is not None else nullcontext():
        with (torch.profiler.record_function("bench.window") if trace
              else nullcontext()):
            t0 = time.perf_counter()
            while True:
                attempted += per_call
                try:
                    with (torch.profiler.record_function("bench.call")
                          if trace else nullcontext()):
                        results = system.run_rounds(engine, per_call)
                except Exception as exc:  # a round that raises is failed
                    print(f"window: a call raised {exc!r}", file=sys.stderr)
                    failed += per_call
                    elapsed = time.perf_counter() - t0
                    break
                failed += sum(not math.isfinite(r.train_loss)
                              for r in results)
                elapsed = time.perf_counter() - t0
                if elapsed >= seconds:
                    break
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    counts = system.launch_counts()
    tr = Trace(events_of(prof), "bench.window") if trace else None

    # -- metrics -----------------------------------------------------------
    ctx = Context(name=name, cell=cell, workload=workload, config=config,
                  setup_s=setup_s, rounds=attempted - failed,
                  elapsed=elapsed, peak_bytes=window_peak, counts=counts,
                  trace=tr, peaks=read_json(HERE / "lib" / "peaks.json"))
    metrics = {}
    for spec in metric_specs:
        value = load("metrics", spec["name"]).read(ctx)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}

    # -- the check ---------------------------------------------------------
    del engine, results, prof
    program = check.host_records(followed)
    del followed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    model = load("reference", cell["config"])
    ref_round = sys.modules["_round"]
    t_ref = time.perf_counter()
    reference = ref_round.run(model, workload, config, theta0, images,
                              labels, seed, len(program))
    reference = check.host_records(reference)
    ref_s = time.perf_counter() - t_ref
    values = check.readings(check.to_host(theta0), program, reference)
    limits = workload["check"]["limits"]
    correct = (failed == 0 and attempted > 0
               and check.verdict(values, limits))
    print(f"check reference_s {ref_s!r} (not in setup_s)", file=sys.stderr)
    for part in ("update", "change"):
        leaf = max(values["leaves"][part], key=values["leaves"][part].get)
        print(f"check worst leaf of the {part}: {leaf}", file=sys.stderr)
    for k in check.NAMES:
        print(f"check {k} {values[k]!r} limit {limits.get(k)!r}",
              file=sys.stderr)

    found = modules.forbidden()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        raise SystemExit(4)

    result: Dict[str, Any] = {
        "correct": bool(correct), "attempted": attempted, "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if cuda
                            else dev.type),
                   "count": chips,
                   "memory_peak_bytes": int(max(setup_peak, window_peak)),
                   "power": power_limit() if cuda else None}}
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": values[k], "limit": limits.get(k)}
                        for k in check.NAMES}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="port_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = read_json(HERE.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    workload = read_json(HERE / "workloads" / f"{cell['traffic']}.json")
    config = read_json(HERE.parent / conf["file"])
    kind = "per_layer" if args.trace else "end_to_end"
    specs = [m for m in bench[kind]
             if args.workload in m.get("workloads", [args.workload])]

    spec = importlib.util.find_spec("fl_tpu_torch")
    if spec is None or Path(spec.origin).resolve().parent.parent != HERE.parent:
        print("the port, fl_tpu_torch, is not in this checkout",
              file=sys.stderr)
        return 5
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = run_cell(args.workload, cell, workload, config, specs,
                      args.seed, args.seconds, bool(args.trace), "cuda:0",
                      chips=cell["chips"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
