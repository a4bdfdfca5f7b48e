"""The benchmark's files: every configuration, workload and metric file
parses, the harness finds each by its name in BENCHMARK.json, the FLOP
counters give the hand counts, and the harness's Philox is Philox4x32-10.

Run: python3 -m pytest port_bench/tests
"""

import importlib.util
import json
import math
import re
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from lib import check, modules, philox  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(kind, name):
    spec = importlib.util.spec_from_file_location(
        f"t_{kind}_{name.replace('-', '_')}", BENCH / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def config(name):
    conf = {c["name"]: c for c in bench()["configs"]}[name]
    return json.loads((ROOT / conf["file"]).read_text())


def test_benchmark_json_names_and_units():
    b = bench()
    assert b["command"] == ["python3", "port_bench/run.py"]
    assert b["paths"] == ["port_bench"]
    metrics = b["end_to_end"] + b["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in
                                           b["workloads"]]
    assert len(set(names)) == len(names)
    for n in names + [c["name"] for c in b["configs"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert {m["name"] for m in b["end_to_end"]} == {
        "setup_s", "rounds_per_s", "peak_mem_gib"}
    for m in b["per_layer"]:
        assert m["moves"] == "rounds_per_s"
    for w in b["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_files_found_by_name(cell):
    b = bench()
    w = {x["name"]: x for x in b["workloads"]}[cell]
    traffic = json.loads((BENCH / "workloads" /
                          f"{w['traffic']}.json").read_text())
    assert traffic["config"] == w["config"]
    assert set(traffic["check"]["limits"]) <= set(check.NAMES)
    cfg = config(w["config"])
    assert cfg["name"] == w["config"]
    assert (BENCH / "reference" / f"{w['config']}.py").exists()
    load("flops", w["config"]).train_flops_per_example(cfg)
    for m in b["end_to_end"] + b["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert callable(load("metrics", m["name"]).read)


@pytest.mark.parametrize("name,params", [("simplecnn-mnist-bf16", 421642),
                                         ("cifar10cnn-bn-bf16", 1470890)])
def test_configuration_parameter_counts(name, params):
    cfg = config(name)
    got = sum(math.prod(s) for layer in cfg["params"].values()
              for s, _ in layer.values())
    assert got == params == cfg["num_parameters"]


@pytest.mark.parametrize("name,forward,train", [
    ("simplecnn-mnist-bf16", 8.48e6, 25.4e6),
    ("cifar10cnn-bn-bf16", 79.6e6, 238.9e6)])
def test_flop_counters_give_the_hand_counts(name, forward, train):
    f = load("flops", name)
    cfg = config(name)
    assert f.forward_flops_per_example(cfg) == pytest.approx(forward,
                                                             rel=2e-3)
    assert f.train_flops_per_example(cfg) == pytest.approx(train, rel=2e-3)


def test_kernel_bounds_at_the_bench_shapes():
    """K1 0.127 ms by its operations, K2 0.071 ms and K3 0.516 ms by their
    bytes at 512 clients x 32 images (989 TFLOP/s, 3.35 TB/s)."""
    f, b = load("kernels", "k1").work(512, 32, 28, 28, 32, 64)
    assert f / 989e12 * 1e3 == pytest.approx(0.127, abs=5e-4)
    f, b = load("kernels", "k2").work(512, 32, 28, 28, 32, 64)
    assert b / 3.35e12 * 1e3 == pytest.approx(0.071, abs=5e-4)
    wl = json.loads((BENCH / "workloads" / "mnist-dp-full.json").read_text())
    b = load("kernels", "k3").bytes_per_round(config("simplecnn-mnist-bf16"),
                                              wl)
    assert b / 3.35e12 * 1e3 == pytest.approx(0.516, abs=5e-4)


def test_philox_known_answer():
    """Random123's known answer for Philox4x32-10 at counter 0, key 0."""
    z = torch.zeros(1, dtype=torch.int64)
    got = [int(w) for w in philox.philox4x32(z, z, z)]
    assert got == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_module_check_compares_whole_top_level_names():
    assert modules.forbidden(["fl_tpu.ops.dp", "numpy"]) == ["fl_tpu"]
    assert modules.forbidden(["fl_tpu_torch.ops.dp", "torch"]) == []
    assert modules.forbidden(["jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]
