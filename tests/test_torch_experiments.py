"""The port's experiment drivers (``fl_tpu_torch.experiments``) against
the reference's scripts (``scripts/*.py``), on the CPU.

Each driver's flags and defaults (or module constants) are its script's,
read from the script with ``ast`` and never by running it; the driver
adds ``--device`` (the card by default), ``--out`` where the script
writes a record (``docs/torch/`` under the script's file name) and, where
the script sizes itself by module constants, flags that default to them.
Each driver then runs end to end at a tiny size with ``--device cpu``
(RDP or a few steps, never the bench's PLD grid): its exit code and its
closing lines are the script's, and where the script writes a JSON
record the driver's has the key tree of the reference's
``docs/<name>.json`` (plus "platform", the device it ran on, where the
reference's record has no such key). The quick start's five checks pass
and fail where the reference's do, and the LoRA arm's trainable count is
the reference's ``peft.count_trainable``.
"""

import ast
import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fl_tpu_torch.experiments._common import RECORD_DIR

ROOT = Path(__file__).resolve().parents[1]

# driver -> (reference script, its record in docs/ or None)
DRIVERS = {
    "distributed_dp_parity": ("distributed_dp_parity.py",
                              "distributed_dp_parity.json"),
    "dp_sgd_mnist_eps1": ("dp_sgd_mnist_eps1.py", None),
    "dp_sgd_cifar_eps15": ("dp_sgd_cifar_eps15.py", None),
    "dp_ftrl_mnist": ("dp_ftrl_mnist.py", "dp_ftrl_mnist.json"),
    "heterogeneity_comparison": ("heterogeneity_comparison.py",
                                 "heterogeneity_comparison.json"),
    "audit_privacy": ("audit_privacy.py", "privacy_audit.json"),
    "adversarial_eval": ("adversarial_eval.py",
                         "adversarial_evaluation.json"),
    "inversion_demo": ("inversion_demo.py", "inversion_report.json"),
    "peft_finetune": ("peft_finetune_demo.py", "peft_finetune.json"),
    "quick_start": ("quick_start.py", None),
    "complete_system": ("test_complete_system.py", None),
}
# the flags a driver adds to size a run its script sizes by constants
CUT_FLAGS = {
    "distributed_dp_parity": {"--clients": "NUM_CLIENTS",
                              "--samples": "SAMPLES", "--rounds": "ROUNDS"},
    "peft_finetune": {"--clients": "CLIENTS", "--samples": "SAMPLES",
                      "--rounds": "ROUNDS",
                      "--pretrain-rounds": "PRETRAIN_ROUNDS"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests on one intra-op thread, restored after it:
    several test processes share the CPU under xdist, and idle OpenMP
    threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _driver(name):
    return importlib.import_module(f"fl_tpu_torch.experiments.{name}")


def _script_tree(name):
    return ast.parse((ROOT / "scripts" / DRIVERS[name][0]).read_text())


def _script_flags(name):
    """{option: (default, type name, choices, nargs)} of every
    ``add_argument`` call in the script."""
    flags = {}
    for node in ast.walk(_script_tree(name)):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            flags[node.args[0].value] = (
                ast.literal_eval(kw["default"]) if "default" in kw else None,
                kw["type"].id if "type" in kw else None,
                ast.literal_eval(kw["choices"]) if "choices" in kw else None,
                ast.literal_eval(kw["nargs"]) if "nargs" in kw else None)
    return flags


def _driver_flags(name):
    flags = {}
    for a in _driver(name).build_parser()._actions:
        if not a.option_strings or a.option_strings[0] == "-h":
            continue
        flags[a.option_strings[0]] = (
            a.default, a.type.__name__ if a.type else None,
            list(a.choices) if a.choices else None, a.nargs)
    return flags


def _script_constants(name):
    out = {}
    for node in _script_tree(name).body:
        if isinstance(node, ast.Assign):
            try:
                value = ast.literal_eval(node.value)
            except ValueError:
                continue
            for t in node.targets:
                if isinstance(t, ast.Tuple):
                    out.update((n.id, v) for n, v in zip(t.elts, value))
                else:
                    out[t.id] = value
    # VIT_KW = dict(...): the keywords of the call
    for node in _script_tree(name).body:
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and getattr(node.value.func, "id", None) == "dict"):
            out[node.targets[0].id] = {k.arg: ast.literal_eval(k.value)
                                       for k in node.value.keywords}
    return out


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_flags_and_constants_are_the_scripts(name):
    script, record = DRIVERS[name]
    want, got = _script_flags(name), _driver_flags(name)
    want.pop("--out", None)
    for opt, value in want.items():
        assert got.get(opt) == value, opt
    extra = set(got) - set(want)
    allowed = {"--device"} | set(CUT_FLAGS.get(name, ()))
    if record is not None:
        allowed.add("--out")
        assert got["--out"][0] == str(RECORD_DIR / record)
        assert record in (ROOT / "scripts" / script).read_text()
        assert (ROOT / "docs" / record).is_file()
    assert extra == allowed
    assert got["--device"][0] == "cuda"
    constants = _script_constants(name)
    mod = _driver(name)
    for const in ("NUM_CLIENTS", "SAMPLES", "ROUNDS", "Z", "VIT_KW",
                  "CLIENTS", "PRETRAIN_ROUNDS", "PASS", "FAIL"):
        if const in constants:
            assert getattr(mod, const) == constants[const], const
    for opt, const in CUT_FLAGS.get(name, {}).items():
        assert got[opt][0] == constants[const], opt


def _key_tree(obj):
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return [_key_tree(obj[0])]
    return None


# the tiny runs: (argv, exit code, the lines the run must print)
RUNS = {
    "distributed_dp_parity": (
        ["--clients", "4", "--samples", "32", "--rounds", "1"], 0,
        ['"dp_mode": "distributed (per-client noise shares)"', "wrote "]),
    "dp_sgd_mnist_eps1": (
        ["--clients", "2", "--samples-per-client", "64", "--batch", "32",
         "--rounds", "1", "--accountant", "rdp", "--holdout", "16"], 1,
        ["FINAL accuracy=", "HOLDOUT accuracy=", "FAIL"]),
    "dp_sgd_cifar_eps15": (
        ["--clients", "2", "--samples-per-client", "32", "--batch", "32",
         "--rounds", "1", "--accountant", "rdp"], 0,
        ["FINAL accuracy=", "dataset=cifar10"]),
    "dp_ftrl_mnist": (
        ["--clients", "8", "--cohort", "4", "--k", "1", "--samples", "16",
         "--local-epochs", "1"], 0, ['"mode": "dp_ftrl"']),
    "heterogeneity_comparison": (
        ["--rounds", "1", "--clients", "3", "--samples", "16",
         "--local-epochs", "2"], 0, ["fedadam   final=", "wrote "]),
    "audit_privacy": (
        ["--clients", "4", "--canaries", "4", "--rounds", "2"], 0,
        ['"empirical_epsilon_lower_bound"']),
    "adversarial_eval": (
        ["--clients", "6", "--samples", "16", "--rounds", "1",
         "--attackers", "1"], 0, ["backdoor krum: clean=", "wrote "]),
    "inversion_demo": (["--steps", "3", "--restarts", "1"], 0,
                       ["batch=4: non-private", "wrote "]),
    "peft_finetune": (
        ["--clients", "2", "--samples", "8", "--rounds", "1",
         "--pretrain-rounds", "1"], 0, ["pretrain: task-A accuracy", "lora {"]),
    "complete_system": ([], 1, ["  ✗ model creation", "  ✓ server optimizer "
                                "identity", "12/13 checks passed"]),
}


# the drivers whose tiny runs take longest run in
# tests/test_torch_experiment_runs.py, each file under a minute alone
SLOW_RUNS = ("distributed_dp_parity", "dp_sgd_cifar_eps15", "peft_finetune")


def run_driver(name, tmp_path, capsys):
    """``name``'s tiny run of RUNS: its exit code, printed lines and
    record's key tree."""
    argv, rc, lines = RUNS[name]
    record = DRIVERS[name][1]
    out = tmp_path / "record.json"
    argv = argv + ["--device", "cpu"] + (["--out", str(out)] if record
                                         else [])
    assert _driver(name).main(argv) == rc
    printed = capsys.readouterr()
    text = printed.out + printed.err
    for line in lines:
        assert line in text, line
    if record is None:
        return
    got = json.loads(out.read_text())
    want = json.loads((ROOT / "docs" / record).read_text())
    tree = _key_tree(got)
    if name == "peft_finetune":
        lora = got["arms"]["lora"]
        assert (lora["trainable_params"], lora["total_params"]) \
            == lora_trainable()
    assert got.pop("platform", None) == "cpu"
    if "platform" not in want:
        tree.pop("platform")
    assert tree == _key_tree(want)


@pytest.mark.parametrize("name", sorted(set(RUNS) - set(SLOW_RUNS)))
def test_driver_runs_at_a_tiny_size(name, tmp_path, capsys):
    run_driver(name, tmp_path, capsys)


def test_quick_start_checks_pass_and_fail_as_the_reference(capsys):
    """The port's five checks against the reference's, each run in this
    process: the reference's model registry has five models as the
    port's, so both fail "model creation" (it expects four)."""
    from fl_tpu.models import list_available_models as jax_models
    from fl_tpu_torch.experiments import quick_start as port
    from fl_tpu_torch.models import list_available_models

    ref = importlib.import_module("scripts.quick_start")
    names = ("test_imports", "test_model_creation", "test_privacy_noise",
             "test_compression_roundtrip", "test_three_client_fedavg")
    want = [ref.check(n, getattr(ref, n)) for n in names]
    got = [port.check(n, getattr(port, n), "cpu") for n in names]
    assert got == want == [True, False, True, True, True]
    assert list_available_models() == jax_models()
    assert port.main(["--device", "cpu"]) == 1
    assert "4/5 checks passed" in capsys.readouterr().out


def lora_trainable():
    """(trainable, total) of the LoRA arm's model under the adapter
    patterns, through the port's ``peft`` as the arm's engine masks it."""
    from fl_tpu_torch.experiments.peft_finetune import VIT_KW
    from fl_tpu_torch.fl import peft
    from fl_tpu_torch.models import create_model, init_variables

    params = init_variables(create_model("federated_vit", lora_rank=4,
                                         **VIT_KW))["params"]
    return peft.count_trainable(
        peft.trainable_mask(params, peft.lora_trainable_patterns()))


def test_lora_arm_counts_the_reference_trainable_parameters():
    import jax

    from fl_tpu.fl import peft as jpeft
    from fl_tpu.models import create_model as jax_create_model
    from fl_tpu_torch.experiments import peft_finetune

    model = jax_create_model("federated_vit", lora_rank=4,
                             **peft_finetune.VIT_KW)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))["params"]
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = jpeft.count_trainable(jpeft.trainable_mask(
        params, jpeft.lora_trainable_patterns()))
    assert lora_trainable() == want
    assert want[0] < want[1] / 10
