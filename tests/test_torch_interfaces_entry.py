"""The port's service Protocols (``fl_tpu_torch.core.interfaces``) and
entry points (``fl_tpu_torch.entry``) against the reference's
(``fl_tpu.core.interfaces``, ``__graft_entry__.py``), on the CPU.

Each pair of objects (the aggregator, the compression service, the
privacy engine, SimpleCNN, the round manager, the data loader) conforms
to the seven Protocols exactly where the reference's does. ``entry()``'s
forward equals the reference's on the same weights within 1e-5 (f32), and
``dryrun_multichip(2, device="cpu")`` on two gloo ranks equals the
one-process round within 2.4e-7 (the client mesh's bound; each weight
tensor's largest gap over its largest magnitude).
"""

import importlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import fl_tpu.core.interfaces as jif
import fl_tpu_torch.core.interfaces as tif
from fl_tpu_torch.models import params_from_flax

PROTOCOLS = ("CoordinatorServiceProtocol", "ClientServiceProtocol",
             "AggregationServiceProtocol", "ModelProtocol",
             "DataLoaderProtocol", "PrivacyEngineProtocol",
             "CompressionProtocol")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests on one intra-op thread, restored after it:
    several test processes share the CPU under xdist, and idle OpenMP
    threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _aggregator():
    from fl_tpu.fl.fedavg import FedAvgAggregator as J
    from fl_tpu_torch.fl.fedavg import FedAvgAggregator as T

    return J(), T(device="cpu")


def _compression():
    from fl_tpu.fl.compression import create_compression_service as J
    from fl_tpu_torch.fl.compression import create_compression_service as T

    return J("zlib"), T("zlib")


def _privacy_engine():
    from fl_tpu.fl.privacy import create_privacy_engine as J
    from fl_tpu_torch.fl.privacy import create_privacy_engine as T

    return J(), T(device="cpu")


def _model():
    from fl_tpu.models import create_model as J
    from fl_tpu_torch.models import create_model as T

    return J("simple_cnn"), T("simple_cnn")


def _round_manager():
    from fl_tpu.orchestration.round_manager import RoundManager as J
    from fl_tpu_torch.orchestration.round_manager import RoundManager as T

    return J(), T(device="cpu")


def _data_loader():
    from fl_tpu.data import create_data_loader as J
    from fl_tpu_torch.data import create_data_loader as T

    kw = dict(num_clients=2, n_train_synth=64, n_test_synth=16)
    return J("mnist", **kw), T("mnist", **kw)


PAIRS = {"aggregator": _aggregator, "compression": _compression,
         "privacy_engine": _privacy_engine, "model": _model,
         "round_manager": _round_manager, "data_loader": _data_loader}


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_conformance_matches_the_reference(pair):
    ref, port = PAIRS[pair]()
    want = {p: isinstance(ref, getattr(jif, p)) for p in PROTOCOLS}
    got = {p: isinstance(port, getattr(tif, p)) for p in PROTOCOLS}
    assert got == want
    assert any(want.values()), f"{pair} conforms to no Protocol"


def test_the_protocols_are_the_reference_ones():
    assert sorted(n for n in tif.__all__) == sorted(jif.__all__)
    for p in PROTOCOLS:
        jp, tp = getattr(jif, p), getattr(tif, p)
        members = sorted(k for k in vars(jp) if not k.startswith("_"))
        assert sorted(k for k in vars(tp) if not k.startswith("_")) \
            == members, p


def test_model_weight_methods_delegate_to_the_factory():
    from fl_tpu_torch.models import (create_model, get_model_weights,
                                     init_variables)

    for name in ("simple_cnn", "cifar10_cnn", "federated_resnet",
                 "lightweight_mobilenet", "federated_vit"):
        model = create_model(name)
        assert isinstance(model, tif.ModelProtocol), name
        variables = init_variables(model)
        weights = model.get_model_weights(variables)
        assert weights.keys() == get_model_weights(variables).keys()
        assert model.get_parameter_count(variables) == sum(
            t.numel() for k, t in weights.items() if k.startswith("params"))
        back = model.get_model_weights(
            model.set_model_weights(variables, weights))
        assert all(torch.equal(back[k], weights[k]) for k in weights)
    jmodel = importlib.import_module("fl_tpu.models").create_model(
        "simple_cnn")
    jvars = jmodel.init(jax.random.PRNGKey(0))
    assert create_model("simple_cnn").get_parameter_count(
        init_variables(create_model("simple_cnn"))) \
        == jmodel.get_parameter_count(jvars)


def test_entry_forward_matches_the_reference():
    from fl_tpu_torch.entry import entry

    graft = importlib.import_module("__graft_entry__")
    jforward, (jvars, jx) = graft.entry()
    forward, (variables, x) = entry(device="cpu")
    assert tuple(x.shape) == tuple(jx.shape) == (32, 28, 28, 1)
    assert x.device.type == "cpu" and not bool(x.any())
    variables = {"params": params_from_flax(
        jax.device_get(jvars["params"]))}
    xs = np.random.default_rng(0).normal(size=jx.shape).astype(np.float32)
    for xin in (np.zeros(jx.shape, np.float32), xs):
        want = np.asarray(jforward(jvars, xin))
        got = forward(variables, torch.from_numpy(xin)).numpy()
        assert got.shape == want.shape == (32, 10)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_entry_points_default_to_the_card():
    from fl_tpu_torch.entry import dryrun_multichip, entry

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        entry()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        dryrun_multichip(2)


def test_dryrun_multichip_equals_the_one_process_round(capsys):
    from fl_tpu_torch.entry import dryrun_engine, dryrun_multichip

    ranks = dryrun_multichip(2, device="cpu")
    assert "dryrun_multichip OK: 2 devices, 4 clients, loss=" in \
        capsys.readouterr().out
    engine = dryrun_engine(2, device="cpu")
    one = engine.run_round(evaluate=False)
    want = {k: v.cpu() for k, v in engine.get_model_weights().items()}
    for r in ranks:
        assert r["participating_clients"] == 4
        assert abs(r["train_loss"] - one.train_loss) <= 2.4e-7 * max(
            1.0, abs(one.train_loss))
        assert r["weights"].keys() == want.keys()
        # each tensor's largest gap over its largest magnitude: the delta-DP
        # noise (ε_r 0.5) puts the weights near 10, where the two ranks'
        # sum and the one process's differ in the last bits
        gap = max(float((r["weights"][k] - want[k]).abs().max()
                        / want[k].abs().max()) for k in want)
        assert gap <= 2.4e-7, (r["rank"], gap)
        # the delta-DP release runs on each rank (the plain K3 on the CPU)
        assert r["launches"] == {}


def test_new_modules_import_no_jax():
    code = (
        "import sys, importlib, pkgutil, fl_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "fl_tpu_torch.__path__, 'fl_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'fl_tpu'))\n"
        "assert not bad, bad\n"
        "print(' '.join(names))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    new = {"fl_tpu_torch.entry", "fl_tpu_torch.core.interfaces",
           "fl_tpu_torch.orchestration.selection",
           "fl_tpu_torch.experiments", "fl_tpu_torch.experiments._common"}
    new |= {f"fl_tpu_torch.experiments.{m}" for m in (
        "distributed_dp_parity", "dp_sgd_mnist_eps1", "dp_sgd_cifar_eps15",
        "dp_ftrl_mnist", "heterogeneity_comparison", "audit_privacy",
        "adversarial_eval", "inversion_demo", "peft_finetune",
        "quick_start", "complete_system")}
    assert new <= names, sorted(new - names)
